"""Standard-client wire interop: ICE-lite/STUN, DTLS 1.2, SRTP, SDP.

Reference parity: the reference terminates real WebRTC via Pion —
ICE/DTLS/SRTP (pkg/rtc/transport.go:167-374), media engine codec
negotiation (pkg/rtc/mediaengine.go:30-150), TURN (pkg/service/turn.go).
This package is the thin gateway in front of the media plane: it terminates
the standard wire (STUN connectivity checks, DTLS-SRTP key exchange,
SRTP packet protection, SDP offer/answer) in front of the UNCHANGED
sealed media plane, plugging in at the runtime/udp.py
assign_ssrc/register_subscriber seam.

Interop validation without a browser in the image: DTLS handshakes are
exercised against OpenSSL's independent stack (`openssl s_client
-dtls1_2 -use_srtp`), SRTP against RFC 7714 test vectors, STUN against
RFC 5769 test vectors.

Port of the JAX package's interop package (stun, srtp, sdp, dtls), copied
with its crypto as it is: DTLS through the system libssl/libcrypto by
ctypes, certificates and SRTP through `cryptography`.
"""

from livekit_server_tpu_torch.interop.stun import (  # noqa: F401
    StunMessage,
    build_binding_response,
    parse_stun,
)
