"""Room/session control plane.

Reference parity: pkg/rtc (SURVEY.md §2.4) — Room, ParticipantImpl, signal
dispatch, subscription management, dynacast. Control stays host-side and
thin; every media-affecting decision lands as a mask/state write into the
PlaneRuntime host mirrors (runtime/plane_runtime.py), applied at the next
tick boundary — the batched plane's replacement for the reference's
lock-guarded object graph mutation.
"""

from livekit_server_tpu_torch.rtc.participant import Participant, PublishedTrack
from livekit_server_tpu_torch.rtc.room import Room
from livekit_server_tpu_torch.rtc.signalhandler import handle_participant_signal

__all__ = ["Participant", "PublishedTrack", "Room", "handle_participant_signal"]
