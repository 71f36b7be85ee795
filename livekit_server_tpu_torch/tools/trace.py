"""Trace fetcher/validator CLI for the flight-recorder plane.

    python -m livekit_server_tpu_torch.tools.trace --url http://127.0.0.1:7880 -o trace.json
    python -m livekit_server_tpu_torch.tools.trace --selftest [--device cpu]
    python -m livekit_server_tpu_torch.tools.trace --validate trace.json

Fetches /debug/trace from a running node (the tick-span ring rendered as
Chrome/Perfetto trace-event JSON plus the sampled wire-latency stage
sidecar), writes it to a file, prints the stage summary and validates it;
with no action it fetches from http://127.0.0.1:7880. The CLI is
telemetry/trace_export.py's `main`. Exit codes: 0 ok, 1 validation
problems or a failed fetch, 2 bad usage.
"""

from __future__ import annotations

from livekit_server_tpu_torch.telemetry import trace_export

DEFAULT_URL = "http://127.0.0.1:7880"


def main(argv: list[str] | None = None) -> int:
    return trace_export.main(argv, default_url=DEFAULT_URL,
                             prog="livekit_server_tpu_torch.tools.trace")


if __name__ == "__main__":
    raise SystemExit(main())
