"""Structured, scoped logging.

Reference parity: the livekit/protocol logger (zap-backed) the whole
reference codebase threads through — leveled, key-value structured, with
scoped child loggers carrying room/participant/track context (e.g.
rtc/room.go attaches "room"/"roomID" once and every log line under it
inherits the fields). Here: logfmt lines over stdlib logging, and
`with_fields()` returns a child logger with bound context.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Any

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_root = logging.getLogger("livekit")
_configured = False


def configure(level: str = "info", stream=None) -> None:
    """Install the logfmt handler (config.go LoggingConfig seat)."""
    global _configured
    _root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    _root.propagate = False
    for h in list(_root.handlers):
        _root.removeHandler(h)
    h = logging.StreamHandler(stream or sys.stderr)
    h.setFormatter(logging.Formatter("%(message)s"))
    _root.addHandler(h)
    _configured = True


def _fmt(v: Any) -> str:
    s = str(v)
    # Strip control characters first: identities/room names are client-
    # chosen, and a raw newline would forge log records (log injection).
    if any(ord(c) < 0x20 for c in s):
        s = "".join(c if ord(c) >= 0x20 else "\\x%02x" % ord(c) for c in s)
    if " " in s or '"' in s or "=" in s:
        s = '"' + s.replace('"', '\\"') + '"'
    return s


class Logger:
    """Bound-context logger (logger.Logger with Fields)."""

    __slots__ = ("fields",)

    def __init__(self, **fields: Any):
        self.fields = fields

    def with_fields(self, **fields: Any) -> "Logger":
        """Child logger inheriting + extending the bound fields (the
        room/participant-scoped loggers the reference creates once and
        passes down)."""
        merged = dict(self.fields)
        merged.update(fields)
        return Logger(**merged)

    def _emit(self, level: int, msg: str, kw: dict[str, Any]) -> None:
        if not _configured:
            configure()
        if not _root.isEnabledFor(level):
            return
        parts = [
            time.strftime("%Y-%m-%dT%H:%M:%S"),
            f"level={logging.getLevelName(level).lower()}",
            f"msg={_fmt(msg)}",
        ]
        for k, v in self.fields.items():
            parts.append(f"{k}={_fmt(v)}")
        for k, v in kw.items():
            parts.append(f"{k}={_fmt(v)}")
        _root.log(level, " ".join(parts))

    def debug(self, msg: str, **kw: Any) -> None:
        self._emit(logging.DEBUG, msg, kw)

    def info(self, msg: str, **kw: Any) -> None:
        self._emit(logging.INFO, msg, kw)

    def warn(self, msg: str, **kw: Any) -> None:
        self._emit(logging.WARNING, msg, kw)

    def error(self, msg: str, **kw: Any) -> None:
        self._emit(logging.ERROR, msg, kw)


log = Logger()
