"""Structured logging for the repro_torch package.

One logger per subsystem; format carries the subsystem so multi-host logs
interleave legibly.  ``REPRO_LOG=debug`` raises verbosity globally.

``REPRO_LOG_FORMAT=json`` (or :func:`set_json_logging`) switches the
handler to one-JSON-object-per-line output; :func:`log_event` emits
machine-parseable key=value events (request logs carry the scheduler's
correlation ``query_id``) that serialize as flat JSON fields in that
mode and as readable ``event k=v ...`` lines otherwise.
"""

from __future__ import annotations

import json
import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False
_handler: logging.StreamHandler | None = None


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts/level/logger/message plus any flat
    fields attached by :func:`log_event`."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname.lower(),
            "logger": record.name,
        }
        event = getattr(record, "event", None)
        fields = getattr(record, "event_fields", None)
        if event is not None:
            out["event"] = event
            for k, v in (fields or {}).items():
                if k not in out:
                    out[k] = v
        else:
            out["message"] = record.getMessage()
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def _configure_root() -> None:
    global _configured, _handler
    if _configured:
        return
    level = getattr(logging, os.environ.get("REPRO_LOG", "info").upper(), logging.INFO)
    _handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("REPRO_LOG_FORMAT", "").lower() == "json":
        _handler.setFormatter(JsonFormatter())
    else:
        _handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger("repro_torch")
    root.setLevel(level)
    root.addHandler(_handler)
    root.propagate = False
    _configured = True


def set_json_logging(enabled: bool = True) -> None:
    """Switch the repro_torch handler to (or from) JSON-lines output at runtime
    — the programmatic equivalent of ``REPRO_LOG_FORMAT=json``."""
    _configure_root()
    assert _handler is not None
    if enabled:
        _handler.setFormatter(JsonFormatter())
    else:
        _handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))


def log_event(logger: logging.Logger, event: str,
              level: int = logging.INFO, **fields) -> None:
    """Emit a structured event: ``event k=v ...`` as text, flat JSON
    fields under ``REPRO_LOG_FORMAT=json``.  The serving layer routes
    request logs through this with the correlation ``query_id``."""
    if not logger.isEnabledFor(level):
        return
    msg = event
    if fields:
        msg += " " + " ".join(f"{k}={v}" for k, v in fields.items())
    logger.log(level, msg, extra={"event": event, "event_fields": fields})


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("repro_torch"):
        name = f"repro_torch.{name}"
    return logging.getLogger(name)
