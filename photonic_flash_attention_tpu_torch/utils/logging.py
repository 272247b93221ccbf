"""Structured logging for the engine.

TPU rebirth of reference utils/logging.py:14-259: namespaced loggers, a
text/JSON structured formatter, a ``PerformanceLogger`` timer helper, and
env-driven setup (``PFA_LOG_LEVEL`` / ``PFA_LOG_FILE`` / ``PFA_LOG_JSON``).
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

_ROOT_NAME = "pfa_tpu_torch"
_configured = False


class StructuredFormatter(logging.Formatter):
    """Text or JSON formatter (reference PhotonicFormatter, logging.py:14-86)."""

    def __init__(self, json_format: bool = False) -> None:
        super().__init__()
        self.json_format = json_format

    def format(self, record: logging.LogRecord) -> str:
        if self.json_format:
            payload: Dict[str, Any] = {
                "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
            }
            extra = getattr(record, "extra_fields", None)
            if extra:
                payload.update(extra)
            if record.exc_info:
                payload["exc"] = self.formatException(record.exc_info)
            return json.dumps(payload)
        base = (
            f"{self.formatTime(record, '%H:%M:%S')} "
            f"{record.levelname:<7} {record.name}: {record.getMessage()}"
        )
        extra = getattr(record, "extra_fields", None)
        if extra:
            base += " " + " ".join(f"{k}={v}" for k, v in extra.items())
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def setup_logging(
    level: Optional[str] = None,
    log_file: Optional[str] = None,
    json_format: Optional[bool] = None,
) -> None:
    """Configure the engine's root logger (reference logging.py:133-193)."""
    global _configured
    level = level or os.environ.get("PFA_LOG_LEVEL", "INFO")
    log_file = log_file or os.environ.get("PFA_LOG_FILE")
    if json_format is None:
        json_format = os.environ.get("PFA_LOG_JSON", "").lower() in ("1", "true")

    root = logging.getLogger(_ROOT_NAME)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()

    stream = logging.StreamHandler()
    stream.setFormatter(StructuredFormatter(json_format))
    root.addHandler(stream)

    if log_file:
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=32 * 1024 * 1024, backupCount=3
        )
        fh.setFormatter(StructuredFormatter(json_format=True))
        root.addHandler(fh)

    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger under the engine root (reference logging.py:195-222)."""
    if not _configured:
        setup_logging()
    if name.startswith(_ROOT_NAME):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT_NAME}.{name}")


class PerformanceLogger:
    """Start/end timers + metric logs (reference logging.py:88-131)."""

    def __init__(self, logger: Optional[logging.Logger] = None) -> None:
        self.logger = logger or get_logger("perf")
        self._timers: Dict[str, float] = {}

    def start_timer(self, name: str) -> None:
        self._timers[name] = time.perf_counter()

    def end_timer(self, name: str, **fields: Any) -> float:
        start = self._timers.pop(name, None)
        if start is None:
            return 0.0
        elapsed_ms = (time.perf_counter() - start) * 1e3
        self.log_metric(f"{name}_ms", elapsed_ms, **fields)
        return elapsed_ms

    def log_metric(self, name: str, value: Any, **fields: Any) -> None:
        self.logger.info(
            "%s=%s", name, value, extra={"extra_fields": {"metric": name, "value": value, **fields}}
        )

    @contextmanager
    def timed(self, name: str, **fields: Any) -> Iterator[None]:
        self.start_timer(name)
        try:
            yield
        finally:
            self.end_timer(name, **fields)


@contextmanager
def log_context(logger: logging.Logger, **fields: Any) -> Iterator[None]:
    """Inject extra structured fields into records (reference LogContext)."""
    factory = logging.getLogRecordFactory()

    def record_factory(*args: Any, **kwargs: Any) -> logging.LogRecord:
        record = factory(*args, **kwargs)
        existing = getattr(record, "extra_fields", {})
        record.extra_fields = {**existing, **fields}
        return record

    logging.setLogRecordFactory(record_factory)
    try:
        yield
    finally:
        logging.setLogRecordFactory(factory)
