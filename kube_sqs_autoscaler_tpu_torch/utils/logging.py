"""Logging setup: logrus-like leveled text output.

The reference logs through logrus's default text formatter
(``main.go:13``, ``scale/scale.go:9``), e.g.::

    time="2016-01-02T15:04:05Z" level=info msg="Found 30 messages in the queue"

This configures stdlib logging to emit the same shape so operators migrating
from the reference can keep their log scrapers.
"""

from __future__ import annotations

import logging
import time


class LogrusTextFormatter(logging.Formatter):
    """``time="…" level=… msg="…"`` text format (logrus TextFormatter)."""

    def format(self, record: logging.LogRecord) -> str:
        stamp = time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime(record.created))
        message = record.getMessage().replace('"', '\\"')
        line = f'time="{stamp}" level={record.levelname.lower()} msg="{message}"'
        if record.exc_info:
            line += f' error="{self.formatException(record.exc_info)}"'
        return line


def configure_logging(level: int = logging.INFO) -> None:
    """Install the logrus-style formatter on the root logger (idempotent)."""
    root = logging.getLogger()
    root.setLevel(level)
    for handler in root.handlers:
        if isinstance(handler.formatter, LogrusTextFormatter):
            return
    handler = logging.StreamHandler()
    handler.setFormatter(LogrusTextFormatter())
    root.addHandler(handler)
