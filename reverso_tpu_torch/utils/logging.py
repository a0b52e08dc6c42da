"""Structured logging + the reference-compatible accumulating status log.

The reference logs progress by appending emoji strings to a list and joining
them for the UI (core_system.py:464-468). `StatusLog` reproduces that
surface (callbacks get (message, progress)) on top of structured logging.
"""
from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"reverso.{name}")
    if not logging.getLogger("reverso").handlers:
        root = logging.getLogger("reverso")
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logger


class StatusLog:
    """Accumulating status transcript with optional progress callback.

    Mirrors the closure `log_status(message, progress_value)` the reference
    threads through `create_database` (core_system.py:464-468) and the video
    pipelines (video_processing.py:372-379).
    """

    def __init__(self, progress_callback: Optional[Callable[[str, Optional[float]], None]] = None,
                 logger: Optional[logging.Logger] = None):
        self.messages: list[str] = []
        self._cache = ""
        self._cache_len = 0
        self._cb = progress_callback
        self._logger = logger or get_logger("status")

    def __call__(self, message: str, progress: Optional[float] = None) -> str:
        """Record + forward one status line; returns the MESSAGE (use
        `.text` for the transcript — returning the joined transcript
        from every call made long ingests O(n^2) in string copies;
        attribute `+=` doesn't dodge that either, CPython's in-place
        concat only optimizes local-variable targets)."""
        self.messages.append(message)
        self._logger.info(message)
        if self._cb is not None:
            try:
                self._cb(message, progress)
            except Exception:  # progress UI must never kill the pipeline
                pass
        return message

    @property
    def text(self) -> str:
        if self._cache_len != len(self.messages):
            self._cache = "\n".join(self.messages)
            self._cache_len = len(self.messages)
        return self._cache
