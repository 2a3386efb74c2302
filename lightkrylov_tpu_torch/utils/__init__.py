"""Options, logging, timers and small dense linear algebra."""

from . import linalg, logger, options, timer

__all__ = ["linalg", "logger", "options", "timer"]
