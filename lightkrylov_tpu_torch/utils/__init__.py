"""Options, logging, timers, checkpoints and small dense linear algebra."""

from . import checkpoint, linalg, logger, options, timer

__all__ = ["checkpoint", "linalg", "logger", "options", "timer"]
