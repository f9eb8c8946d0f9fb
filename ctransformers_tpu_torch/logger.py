"""Library-wide logging with a user-installable callback.

The reference routes all runtime prints through a settable hook
(llama_log_set, llama.cpp:6284-6315); here the same contract rides the
stdlib logger: `set_log_callback(fn)` forwards every library record to
`fn(level_name, message)` and silences the default stderr output, and
`set_verbosity(level)` gates what gets emitted at all.
"""

import logging
from typing import Callable, Optional

logger = logging.getLogger("ctransformers_tpu_torch")


class _CallbackHandler(logging.Handler):
    def __init__(self, fn: Callable[[str, str], None]):
        super().__init__()
        self._fn = fn

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._fn(record.levelname, self.format(record))
        except Exception:  # a broken user hook must never kill inference
            pass


_installed: Optional[_CallbackHandler] = None


def set_log_callback(fn: Optional[Callable[[str, str], None]]) -> None:
    """Route library log records to `fn(level_name, message)`.

    Passing None restores the default (stdlib propagation to the root
    logger). Mirrors the reference's llama_log_set semantics: exactly one
    callback is active and it replaces, not stacks."""
    global _installed
    if _installed is not None:
        logger.removeHandler(_installed)
        logger.propagate = True
        _installed = None
    if fn is not None:
        _installed = _CallbackHandler(fn)
        logger.addHandler(_installed)
        logger.propagate = False


def set_verbosity(level) -> None:
    """Set the library log threshold: a logging level int or name
    ("DEBUG", "INFO", "WARNING", "ERROR")."""
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logger.setLevel(level)
