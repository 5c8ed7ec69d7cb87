"""Logging (reference: include/LightGBM/utils/log.h:71-177).

Level-filtered logger with a pluggable sink callback
(``LGBM_RegisterLogCallback`` analog, c_api.h:71) — the python-package
redirects to the ``logging`` module (basic.py:49-110), which is the default
sink here.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

_logger = logging.getLogger("lightgbm_torch")
_callback: Optional[Callable[[str], None]] = None


class Log:
    """Log::Debug/Info/Warning/Fatal (log.h)."""
    level: int = 1  # -1 fatal only, 0 +warning, 1 +info, 2 +debug

    @classmethod
    def set_verbosity(cls, verbosity: int) -> None:
        """Map a Config ``verbosity`` (alias ``verbose``) to the level,
        with reference semantics (config.h / Log::ResetLogLevel): <0
        fatal-only, 0 warnings, 1 info, >=2 debug."""
        v = int(verbosity)
        cls.level = -1 if v < 0 else min(v, 2)

    @staticmethod
    def _emit(msg: str, py_level: int) -> None:
        if _callback is not None:
            _callback(msg + "\n")
        else:
            _logger.log(py_level, msg)
            if not _logger.handlers and not logging.getLogger().handlers:
                print(msg, file=sys.stderr)

    @classmethod
    def debug(cls, msg: str) -> None:
        if cls.level >= 2:
            cls._emit(f"[LightGBM-Torch] [Debug] {msg}", logging.DEBUG)

    @classmethod
    def info(cls, msg: str) -> None:
        if cls.level >= 1:
            cls._emit(f"[LightGBM-Torch] [Info] {msg}", logging.INFO)

    @classmethod
    def warning(cls, msg: str) -> None:
        if cls.level >= 0:
            cls._emit(f"[LightGBM-Torch] [Warning] {msg}", logging.WARNING)

    @classmethod
    def fatal(cls, msg: str) -> None:
        cls._emit(f"[LightGBM-Torch] [Fatal] {msg}", logging.ERROR)
        raise RuntimeError(msg)


def register_log_callback(cb: Optional[Callable[[str], None]]) -> None:
    """LGBM_RegisterLogCallback analog."""
    global _callback
    _callback = cb


def register_logger(logger, info_method_name: str = "info",
                    warning_method_name: str = "warning") -> None:
    """Route log lines to a caller-supplied logger object
    (python-package basic.py:49 register_logger contract: Info-level
    lines go to ``info_method_name``, warnings to
    ``warning_method_name``)."""
    info = getattr(logger, info_method_name)
    warn = getattr(logger, warning_method_name)

    def _cb(msg: str) -> None:
        line = msg.rstrip("\n")
        if "[Warning]" in line or "[Fatal]" in line:
            warn(line)
        else:
            info(line)

    register_log_callback(_cb)
