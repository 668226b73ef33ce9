"""Logging setup of the entry point, and the rate-limited log helpers.

Counterpart of ``vnext_tpu.utils.logger``: the package's logger prints to
stdout (warnings and errors marked in colour) on process 0 only and writes
``<output>/log.txt``, ``log.txt.rank{k}`` for process k > 0. The stdout
handler is added once; each call with an output directory moves the file
handler to that directory's file, so every run of the entry point in one
process logs into its own directory.

``log_first_n``, ``log_every_n`` and ``log_every_n_seconds`` (reference
surface: detectron2/utils/logger.py) count per calling line, or per message
with ``log_first_n``'s ``key="message"``.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import Counter

_FMT = "[%(asctime)s %(name)s]: %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"

_LOG_COUNTER: Counter = Counter()
_LOG_TIMER: dict = {}


class _ColorFormatter(logging.Formatter):
    YELLOW = "\x1b[33;20m"
    RED = "\x1b[31;20m"
    RESET = "\x1b[0m"

    def format(self, record):
        msg = super().format(record)
        if record.levelno == logging.WARNING:
            return self.YELLOW + "WARNING " + self.RESET + msg
        if record.levelno in (logging.ERROR, logging.CRITICAL):
            return self.RED + "ERROR " + self.RESET + msg
        return msg


def setup_logger(output: str | None = None, *, name: str = "vnext_tpu_torch", process_rank: int = 0,
                 level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if process_rank == 0 and not any(type(h) is logging.StreamHandler for h in logger.handlers):
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(level)
        ch.setFormatter(_ColorFormatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(ch)
    if output is not None:
        filename = os.path.abspath(os.path.join(output, "log.txt"))
        if process_rank > 0:
            filename = f"{filename}.rank{process_rank}"
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            if h.baseFilename == filename:
                return logger
            logger.removeHandler(h)
            h.close()
        os.makedirs(output, exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(level)
        fh.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(fh)
    return logger


def _find_caller():
    """(file, line, function) of the first frame outside this module."""
    frame = sys._getframe(2)
    while frame:
        code = frame.f_code
        if os.path.join("utils", "logger.") not in code.co_filename:
            return (code.co_filename, frame.f_lineno, code.co_name)
        frame = frame.f_back
    return ("unknown", 0, "unknown")


def log_first_n(level: int, msg: str, n: int = 1, *, name: str = "vnext_tpu_torch", key: str = "caller") -> None:
    """Log ``msg`` the first ``n`` times this line calls (``key="caller"``),
    or the first ``n`` times this message is logged (``key="message"``)."""
    caller_key = (msg if key == "message" else _find_caller(), msg if key == "caller" else "")
    _LOG_COUNTER[caller_key] += 1
    if _LOG_COUNTER[caller_key] <= n:
        logging.getLogger(name).log(level, msg)


def log_every_n(level: int, msg: str, n: int = 1, *, name: str = "vnext_tpu_torch") -> None:
    """Log ``msg`` on this line's 1st, (n+1)-th, (2n+1)-th ... call."""
    caller_key = _find_caller()
    _LOG_COUNTER[caller_key] += 1
    if (_LOG_COUNTER[caller_key] - 1) % n == 0:
        logging.getLogger(name).log(level, msg)


def log_every_n_seconds(level: int, msg: str, n: int = 1, *, name: str = "vnext_tpu_torch") -> None:
    """Log ``msg`` from this line at most once every ``n`` seconds."""
    caller_key = _find_caller()
    now = time.time()
    last = _LOG_TIMER.get(caller_key)
    if last is None or now - last >= n:
        logging.getLogger(name).log(level, msg)
        _LOG_TIMER[caller_key] = now
