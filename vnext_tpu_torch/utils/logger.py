"""Logging setup of the entry point.

Counterpart of ``vnext_tpu.utils.logger.setup_logger``: the package's logger
prints to stdout (warnings and errors marked in colour) and writes
``<output>/log.txt``. The stdout handler is added once; each call with an
output directory moves the file handler to that directory's ``log.txt``, so
every run of the entry point in one process logs into its own directory.
"""

from __future__ import annotations

import logging
import os
import sys

_FMT = "[%(asctime)s %(name)s]: %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"


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


def setup_logger(output: str | None = None, *, name: str = "vnext_tpu_torch",
                 level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(level)
        ch.setFormatter(_ColorFormatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(ch)
    if output is not None:
        filename = os.path.abspath(os.path.join(output, "log.txt"))
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
