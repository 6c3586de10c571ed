"""Stdout tee logger, a copy of ``mvdetr_tpu/utils/logger.py`` (contract: the
original MVDeTr's ``multiview_detector/utils/logger.py:5-36``).

Mirrors: every print goes to the console and to ``logdir/log.txt``, flushed
and fsynced so logs survive crashes.
"""

from __future__ import annotations

import os
import sys


class Logger:
    def __init__(self, fpath: str | None = None, append: bool = False):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            os.makedirs(os.path.dirname(fpath), exist_ok=True)
            self.file = open(fpath, "a" if append else "w")

    def __del__(self):
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)
            self.file.flush()
            os.fsync(self.file.fileno())

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        try:
            self.console.flush()
        except Exception:
            pass
        if self.file is not None:
            try:
                self.file.close()
            except Exception:
                pass
            self.file = None


class AverageMeter:
    """Running average (`utils/meters.py:4-20`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0
