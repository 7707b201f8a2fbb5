"""Logging sinks of the trainer (port of dc_vic_tpu/utils/logger.py): a
console and file logger, an append-only CSV logger and a windowed average
meter that sums device scalars without waiting for the device."""
from __future__ import annotations

import csv
import logging
import os
import sys
from typing import Dict, List, Optional

import torch

_LOGGER_NAME = "dc_vic_tpu_torch"


def get_root_logger(log_file: Optional[str] = None, level: int = logging.INFO
                    ) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        logger.setLevel(level)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s",
                                          "%H:%M:%S"))
        logger.addHandler(sh)
        logger.propagate = False
    if log_file is not None and not any(
            isinstance(h, logging.FileHandler) and h.baseFilename == os.path.abspath(log_file)
            for h in logger.handlers):
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s"))
        logger.addHandler(fh)
    return logger


def bolded_log(msg: str, level: str = "info") -> None:
    logger = get_root_logger()
    bar = "=" * max(24, len(msg))
    for line in ("", bar, msg, bar):
        getattr(logger, level)(line)


class AvgMeter:
    """Windowed running average of named scalars, reset on read. Tensor
    values are summed where they live; ``pop`` reads them to the host."""

    def __init__(self):
        self._sum: Dict[str, object] = {}
        self._cnt: Dict[str, int] = {}

    def update(self, values: Dict) -> None:
        for k, v in values.items():
            v = v.detach().float() if isinstance(v, torch.Tensor) else float(v)
            self._sum[k] = self._sum[k] + v if k in self._sum else v
            self._cnt[k] = self._cnt.get(k, 0) + 1

    def pop(self) -> Dict[str, float]:
        out = {k: float(self._sum[k]) / self._cnt[k] for k in self._sum}
        self._sum.clear()
        self._cnt.clear()
        return out


class CSVLogger:
    """Append-only CSV logger; appends to an existing file with its header."""

    def __init__(self, path: str, fieldnames: List[str]):
        self.path = path
        self.fieldnames = list(fieldnames)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self.fieldnames).writeheader()
        else:
            with open(path, newline="") as f:
                header = next(csv.reader(f), None)
            if header and header != self.fieldnames:
                self.fieldnames = header

    def write(self, row: Dict) -> None:
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fieldnames, extrasaction="ignore").writerow(row)
