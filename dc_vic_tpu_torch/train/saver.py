"""Checkpoint save and restore (port of dc_vic_tpu/train/saver.py).

Checkpoints are ``torch.save`` files named ``{label}_iter{N|NK}.ckpt``, one
per label (``comp_model``, ``discriminator``: state dicts;
``training_state``: the optimizers' states and the step). Saving a label
deletes that label's previous checkpoint unless its iteration is one of the
kept steps. Checkpoints of the JAX package (msgpack) are a different format
and do not load here.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..utils.paths import iter2str


class Saver:
    def __init__(self, model_dir: str, keep_steps: Sequence[int] = ()):
        self.model_dir = model_dir
        self.keep_steps = set(int(s) for s in keep_steps)
        self._last: Dict[str, int] = {}
        os.makedirs(model_dir, exist_ok=True)

    def _path(self, label: str, itr: int) -> str:
        return os.path.join(self.model_dir, f"{label}_iter{iter2str(itr)}.ckpt")

    def save(self, payloads: Dict[str, Any], itr: int, keep: Optional[bool] = None) -> List[str]:
        """payloads: label -> what to save. Returns the written paths."""
        written = []
        keep_this = keep if keep is not None else itr in self.keep_steps
        for label, payload in payloads.items():
            path = self._path(label, itr)
            torch.save(payload, path)
            written.append(path)
            prev = self._last.get(label)
            if prev is not None and prev not in self.keep_steps:
                prev_path = self._path(label, prev)
                if os.path.exists(prev_path):
                    os.remove(prev_path)
            if not keep_this:
                self._last[label] = itr
            else:
                self._last.pop(label, None)
        return written

    @staticmethod
    def load(path: str, map_location="cpu") -> Any:
        return torch.load(path, map_location=map_location, weights_only=True)
