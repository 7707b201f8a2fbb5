"""Job-directory layout and iteration labels (port of
dc_vic_tpu/utils/paths.py)."""
from __future__ import annotations

import os


def iter2str(itr: int) -> str:
    """500000 -> '500K' (multiples of 1000 only), else str(itr)."""
    if itr >= 1000 and itr % 1000 == 0:
        return f"{itr // 1000}K"
    return str(itr)


class PathHandler:
    """Layout: {ckpt_root}/{exp}/{model,sample}; log files beside them."""

    def __init__(self, ckpt_root: str, exp: str):
        self.ckpt_root = ckpt_root
        self.exp = exp
        self.job_dir = os.path.join(ckpt_root, exp)
        self.model_dir = os.path.join(self.job_dir, "model")
        self.sample_dir = os.path.join(self.job_dir, "sample")

    def make_job_dir(self) -> None:
        os.makedirs(self.model_dir, exist_ok=True)
        os.makedirs(self.sample_dir, exist_ok=True)

    @property
    def log_path(self) -> str:
        return os.path.join(self.job_dir, "train.log")

    @property
    def loss_csv_path(self) -> str:
        return os.path.join(self.job_dir, "log_loss.csv")

    @property
    def eval_csv_path(self) -> str:
        return os.path.join(self.job_dir, "eval_result.csv")

    def checkpoint_path(self, label: str, itr: int) -> str:
        return os.path.join(self.model_dir, f"{label}_iter{iter2str(itr)}.ckpt")
