"""Wall-clock iteration statistics for progress and ETA (port of
dc_vic_tpu/utils/timer.py)."""
from __future__ import annotations

import time
from typing import Dict


class Timer:
    def __init__(self, start_iter: int, total_iter: int):
        self.start_time = time.time()
        self.last_time = self.start_time
        self.last_iter = start_iter
        self.total_iter = total_iter

    def get_time_stat(self, itr: int) -> Dict[str, float]:
        now = time.time()
        interval = now - self.last_time
        time_per_iter = interval / max(1, itr - self.last_iter)
        self.last_time, self.last_iter = now, itr
        return {"runtime_sec": now - self.start_time, "interval_sec": interval,
                "time_per_iter": time_per_iter,
                "eta_hours": time_per_iter * max(0, self.total_iter - itr) / 3600.0}
