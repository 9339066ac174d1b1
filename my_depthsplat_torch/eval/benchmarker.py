"""Wall-clock benchmarking with warm-up skipping + device memory stats.

Port of my_depthsplat_tpu/eval/benchmarker.py (reference
src/misc/benchmarker.py:11-40: tagged context-manager timing with num_calls
amortization, JSON dumps, CUDA peak memory). On the card every timed block
ends in a device synchronise, so a time covers the device's work and not
only its launch; the peak comes from the CUDA allocator since the
Benchmarker was made.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch


class Benchmarker:
    def __init__(self, device: torch.device | str = "cpu") -> None:
        self.device = torch.device(device)
        self.execution_times: dict[str, list[float]] = defaultdict(list)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        try:
            start = time.perf_counter()
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            end = time.perf_counter()
            for _ in range(num_calls):
                self.execution_times[tag].append((end - start) / num_calls)

    def dump(self, path: Path) -> None:
        path.parent.mkdir(exist_ok=True, parents=True)
        path.write_text(json.dumps(dict(self.execution_times), indent=2))

    def memory_stats(self) -> dict | None:
        """Peak and current bytes of the card's allocator; None on the CPU."""
        if self.device.type != "cuda":
            return None
        return {
            "device": torch.cuda.get_device_name(self.device),
            "max_memory_allocated": torch.cuda.max_memory_allocated(self.device),
            "max_memory_reserved": torch.cuda.max_memory_reserved(self.device),
            "memory_allocated": torch.cuda.memory_allocated(self.device),
        }

    def dump_memory(self, path: Path) -> None:
        path.parent.mkdir(exist_ok=True, parents=True)
        path.write_text(json.dumps({"device_0": self.memory_stats()}, indent=2))

    def summarize(self, skip_steps: int = 0) -> dict[str, float]:
        out = {}
        for tag, times in self.execution_times.items():
            kept = times[skip_steps:] if len(times) > skip_steps else times
            out[tag] = float(np.mean(kept)) if kept else float("nan")
        return out
