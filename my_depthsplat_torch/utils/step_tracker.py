"""Cross-process global-step publication for curriculum schedules.

The port's own copy of my_depthsplat_tpu/utils/step_tracker.py (reference
src/misc/step_tracker.py:9-23). The port's loader runs in the training
process and reads the step from a callable; a loader in other processes
reads it from this shared value.
"""

from __future__ import annotations

import multiprocessing as mp


class StepTracker:
    def __init__(self) -> None:
        self._value = mp.Value("q", 0)  # int64 + built-in lock

    def set_step(self, step: int) -> None:
        with self._value.get_lock():
            self._value.value = int(step)

    def get_step(self) -> int:
        with self._value.get_lock():
            return int(self._value.value)
