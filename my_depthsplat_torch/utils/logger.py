"""Experiment logging.

The port's own copy of my_depthsplat_tpu/utils/logger.py (replacing the
reference's WandbLogger / LocalLogger pair, main.py:89-112,
src/misc/LocalLogger.py): scalars stream to ``metrics.jsonl``, images and
panels to ``images/{tag}_{step:08d}.png``. The wandb hook differs from the
JAX package's, which starts a run whenever wandb is importable: here the
scalars and images also go to a wandb run only when the caller has started
one (``wandb.init`` before ``main.train``). The logger starts none, so it
contacts no service by itself.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from .image_io import save_image


class LocalLogger:
    def __init__(self, output_dir: Path, run_name: str = "run") -> None:
        self.dir = Path(output_dir)
        self.dir.mkdir(exist_ok=True, parents=True)
        self._scalars = open(self.dir / "metrics.jsonl", "a")
        self._t0 = time.time()
        self.run_name = run_name
        wandb = sys.modules.get("wandb")
        self._wandb = None if wandb is None else wandb.run  # the caller's run, if any

    def log_scalars(self, step: int, scalars: dict) -> None:
        rec = {"step": int(step), "time": time.time() - self._t0, **{k: float(v) for k, v in scalars.items()}}
        self._scalars.write(json.dumps(rec) + "\n")
        self._scalars.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_image(self, step: int, tag: str, image: np.ndarray) -> None:
        save_image(image, self.dir / "images" / f"{tag.replace('/', '_')}_{step:0>8}.png")
        if self._wandb is not None:
            self._wandb.log({tag: sys.modules["wandb"].Image(np.asarray(image))}, step=step)

    def close(self) -> None:
        self._scalars.close()  # the wandb run is the caller's to finish
