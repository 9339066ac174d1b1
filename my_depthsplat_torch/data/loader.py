"""Batching + host-sharded loading.

The port's own copy of my_depthsplat_tpu/data/loader.py. Replaces the
Lightning DataModule (src/dataset/data_module.py:58-130): plain iterators,
explicit numpy RNG seeded per (host, stage, epoch) mirroring the rank-offset
generators (data_module.py:82-88), stacked numpy batches that
``main.torch_batch`` moves to the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataLoaderCfg:
    batch_size: int = 1
    seed: int = 1234
    host_id: int = 0
    num_hosts: int = 1


def batch_examples(examples: list[dict]) -> dict:
    """Stack a list of per-scene examples into one batched dict."""
    def stack(key: str, sub: str):
        return np.stack([ex[sub][key] for ex in examples])

    out = {}
    for sub in ("context", "target"):
        views = {}
        for key in examples[0][sub]:
            if key == "index":
                views[key] = [ex[sub][key] for ex in examples]
            else:
                views[key] = stack(key, sub)
        out[sub] = views
    out["scene"] = [ex["scene"] for ex in examples]
    return out


def data_loader(
    dataset,
    cfg: DataLoaderCfg,
    stage: str = "train",
    global_step=0,
    epoch: int = 0,
) -> Iterator[dict]:
    """Yield batched examples; infinite over epochs for train.

    ``global_step`` may be an int or a zero-arg callable returning the live
    training step; callables keep view-sampler warm-up curricula advancing
    mid-epoch (resolved per example in the samplers — view_samplers.py)."""
    while True:
        seed = (
            cfg.seed
            + cfg.host_id * 1_000_003
            + epoch * 7919
            + {"train": 0, "val": 1, "test": 2}[stage]
        )
        rng = np.random.default_rng(seed)
        buf: list[dict] = []
        produced = 0
        for example in dataset.examples(rng, global_step):
            buf.append(example)
            produced += 1
            if len(buf) == cfg.batch_size:
                yield batch_examples(buf)
                buf = []
        if stage != "train":
            if buf:
                yield batch_examples(buf)
            return
        if produced == 0:
            raise RuntimeError(
                "dataset produced no examples this epoch — check shape filters "
                "(expected_shape), view-sampler distances, and data roots"
            )
        epoch += 1
