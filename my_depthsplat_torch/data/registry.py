"""Dataset registry: name -> (reader, cfg) dispatch.

The port's own copy of my_depthsplat_tpu/data/registry.py (the reference's
``get_dataset``, src/dataset/__init__.py:21-32). The shared ``DatasetCfg``
fields map onto the reader's cfg dataclass, and reader-specific knobs (e.g.
dl3dv ``min_views``/``max_views``, arkit ``highres``) pass through
``dataset.extra_args`` with unknown-key rejection.
"""

from __future__ import annotations

from dataclasses import fields
from pathlib import Path
from typing import get_type_hints

from ..config import DatasetCfg, _coerce
from .arkit import DatasetARKitScenes, DatasetARKitScenesCfg
from .dl3dv import DatasetDL3DV, DatasetDL3DVCfg
from .re10k import DatasetRE10k, DatasetRE10kCfg

DATASETS = {
    "re10k": (DatasetRE10k, DatasetRE10kCfg),
    "dl3dv": (DatasetDL3DV, DatasetDL3DVCfg),
    "arkit_scenes": (DatasetARKitScenes, DatasetARKitScenesCfg),
}


def build_dataset_cfg(cfg: DatasetCfg):
    """Materialize the per-dataset cfg dataclass from the generic DatasetCfg."""
    try:
        _, cfg_cls = DATASETS[cfg.name]
    except KeyError:
        raise ValueError(
            f"Unknown dataset {cfg.name!r}; known: {sorted(DATASETS)}"
        ) from None
    hints = get_type_hints(cfg_cls)
    valid = {f.name for f in fields(cfg_cls)}
    kwargs = {
        "roots": tuple(Path(r) for r in cfg.roots),
        "image_shape": tuple(cfg.image_shape),
        "near": cfg.near,
        "far": cfg.far,
        "augment": cfg.augment,
        "test_chunk_interval": cfg.test_chunk_interval,
    }
    # Always forwarded (None disables the raw-shape filter): the per-dataset
    # default ((360, 640) for re10k) would otherwise silently re-enable it.
    kwargs["expected_shape"] = (
        tuple(cfg.expected_shape) if cfg.expected_shape is not None else None
    )
    kwargs = {k: v for k, v in kwargs.items() if k in valid}
    for key, value in (cfg.extra_args or {}).items():
        if key not in valid:
            raise KeyError(
                f"Unknown dataset.extra_args key {key!r} for "
                f"{cfg_cls.__name__} (valid: {sorted(valid)})"
            )
        kwargs[key] = _coerce(value, hints[key])
    return cfg_cls(**kwargs)


def get_dataset(
    cfg: DatasetCfg,
    stage: str,
    view_sampler,
    host_id: int = 0,
    num_hosts: int = 1,
):
    """name-dispatched reader construction (reference __init__.py:21-32)."""
    cls, _ = DATASETS[cfg.name]
    return cls(build_dataset_cfg(cfg), stage, view_sampler, host_id, num_hosts)
