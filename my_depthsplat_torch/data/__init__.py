"""The data path: the re10k chunk reader, view samplers, shims and the
batching loader, in numpy (the port's own copies of the JAX package's)."""

from .loader import DataLoaderCfg, batch_examples, data_loader
from .registry import DATASETS, build_dataset_cfg, get_dataset
from .shims import (
    apply_augmentation_shim,
    apply_bounds_shim,
    apply_crop_shim,
    apply_patch_shim,
)
from .view_samplers import (
    ViewSamplerAll,
    ViewSamplerArbitrary,
    ViewSamplerBounded,
    ViewSamplerBoundedV2,
    ViewSamplerEvaluation,
    get_view_sampler,
)

__all__ = [
    "DATASETS",
    "DataLoaderCfg",
    "build_dataset_cfg",
    "get_dataset",
    "ViewSamplerAll",
    "ViewSamplerArbitrary",
    "ViewSamplerBounded",
    "ViewSamplerBoundedV2",
    "ViewSamplerEvaluation",
    "apply_augmentation_shim",
    "apply_bounds_shim",
    "apply_crop_shim",
    "apply_patch_shim",
    "batch_examples",
    "data_loader",
    "get_view_sampler",
]
