"""CLI entry point: test-mode serving from a YAML configuration.

Port of the serving half of my_depthsplat_tpu/main.py (``test``,
:454-530): YAML + dot-overrides -> ``RootCfg`` -> the dataset with its view
sampler and shims -> the encoder under the precision policy ->
``decode_splatting`` -> ``run_test``'s scores and files:

    python -m my_depthsplat_torch.main --config configs/re10k_720p_fast.yaml \\
        'dataset.roots=[datasets/re10k]' output_dir=outputs/run

It runs on the card (``test(cfg, device="cpu")`` runs the plain versions on
the CPU). The encoder's weights are random from ``seed`` unless
``checkpointing.load`` names one of the port's own checkpoints
(``step_*.pt``, train/checkpoints.py). Not ported yet, and refused:
``mode=train`` (ROADMAP.md queue 1 item 9) and the reference-format
pretrained slots (item 7).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from .config import RootCfg, load_config
from .data import (
    DataLoaderCfg,
    apply_bounds_shim,
    apply_patch_shim,
    data_loader,
    get_dataset,
    get_view_sampler,
)
from .eval.runner import run_test
from .models import EncoderDepthSplat
from .models.precision import apply_with_precision, resolve_dtype
from .train.lpips_io import build_lpips
from .utils.device import resolve_device

BATCH_KEYS = ("image", "extrinsics", "intrinsics", "near", "far", "depth")


def build_dataset(cfg: RootCfg, stage: str, host_id: int = 0, num_hosts: int = 1):
    """dataset.name-dispatched reader (reference src/dataset/__init__.py:21-32)."""
    sampler = get_view_sampler(cfg.dataset.view_sampler, stage=stage, **cfg.dataset.view_sampler_args)
    return get_dataset(cfg.dataset, stage, sampler, host_id, num_hosts)


def prepare_batch(cfg: RootCfg, batch: dict) -> dict:
    """Numpy-side batch shims (data_module.py:17-32 +
    encoder_depthsplat.py:363-373): crop to a multiple of
    shim_patch_size * downscale_factor, then optionally replace near/far with
    disparity-derived bounds."""
    batch = apply_patch_shim(batch, cfg.encoder.shim_patch_size * cfg.encoder.downscale_factor)
    if cfg.dataset.use_bounds_shim:
        batch = apply_bounds_shim(
            batch, cfg.dataset.bounds_near_disparity, cfg.dataset.bounds_far_disparity
        )
    return batch


def torch_batch(batch: dict, device: torch.device | str) -> dict:
    """numpy batch (NHWC already) -> tensors on ``device``, dropping
    host-only fields."""

    def conv(views: dict) -> dict:
        return {
            k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in views.items()
            if k in BATCH_KEYS
        }

    return {"context": conv(batch["context"]), "target": conv(batch["target"])}


def _restore_encoder(cfg: RootCfg, encoder: EncoderDepthSplat) -> None:
    """Pretrained weights: the port's own checkpoints only."""
    ck = cfg.checkpointing
    for slot in ("pretrained_model", "pretrained_monodepth", "pretrained_depth", "pretrained_mvdepth"):
        if getattr(ck, slot):
            raise NotImplementedError(
                f"checkpointing.{slot}: the reference-format pretrained loaders are queued "
                "in ROADMAP.md queue 1 item 7 (checkpoints)"
            )
    if not ck.load:
        return
    path = Path(ck.load)
    if not (path.is_file() and path.suffix == ".pt" and path.name.startswith("step_")):
        raise NotImplementedError(
            f"checkpointing.load={ck.load!r}: the port restores its own step_*.pt files "
            "(train/checkpoints.py); other formats are queued in ROADMAP.md queue 1 item 7"
        )
    device = next(encoder.parameters()).device
    blob = torch.load(path.absolute(), map_location=device, weights_only=True)
    encoder.load_state_dict(blob["model"], strict=True)
    print(f"restored {path}")


def test(cfg: RootCfg, device: torch.device | str | None = None) -> dict:
    """Serve the test split: every scene through the encoder (random weights
    from ``cfg.seed`` unless ``checkpointing.load`` restores them) under
    ``encoder.compute_dtype``, its targets through ``decode_splatting``, and
    ``run_test``'s scores, timings and files under ``output_dir/test``."""
    dev = resolve_device(device)
    encoder = EncoderDepthSplat(cfg.encoder, device=dev, seed=cfg.seed).eval()
    _restore_encoder(cfg, encoder)
    # one copy of the parameters in the compute dtype, made once; the
    # policy then casts only the images (models/precision.py)
    encoder.to(resolve_dtype(cfg.encoder.compute_dtype))

    def apply(context: dict) -> dict:
        return apply_with_precision(encoder, cfg.encoder.compute_dtype, context)

    loader = data_loader(
        build_dataset(cfg, "test"), DataLoaderCfg(batch_size=1, seed=cfg.data_loader.seed), "test"
    )
    batches = ({**b, **torch_batch(prepare_batch(cfg, b), dev)} for b in loader)
    test_cfg = dataclasses.replace(
        cfg.test,
        output_dir=Path(cfg.output_dir) / "test",
        forward_depth_only=cfg.test.forward_depth_only or cfg.encoder.train_depth_only,
    )
    # LPIPS as an eval metric (metrics.py:22-35) only when loss.lpips_weights
    # names a weights file; build_lpips returns None otherwise
    result = run_test(
        test_cfg, apply, batches, decoder_cfg=cfg.decoder,
        lpips_fn=build_lpips(cfg.loss.lpips_weights, dev), device=dev,
    )
    print(json.dumps(result, indent=2))
    return result


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    if cfg.mode != "test":
        raise NotImplementedError(
            f"mode={cfg.mode!r}: the train loop is queued in ROADMAP.md queue 1 item 9; "
            "the port's CLI serves mode=test"
        )
    return test(cfg)


if __name__ == "__main__":
    main()
