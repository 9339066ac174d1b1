"""CLI entry point: training and test-mode serving from a YAML configuration.

Port of my_depthsplat_tpu/main.py: YAML + dot-overrides -> ``RootCfg`` ->
the dataset with its view sampler and shims -> the encoder under the
precision policy, then either the train loop (``train``, :171-305) or
``decode_splatting`` and ``run_test``'s scores and files (``test``,
:454-530):

    python -m my_depthsplat_torch.main --config configs/re10k_small.yaml \\
        'dataset.roots=[datasets/re10k]' output_dir=outputs/run

It runs on the card (``train(cfg, device="cpu")`` and ``test(cfg,
device="cpu")`` run the plain versions on the CPU). Both modes start from
random weights drawn from ``seed``, then apply the pretrained slots
(``checkpointing.pretrained_{monodepth,model,depth,mvdepth}``, :101-123),
each a reference checkpoint or one of the port's own ``step_*.pt`` files.
Training then resumes from the newest ``checkpoints/step_*.pt`` under
``output_dir`` with ``checkpointing.resume``; it logs to ``metrics.jsonl``,
validates every ``trainer.val_check_interval`` steps, evaluates on the test
split every ``trainer.test_eval_interval`` steps and checkpoints every
``checkpointing.every_n_train_steps``. Test mode then loads
``checkpointing.load`` in either format (:480-493).

Training runs on several cards under ``torchrun``, one process per card
(:171-183, ``build_parallel`` :126-147):

    python -m torch.distributed.run --nproc_per_node=4 -m my_depthsplat_torch.main \
        --config configs/re10k_small.yaml ... trainer.mesh_data=2 trainer.mesh_model=2

The ranks form a (data, model) mesh (parallel/mesh.py): the batch is split
over the data axis, and a model axis of more than one rank splits the plane
sweep's candidates, the transformer's query views and the rendered targets.
Every rank reads the same loader stream and takes its rows; rank 0 writes
the logs, validation images, evaluation files and checkpoints, and every
rank computes them. Test mode stays single-process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import time
from pathlib import Path

import torch

from .config import RootCfg, load_config, to_dict
from .data import (
    DataLoaderCfg,
    apply_bounds_shim,
    apply_patch_shim,
    data_loader,
    get_dataset,
    get_view_sampler,
)
from .eval.metrics import compute_psnr
from .eval.runner import run_test
from .models import EncoderDepthSplat, decode_splatting
from .models.precision import apply_with_precision, resolve_dtype
from .models.vit import VIT_CONFIGS
from .parallel import MeshCfg, barrier, initialize_distributed, make_mesh, rank_device, set_mesh, shard_batch
from .parallel.distributed import check_replicated, env_world_size, world_rank
from .train import TrainCfg, TrainState, make_train_step
from .train.checkpoints import (
    checkpoint_step,
    find_latest_checkpoint,
    load_pretrained_depth,
    load_pretrained_model,
    load_pretrained_monodepth,
    load_slot_params,
    resolve_checkpoint_uri,
    restore_checkpoint,
    save_checkpoint,
)
from .train.lpips_io import build_lpips
from .utils.device import resolve_device
from .utils.layout import add_border, hcat, vcat
from .utils.logger import LocalLogger
from .utils.vis_depth import viz_depth

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


def _vit_depth(cfg: RootCfg) -> int:
    return VIT_CONFIGS[cfg.encoder.monodepth_vit_type].depth


def apply_pretrained_slots(cfg: RootCfg, encoder: EncoderDepthSplat) -> None:
    """The reference's 3-way filtered pretrained loading before fit/test
    (src/main.py:188-266), in its order: monodepth first, then the full
    model (optionally skipping the depth predictor), then the depth-only
    slots. Each slot's source is read against the encoder's weights as they
    were on entry, and the result is loaded once at the end."""
    ck = cfg.checkpointing
    if not any((ck.pretrained_monodepth, ck.pretrained_model, ck.pretrained_depth, ck.pretrained_mvdepth)):
        return
    base = encoder.state_dict()
    params = dict(base)
    if ck.pretrained_monodepth:
        loaded = load_slot_params(ck.pretrained_monodepth, base, _vit_depth(cfg))
        params = load_pretrained_monodepth(params, loaded)
        print(f"loaded pretrained_monodepth from {ck.pretrained_monodepth}")
    if ck.pretrained_model:
        loaded = load_slot_params(ck.pretrained_model, base, _vit_depth(cfg))
        params = load_pretrained_model(params, loaded, skip_depth_predictor=ck.pretrained_model_skip_depth)
        print(f"loaded pretrained_model from {ck.pretrained_model}")
    for slot in (ck.pretrained_depth, ck.pretrained_mvdepth):
        if slot:
            loaded = load_slot_params(slot, base, _vit_depth(cfg))
            params = load_pretrained_depth(params, loaded)
            print(f"loaded pretrained depth slot from {slot}")
    encoder.load_state_dict(params, strict=True)


def _restore_encoder(cfg: RootCfg, encoder: EncoderDepthSplat) -> None:
    """Test mode's weights: the pretrained slots, then ``checkpointing.load``
    whole, either one of the port's own ``step_*.pt`` files or a reference
    checkpoint through the converter."""
    apply_pretrained_slots(cfg, encoder)
    if not cfg.checkpointing.load:
        return
    path = resolve_checkpoint_uri(cfg.checkpointing.load)
    encoder.load_state_dict(load_slot_params(path, encoder.state_dict(), _vit_depth(cfg)), strict=True)
    print(f"restored {path}")


def build_parallel(cfg: RootCfg):
    """The mesh from ``trainer.mesh_data`` x ``trainer.mesh_model`` over the
    process group (1 x 1 in one process; a grid that does not cover the
    world raises, naming torchrun), and the encoder configuration: with a
    model axis of more than one rank the plane sweep's candidates and the
    ring attention's views split over it (``spmd_depth_axis`` and
    ``spmd_view_axis`` = "model"), and so do the rendered targets
    (``make_train_step`` reads the mesh). Returns (mesh, encoder_cfg)."""
    mesh = make_mesh(MeshCfg(data=cfg.trainer.mesh_data, model=cfg.trainer.mesh_model))
    encoder_cfg = cfg.encoder
    if mesh.shape["model"] > 1:
        encoder_cfg = dataclasses.replace(encoder_cfg, spmd_depth_axis="model", spmd_view_axis="model")
    return mesh, encoder_cfg


def test(cfg: RootCfg, device: torch.device | str | None = None) -> dict:
    """Serve the test split: every scene through the encoder (random weights
    from ``cfg.seed``, then the pretrained slots and ``checkpointing.load``) under
    ``encoder.compute_dtype``, its targets through ``decode_splatting``, and
    ``run_test``'s scores, timings and files under ``output_dir/test``.
    Single-process: it raises under a launcher's world of more than one."""
    if max(env_world_size(), world_rank()[1]) > 1:
        raise RuntimeError("mode=test runs in one process: launch it without torchrun")
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


def train(cfg: RootCfg, device: torch.device | str | None = None) -> TrainState | None:
    """The train loop (my_depthsplat_tpu/main.py:train): the state from
    ``cfg.seed`` on the first batch with the pretrained slots applied
    (the optimizer's state untouched), then restored from the newest
    checkpoint with ``checkpointing.resume``; one ``train_step`` per batch of the train
    split, whose bounded sampler reads the live step; a log line every
    ``print_log_every_n_steps``, validation every ``val_check_interval``,
    test-split evaluation every ``test_eval_interval`` (0: never), a
    checkpoint every ``every_n_train_steps`` pruned to ``save_top_k``, and
    one at the end unless the loop has just saved. Returns the state.

    Under torchrun: the process group first (``initialize_distributed``),
    then the mesh (``build_parallel``, set for the modules with
    ``set_mesh``); every rank runs every step, validation and evaluation,
    and rank 0 alone writes."""
    dev = resolve_device(device)
    initialize_distributed(dev)
    dev = rank_device(dev)
    mesh, encoder_cfg = build_parallel(cfg)
    cfg = dataclasses.replace(cfg, encoder=encoder_cfg)
    set_mesh(mesh)
    writer = mesh.rank == 0
    out_dir = Path(cfg.output_dir)
    if writer:
        out_dir.mkdir(exist_ok=True, parents=True)
        (out_dir / "config.json").write_text(json.dumps(to_dict(cfg), indent=2, default=str))
    barrier()

    # LPIPS as a loss (loss_lpips.py:27-59): only when a weights file is
    # configured and its weight is nonzero
    lpips = None
    if cfg.loss.lpips_weight > 0 and cfg.loss.lpips_weights:
        lpips = build_lpips(cfg.loss.lpips_weights, dev)
    train_cfg = TrainCfg(
        encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss, optimizer=cfg.optimizer,
        depth_mode=cfg.train.depth_mode, grad_accum=cfg.train.grad_accum,
    )
    init_fn, train_step = make_train_step(train_cfg, lpips=lpips, device=dev, mesh=mesh)

    ckpt_dir = out_dir / "checkpoints"
    latest = find_latest_checkpoint(ckpt_dir) if cfg.checkpointing.resume else None
    # the loader's view sampler reads this cell per example, so the bounded
    # samplers' warm-up advances during the run (model_wrapper.py:371-373)
    step_cell = {"step": 0 if latest is None else checkpoint_step(latest)}
    loader = data_loader(
        build_dataset(cfg, "train"),
        DataLoaderCfg(batch_size=cfg.data_loader.batch_size, seed=cfg.data_loader.seed),
        "train", global_step=lambda: step_cell["step"],
    )
    val_iter = _make_val_iter(cfg)
    logger = LocalLogger(out_dir, run_name=out_dir.name) if writer else None
    log_every = cfg.trainer.print_log_every_n_steps
    state, last_saved = None, -1
    t_last = time.time()
    try:
        for batch in loader:
            if state is None:
                state = init_fn(seed=cfg.seed)
                apply_pretrained_slots(cfg, state.model)
                if latest is not None:
                    restore_checkpoint(latest, state)
                    if writer:
                        print(f"resuming from {latest} at step {state.step}")
                check_replicated(list(state.model.parameters()), "the initial parameters")
            if state.step >= cfg.trainer.max_steps:
                break
            # every rank reads the same stream and takes its rows
            rows = shard_batch(mesh, torch_batch(prepare_batch(cfg, batch), dev), cfg.train.grad_accum)
            logs = train_step(state, rows)
            gstep = step_cell["step"] = state.step
            if gstep % log_every == 0:
                logs = {k: float(v) for k, v in logs.items()}  # waits for the step
                dt = (time.time() - t_last) / log_every
                t_last = time.time()
                if writer:
                    msg = ", ".join(f"{k}={v:.4f}" for k, v in sorted(logs.items()))
                    print(f"step {gstep}: {msg} ({dt:.3f}s/it)", flush=True)
                    logger.log_scalars(gstep, {**logs, "perf/s_per_it": dt})
            if gstep % cfg.trainer.val_check_interval == 0:
                _run_validation(cfg, state, val_iter, gstep, logger, dev)
            if cfg.trainer.test_eval_interval > 0 and gstep % cfg.trainer.test_eval_interval == 0:
                _run_periodic_test_eval(cfg, state, gstep, logger, dev)
            if gstep % cfg.checkpointing.every_n_train_steps == 0:
                save_checkpoint(ckpt_dir, gstep, state, keep=cfg.checkpointing.save_top_k)
                last_saved = gstep
            if gstep >= cfg.trainer.max_steps:
                break
        if state is not None and state.step != last_saved:
            save_checkpoint(ckpt_dir, state.step, state, keep=cfg.checkpointing.save_top_k)
    finally:
        set_mesh(None)
        if logger is not None:
            logger.close()
    return state


@contextlib.contextmanager
def _evaluating(model: torch.nn.Module):
    """The model in eval() mode without autograd, back in train() after."""
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train()


def _make_val_iter(cfg: RootCfg):
    """Held-out val batches, one per validation, cycling through the val
    split (ValidationWrapper, validation_wrapper.py:7-32); None when there
    is no val split."""
    try:
        dataset = build_dataset(cfg, "val")
        loader_cfg = DataLoaderCfg(batch_size=1, seed=cfg.data_loader.seed)

        def gen():
            while True:
                yield from data_loader(dataset, loader_cfg, "val")

        return gen()
    except Exception as e:
        print(f"no validation split available ({e}); validation disabled")
        return None


def _run_validation(cfg: RootCfg, state: TrainState, val_iter, step: int, logger: LocalLogger | None,
                    device: torch.device) -> None:
    """One held-out val scene through the encoder (eval mode, the precision
    policy) and the decoder: ``val/psnr`` and a ground-truth / prediction
    panel (model_wrapper.py:634-773); a depth panel alone under
    train_depth_only. Every rank computes (the encoder's collectives need
    them all); the rank with the ``logger`` writes. A failure is printed:
    validation never ends training."""
    if val_iter is None:
        return
    try:
        batch = torch_batch(prepare_batch(cfg, next(val_iter)), device)
        with _evaluating(state.model):
            out = apply_with_precision(state.model, cfg.encoder.compute_dtype, batch["context"])
            if out["gaussians"] is None:  # depth-only: the depth panel
                if logger is not None:
                    d = out["depths"][-1].cpu().numpy()
                    logger.log_image(step, "val/depth", add_border(hcat(*(viz_depth(x) for x in d))))
                return
            tgt = batch["target"]
            h, w = tgt["image"].shape[2:4]
            dec = decode_splatting(
                cfg.decoder, out["gaussians"], tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], (h, w)
            )
            psnr = float(compute_psnr(tgt["image"].reshape(-1, h, w, 3), dec.color.reshape(-1, h, w, 3)).mean())
        if logger is None:
            return
        print(f"[val @ {step}] psnr={psnr:.3f}", flush=True)
        logger.log_scalars(step, {"val/psnr": psnr})
        gt_row = hcat(*tgt["image"][0].cpu().numpy())
        pr_row = hcat(*dec.color[0].cpu().numpy())
        logger.log_image(step, "val/comparison", add_border(vcat(gt_row, pr_row)))
    except Exception as e:  # validation must never kill training
        print(f"validation failed: {e!r}")


def _run_periodic_test_eval(cfg: RootCfg, state: TrainState, step: int, logger: LocalLogger | None,
                            device: torch.device) -> None:
    """``run_test`` over the first ``test_eval_max_scenes`` scenes of the
    test split with the current weights (model_wrapper.py:775-930), into
    ``output_dir/test_step{step}`` without images; its scores logged as
    ``test/*``. Every rank computes; the rank with the ``logger`` writes.
    A failure is printed: the evaluation never ends training."""
    try:
        loader = data_loader(
            build_dataset(cfg, "test"), DataLoaderCfg(batch_size=1, seed=cfg.data_loader.seed), "test"
        )
        batches = (
            {**b, **torch_batch(prepare_batch(cfg, b), device)}
            for b in itertools.islice(loader, cfg.trainer.test_eval_max_scenes)
        )
        test_cfg = dataclasses.replace(cfg.test, output_dir=Path(cfg.output_dir) / f"test_step{step}", save_image=False)
        with _evaluating(state.model):
            result = run_test(
                test_cfg, lambda context: apply_with_precision(state.model, cfg.encoder.compute_dtype, context),
                batches, decoder_cfg=cfg.decoder, lpips_fn=_eval_lpips_fn(cfg, state, device), device=device,
                write=logger is not None,
            )
        if logger is None:
            return
        print(f"[test eval @ {step}] {result['scores']}", flush=True)
        if result["scores"]:
            logger.log_scalars(step, {f"test/{k}": v for k, v in result["scores"].items()})
    except Exception as e:  # periodic eval must never kill training
        print(f"periodic test eval failed: {e!r}")


def _eval_lpips_fn(cfg: RootCfg, state: TrainState, device: torch.device):
    """LPIPS as an eval metric (metrics.py:22-35) when a weights file is
    configured: the state's frozen net if it has one, else one loaded from
    the file."""
    return state.lpips if state.lpips is not None else build_lpips(cfg.loss.lpips_weights, device)


def main(argv: list[str] | None = None) -> dict | TrainState | None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    if cfg.mode == "train":
        return train(cfg)
    return test(cfg)


if __name__ == "__main__":
    main()
