"""The two sides of a cell: the program under test (``my_depthsplat_torch``,
built as its CLI builds it) and the plain reference (``portbench.reference``,
the frozen copy), each from a configuration file's ``config`` section and a
seed. The reference never sees what the program made: it draws its own
weights from the same seed with its own copy of the initialisers.

Serving (``main.test`` / ``eval/runner.run_test``): the encoder built from
the seed, cast once to ``encoder.compute_dtype`` and run under
``apply_with_precision``; then ``decode_splatting`` of the target views.
Training (``main.train``): ``make_train_step``'s ``init_fn(seed)`` and
``train_step``, with a seeded LPIPS (no weights file is in the repository).
"""

from __future__ import annotations

import dataclasses
import json
import math
import typing

import numpy as np
import torch


def weight_seeds(seed: int) -> tuple[int, int]:
    """The encoder's and LPIPS's weight seeds, drawn from ``seed``."""
    a, b = np.random.default_rng([seed % 2**64, 1]).integers(0, 2**62, 2)
    return int(a), int(b)


def program_cfg(config: dict):
    """The port's RootCfg from a configuration's ``config`` section, through
    the port's own loader (each top-level group an override)."""
    from my_depthsplat_torch.config import load_config

    return load_config(None, [f"{k}={json.dumps(v)}" for k, v in config.items()])


def _build(cls, data: dict):
    """A (frozen) dataclass of the reference from a dict: nested dataclasses
    built in turn, lists made tuples; missing keys keep their defaults."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value, typ = data[f.name], hints[f.name]
        if dataclasses.is_dataclass(typ):
            value = _build(typ, value or {})
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def reference_cfgs(config: dict, **encoder_overrides) -> dict:
    """The reference's encoder, decoder, loss, optimizer and training
    configurations from the same section."""
    from .reference.models import DecoderSplattingCfg, EncoderDepthSplatCfg
    from .reference.train import LossCfg, OptimizerCfg, TrainCfg

    enc = _build(EncoderDepthSplatCfg, {**config.get("encoder", {}), **encoder_overrides})
    dec = _build(DecoderSplattingCfg, config.get("decoder", {}))
    loss = _build(LossCfg, config.get("loss", {}))
    opt = _build(OptimizerCfg, config.get("optimizer", {}))
    train = config.get("train", {})
    return {
        "encoder": enc, "decoder": dec, "loss": loss, "optimizer": opt,
        "train": TrainCfg(encoder=enc, decoder=dec, loss=loss, optimizer=opt,
                          depth_mode=train.get("depth_mode"), grad_accum=train.get("grad_accum", 1)),
    }


class ServeSide:
    """An encoder and a decoder behind ``encode(context)`` and
    ``decode(gaussians, target, shape) -> colours (B, V, H, W, 3)``."""

    def __init__(self, encoder, compute_dtype, decoder_cfg, apply_with_precision, decode_splatting):
        self.encoder, self.compute_dtype, self.decoder_cfg = encoder, compute_dtype, decoder_cfg
        self._apply, self._decode = apply_with_precision, decode_splatting

    @torch.no_grad()
    def encode(self, context: dict) -> dict:
        return self._apply(self.encoder, self.compute_dtype, context)

    @torch.no_grad()
    def decode(self, gaussians, target: dict, shape) -> torch.Tensor:
        return self._decode(
            self.decoder_cfg, gaussians, target["extrinsics"], target["intrinsics"],
            target["near"], target["far"], tuple(shape),
        ).color


def serve_program(config: dict, seed: int, device) -> ServeSide:
    from my_depthsplat_torch.models import EncoderDepthSplat, decode_splatting
    from my_depthsplat_torch.models.precision import apply_with_precision, resolve_dtype

    cfg = program_cfg(config)
    encoder = EncoderDepthSplat(cfg.encoder, device=device, seed=weight_seeds(seed)[0]).eval()
    encoder.to(resolve_dtype(cfg.encoder.compute_dtype))
    return ServeSide(encoder, cfg.encoder.compute_dtype, cfg.decoder, apply_with_precision, decode_splatting)


def serve_reference(config: dict, seed: int, device, precision: str = "float32") -> ServeSide:
    """The reference's serving path. ``precision`` "float32": the network
    and the plane sweep's gathers in float32. "fp8" (the control): the
    configuration's bf16 policy with every matmul's and convolution's
    operands rounded to float8 e4m3 (``reference.lowp``)."""
    from .reference.models import EncoderDepthSplat, decode_splatting
    from .reference.models.precision import apply_with_precision

    over = {"compute_dtype": "float32", "sweep_gather_dtype": "float32"} if precision == "float32" else {}
    cfgs = reference_cfgs(config, **over)
    encoder = EncoderDepthSplat(cfgs["encoder"], device=device, seed=weight_seeds(seed)[0]).eval()
    dtype = cfgs["encoder"].compute_dtype
    if precision == "fp8":
        from .reference.lowp import fp8_matmuls

        encoder.to(torch.bfloat16)

        def apply(model, _dtype, context):
            with fp8_matmuls():
                return apply_with_precision(model, "bfloat16", context)

        return ServeSide(encoder, dtype, cfgs["decoder"], apply, decode_splatting)
    return ServeSide(encoder, dtype, cfgs["decoder"], apply_with_precision, decode_splatting)


class TrainSide:
    """A training state behind ``step(batch) -> logs``, the parameters by
    name, and the first gradient as the optimizer holds it."""

    def __init__(self, state, train_step):
        self.state, self._step = state, train_step

    def step(self, batch: dict) -> dict:
        return self._step(self.state, batch)

    def named_parameters(self) -> dict[str, torch.Tensor]:
        return {n: p for n, p in self.state.model.named_parameters() if p.requires_grad}

    def first_gradient_norms(self) -> dict[str, float]:
        """Each leaf's norm of the gradient the optimizer took at its first
        step, from its state after that step: AdamW's first moment is then
        (1 - beta1) g."""
        opt = self.state.optimizer
        out = {}
        for n, p in self.named_parameters().items():
            st = opt.state.get(p, {})
            beta1 = next(g["betas"][0] for g in opt.param_groups if any(q is p for q in g["params"]))
            m = st.get("exp_avg")
            out[n] = math.nan if m is None else torch.linalg.vector_norm(m.double()).item() / (1.0 - beta1)
        return out


def train_program(config: dict, seed: int, device) -> TrainSide:
    from my_depthsplat_torch.train import LPIPS, TrainCfg, make_train_step

    cfg = program_cfg(config)
    enc_seed, lpips_seed = weight_seeds(seed)
    tcfg = TrainCfg(
        encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss, optimizer=cfg.optimizer,
        depth_mode=cfg.train.depth_mode, grad_accum=cfg.train.grad_accum,
    )
    lpips = LPIPS(seed=lpips_seed) if cfg.loss.lpips_weight > 0 else None
    init_fn, train_step = make_train_step(tcfg, lpips=lpips, device=device)
    return TrainSide(init_fn(enc_seed), train_step)


def train_reference(config: dict, seed: int, device) -> TrainSide:
    from .reference.train import LPIPS, make_train_step

    cfgs = reference_cfgs(config)
    enc_seed, lpips_seed = weight_seeds(seed)
    lpips = LPIPS(seed=lpips_seed) if cfgs["loss"].lpips_weight > 0 else None
    init_fn, train_step = make_train_step(cfgs["train"], lpips=lpips, device=device)
    return TrainSide(init_fn(enc_seed), train_step)

