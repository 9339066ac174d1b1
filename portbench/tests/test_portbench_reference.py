"""The frozen reference against the port on the CPU at narrow widths, where
the port runs the same plain versions: the copy was frozen correctly when
both give the same encoder outputs, renders and training step."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import SERVE, TRAIN, narrow_cell
from portbench import sides, traffic
from portbench.kinds import serve as serve_kind
from portbench.kinds import train as train_kind


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_serves_as_the_port(dtype):
    """Encoder (depths and gaussians) and the targets' colours, reference vs
    port, in the configuration's precision policy and in float32."""
    from my_depthsplat_torch.models import EncoderDepthSplat, decode_splatting
    from my_depthsplat_torch.models.precision import apply_with_precision

    from portbench.reference.models import EncoderDepthSplat as RefEncoder
    from portbench.reference.models import decode_splatting as ref_decode
    from portbench.reference.models.precision import apply_with_precision as ref_apply

    cell = narrow_cell(SERVE)
    config = cell.config["config"]
    config["encoder"].update(compute_dtype=dtype, sweep_gather_dtype=dtype)
    shape = tuple(config["dataset"]["image_shape"])
    scene = traffic.serve_scenes(cell.mix, config["dataset"], 3, torch.device("cpu"))[0]
    pcfg, rcfg = sides.program_cfg(config), sides.reference_cfgs(config)
    assert dataclasses.asdict(pcfg.encoder) == dataclasses.asdict(rcfg["encoder"])
    side = {}
    for name, enc, dec, apply, dcfg in (
        ("port", EncoderDepthSplat(pcfg.encoder, device="cpu", seed=11), decode_splatting, apply_with_precision,
         pcfg.decoder),
        ("ref", RefEncoder(rcfg["encoder"], device="cpu", seed=11), ref_decode, ref_apply, rcfg["decoder"]),
    ):
        enc.eval().to(getattr(torch, dtype))
        s = sides.ServeSide(enc, dtype, dcfg, apply, dec)
        out = s.encode(scene["context"])
        side[name] = (out, s.decode(out["gaussians"], scene["target"], shape))
    values = serve_kind.compare(*side["port"], *side["ref"])
    assert all(v <= 1e-6 for v in values.values()), values


def test_reference_trains_as_the_port():
    """Three training steps from the same seed on the same batches: losses,
    the first gradient's leaf norms and the change's leaf norms agree."""
    cell = narrow_cell(TRAIN)
    config = cell.config["config"]
    batches = traffic.train_batches(cell.mix, config["dataset"], config["data_loader"]["batch_size"], 5,
                                    torch.device("cpu"))
    got = train_kind.follow(sides.train_program(config, 5, "cpu"), batches, 3)
    want = train_kind.follow(sides.train_reference(config, 5, "cpu"), batches, 3)
    values = train_kind.compare(got, want)
    # the reference batches the composite's tiles (float32 sums in another
    # order, ~1e-7): losses and gradients agree to rounding; AdamW's steps
    # are near sign(g) in a leaf's smallest entries, so the change carries
    # that rounding to a few 1e-5 of a leaf
    assert values["loss_rel"] <= 1e-6 and values["grad_leaf"] <= 1e-6, values
    assert values["change_leaf"] <= 1e-3, values
    assert len(got["grads"]) == len(want["grads"]) > 100


def _scene(seed: int, dense: bool, b: int = 2, g: int = 3000, shape=(48, 64)):
    """Screen gaussians of ``g`` seeded gaussians in front of ``b`` cameras:
    dense (sizable, opaque: pixels reach the stop) or sparse (thin, faint)."""
    from portbench.reference.geometry import get_fov
    from portbench.reference.render.camera import scale_invariant_normalization
    from portbench.reference.render.projection import project_gaussians

    gen = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(*s, generator=gen)  # noqa: E731
    z = u(2.0, 8.0, b, g)
    means = torch.stack([u(-0.55, 0.55, b, g) * z, u(-0.55, 0.55, b, g) * z, z], -1)
    lo, hi = (0.01, 0.08) if dense else (0.003, 0.02)
    rot = torch.linalg.qr(torch.randn(b, g, 3, 3, generator=gen))[0]
    cov = (rot * u(lo, hi, b, g, 3)[..., None, :] ** 2) @ rot.transpose(-1, -2)
    sh = torch.randn(b, g, 3, 9, generator=gen) * 0.3
    opac = u(0.3, 0.95, b, g) if dense else u(0.01, 0.05, b, g)
    extr = torch.eye(4).repeat(b, 1, 1)
    extr[:, 0, 3] = u(-0.2, 0.2, b)
    intr = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).repeat(b, 1, 1)
    e, _, _, m, c = scale_invariant_normalization(extr, torch.full((b,), 0.5), torch.full((b,), 100.0), means, cov)
    fov = get_fov(intr)
    return project_gaussians(e, m, c, sh, opac, torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), shape, True)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_batched_plain_composites_match_the_ports(dense):
    """The reference's plain composites, which take the tiles in batches,
    against the port's per-tile plain versions on one layout: image within
    float32 rounding, T and n_contrib equal, the backward's rows within
    1e-6 of the largest."""
    from my_depthsplat_torch.render import pallas_raster as port
    from my_depthsplat_torch.render.instances import build_tile_instances

    from portbench.reference.render import pallas_raster as ref

    shape = (48, 64)
    sg = _scene(3, dense, shape=shape)
    inst = build_tile_instances(sg, shape)
    rows = port.screen_rows(sg)
    bg = torch.rand(2, 3, generator=torch.Generator().manual_seed(1))
    args = (rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape)
    (img, t, n), (img_r, t_r, n_r) = port.composite_plain(*args), ref.composite_plain(*args)
    assert (img - img_r).abs().max() <= 1e-6 and torch.equal(t, t_r) and torch.equal(n, n_r)
    assert int(n.amax()) > 1
    g_img = torch.randn(2, *shape, 3, generator=torch.Generator().manual_seed(2))
    bargs = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, bg, t, n, g_img, shape)
    d, d_r = port.composite_bwd_plain(*bargs), ref.composite_bwd_plain(*bargs)
    assert (d - d_r).abs().max() <= 1e-6 * d.abs().max()
