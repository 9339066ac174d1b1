"""The port's depth-group binning: tile-only sort keys against 64-bit keys.

A depth group hands kernel A its gaussians in depth-rank order, so kernel A
writes the tile index alone as the key (int16 up to 32767 tiles, else
int32), and a stable sort of those keys must give exactly the layout that
64-bit keys ``tile << 32 | slot`` give. CPU tensors: ``expand_tiles`` runs
``expand_plain``; tests/test_torch_kernels_cuda.py holds kernel A to the
same on the card. The layout's parity with the JAX package is
tests/test_torch_grouped.py::test_grouped_layout_matches_jax.
"""

import numpy as np
import pytest
import torch

from my_depthsplat_torch.render.expand import expand_plain, tile_key_dtype
from my_depthsplat_torch.render.instances import group_layout, grouped_expand_inputs
from my_depthsplat_torch.render.projection import project_gaussians

from test_torch_scenes import expansion_fields
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

_FIELDS = ("perm", "gaussian_id", "starts", "counts", "offset", "per_gaussian")


def _with_slots(args):
    """The same group's arguments with 64-bit keys (slots 0..n-1)."""
    return (*args[:5], torch.arange(args[0].shape[0]), *args[6:])


def _projected_groups(seed, g, shape, group_slots):
    """A seeded view through the projection (an eighth of it behind the
    camera: culled, sorted last) -> ``grouped_expand_inputs``' groups."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 8.0, (1, g))
    means = np.stack([rng.uniform(-0.3, 0.55, (1, g)) * z, rng.uniform(-0.55, 0.55, (1, g)) * z, z], -1)
    means[0, : g // 8, 2] = -1.0
    scales = rng.uniform(0.01, 0.15, (1, g, 3))
    rot = np.linalg.qr(rng.normal(size=(1, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    tan = torch.full((1,), 0.5)
    sg = project_gaussians(
        torch.eye(4)[None], t(means), t(cov), t(rng.normal(size=(1, g, 3, 9)) * 0.3),
        t(rng.uniform(0.3, 0.95, (1, g))), tan, tan, shape, True,
    )
    return grouped_expand_inputs(sg, shape, group_slots)[1]


def _synthetic_groups(seed, n, kind, group_slots, grid_hw=(20, 30)):
    """``expansion_fields`` cut into rank-ordered groups as
    ``grouped_expand_inputs`` cuts a view (no slots: tile-only keys)."""
    fields = expansion_fields(seed, n, grid_hw, kind)
    gy, gx = grid_hw
    return [
        (*(f[g0 : g0 + group_slots] for f in fields), None, min(group_slots, n - g0), gx, gy * gx)
        for g0 in range(0, n, group_slots)
    ]


@pytest.mark.parametrize(
    "case",
    [
        ("projected", lambda: _projected_groups(0, 500, (48, 64), 128), (48, 64)),
        ("mixed", lambda: _synthetic_groups(1, 700, "mixed", 256), (320, 480)),
        ("whole-grid", lambda: _synthetic_groups(2, 90, "whole-grid", 40), (320, 480)),
        ("one-tile", lambda: _synthetic_groups(3, 300, "one-tile", 128), (320, 480)),
    ],
    ids=lambda c: c[0],
)
def test_tile_key_layout_equals_64bit_layout(case):
    """Group by group: the layout from tile-only keys equals the one from
    64-bit keys field for field (dtypes included), and the tile-only keys
    are the 64-bit keys' high half. The groups are ragged at the end; the
    scenes hold empty tiles, conics that are not positive definite and
    invalid gaussians."""
    name, make, shape = case
    groups = make()
    assert groups[-1][0].shape[0] < groups[0][0].shape[0]  # a ragged last group
    empty_tiles, non_pd, invalid = 0, 0, 0
    for k, args in enumerate(groups):
        n_tiles = args[-1]
        first_rank = sum(a[0].shape[0] for a in groups[:k])
        got, want = group_layout(args, first_rank, shape), group_layout(_with_slots(args), first_rank, shape)
        for f in _FIELDS:
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f"{name}, group {k}: {f}"
        assert int(got.counts.sum()) == got.gaussian_id.numel()
        keys, _, _, _ = expand_plain(*args)
        keys64, _, _, _ = expand_plain(*_with_slots(args))
        assert keys.dtype == tile_key_dtype(n_tiles) == torch.int16
        assert torch.equal(keys.long(), keys64 >> 32)
        empty_tiles += int((got.counts == 0).sum())
        ca, cb, cc = args[1].unbind(-1)
        non_pd += int((args[4] & (ca * cc - cb * cb <= 0)).sum())
        invalid += int((~args[4]).sum())
    assert empty_tiles > 0
    assert invalid > 0 or name in ("whole-grid", "one-tile")
    assert non_pd > 0 or name != "mixed"


@pytest.mark.parametrize(
    "grid_hw,dtype",
    [((32, 60), torch.int16), ((217, 151), torch.int16), ((256, 128), torch.int32), ((1024, 1024), torch.int32)],
    ids=["1920", "32767", "32768", "1048576"],
)
def test_tile_key_dtype_follows_n_tiles(grid_hw, dtype):
    """int16 keys where every tile index fits (n_tiles <= 32767: 32x60
    tiles at 512x960), int32 beyond; the layout's run bounds follow in the
    key's own type and the layout equals the 64-bit-key one."""
    gy, gx = grid_hw
    n_tiles = gy * gx
    assert tile_key_dtype(n_tiles) == dtype
    xy, conic, opac, rect, valid = expansion_fields(4, 200, grid_hw, "mixed")
    args = (xy, conic, opac, rect, valid, None, 200, gx, n_tiles)
    keys, _, _, _ = expand_plain(*args)
    assert keys.dtype == dtype
    shape = (gy * 16, gx * 16)
    got, want = group_layout(args, 0, shape), group_layout(_with_slots(args), 0, shape)
    assert got.starts.shape == (n_tiles,) and got.gaussian_id.numel() > 0
    for f in _FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_tile_keys_take_one_view():
    """Tile-only keys carry no view index: a batch of views is refused."""
    xy, conic, opac, rect, valid = expansion_fields(5, 64, kind="mixed")
    with pytest.raises(ValueError, match="one view"):
        expand_plain(xy, conic, opac, rect, valid, None, 32, 30, 600)
