"""The encoder in window-sweep mode against the JAX package, with the
other options that no configuration reaches and that a two-scale encoder
exercises: wider UNet levels, raw regressor features, no intermediate
supervision, no depth output. The helpers and bounds of
test_torch_options.py."""

import numpy as np
import pytest
import torch

from my_depthsplat_torch.models import EncoderDepthSplat, EncoderDepthSplatCfg
from my_depthsplat_torch.models import unimatch as port_unimatch
from my_depthsplat_torch.ops import grid_sample

from test_torch_options import _cfg_kw, check_option
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import make_context, vitt  # noqa: F401

OPTIONS = {
    # name: (num_scales, views, training, overrides)
    "window_groups_unet_mult_no_intermediate": (
        2, 2, True,
        dict(sweep_mode="window", sweep_window_groups_scale0=4, costvolume_unet_channel_mult=(1, 2, 2),
             costvolume_unet_feat_dim=64, supervise_intermediate_depth=False),
    ),
    "window_narrow_raw_features_no_depth": (
        2, 2, False,
        dict(sweep_mode="window", sweep_window=2, sweep_window_groups_scale0=2, regressor_feature_channels=None,
             return_depth=False),
    ),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_window_option_matches_jax(vitt, name):  # noqa: F811
    """The window sweep at scale 0 (in groups of candidates) and at the
    refinement scale: the overflow comes back in both packages, 0 where the
    taps fit (window 6) and the same count where window 2 drops some. With
    it, channel_mult (1, 2, 2) at 64 channels (the UNet's levels 64, 128,
    128 and, at the second scale, 32, 64, 64, 32) in training without
    intermediate supervision (one prediction); and the raw 96-channel ViT
    features with no depth output."""
    check_option(vitt, name, OPTIONS)


def test_window_overflow_is_the_sum_of_the_sweeps(vitt, monkeypatch):  # noqa: F811
    """The encoder's overflow is the sum of the counts of its window-mode
    sweeps, each call of the function recorded: scale 0 in two groups, the
    refinement scale in one band."""
    ctx = make_context(np.random.default_rng(3), 1, 2)
    cfg = EncoderDepthSplatCfg(**_cfg_kw(vitt, 2, sweep_mode="window", sweep_window=2, sweep_window_groups_scale0=2))
    enc = EncoderDepthSplat(cfg, device="cpu", seed=3)
    counts = []
    real = grid_sample.plane_sweep_correlation_window

    def spy(*a, **kw):
        cost, overflow = real(*a, **kw)
        counts.append(int(overflow))
        return cost, overflow

    monkeypatch.setattr(port_unimatch, "plane_sweep_correlation_window", spy)
    with torch.no_grad():
        out = enc({k: torch.from_numpy(x) for k, x in ctx.items()})
    assert len(counts) == 2 + 1
    assert int(out["sweep_window_overflow"]) == sum(counts) > 0
