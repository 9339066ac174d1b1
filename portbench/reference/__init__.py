"""The benchmark's plain reference: a frozen copy of the port's model, loss
and optimizer code in plain PyTorch.

Copied from ``my_depthsplat_torch`` (geometry, gaussians, models, ops,
parallel, render, train, utils) with every CUDA kernel call replaced by its
plain version: ``render/expand.py`` always runs ``expand_plain`` and
``render/pallas_raster.py`` always runs ``composite_plain``,
``composite_chained_plain``, ``composite_bwd_plain``,
``composite_bwd_chained_plain`` and ``scatter_reduce_plain``. It imports
neither JAX nor anything of ``my_depthsplat_torch``, so a later change to
the port does not move it: the yardstick stays where it was.
"""
