"""composite_fwd_roofline.serve: row 3 (the chained forward composite,
csrc/composite_fwd.cu's CHAINED instantiation) against its roofline: the
least time the card could take for the window's groups
(``kinds/serve.chained_bound_ms``: bytes, evaluations and gated hits that
the reference works out on the program's gaussians and views) over the
kernel's device time in the profiler's trace, in %."""


def _row3(name):
    return "composite_fwd_kernel<true>" in name or "composite_fwd_kernelILb1E" in name


def read(record):
    from portbench.harness import device_seconds

    spent = device_seconds(record.get("trace", {}), _row3)
    bound_ms = record.get("composite_fwd_bound_ms")
    if not spent or bound_ms is None:
        return None
    return bound_ms / (spent * 1e3) * 100.0
