"""composite_bwd_roofline.train: kernels C and D together (the flat
composite backward, csrc/composite_bwd.cu, and the per-gaussian sum,
csrc/scatter_reduce.cu) against their roofline in the traced window's first
step: the least time the card could take for them
(``kinds/train.backward_bound_ms``: C's bytes, evaluations and gated hits
and D's rows, worked out by the reference on the program's gaussians of
that step's batch under the weights it starts from, before the window)
over their device time in that step (each kernel's first run in the
profiler's trace), in %. The gaussians move as the model trains (the last
step of a 30 s window read 16.6-55.4 % on three seeds), so one step's
bound is held against the same step's time, at a state every run of a
seed reaches alike."""


def _c_or_d(name):
    return ("composite_bwd_kernel<false>" in name or "composite_bwd_kernelILb0E" in name
            or "scatter_reduce_kernel" in name)


def read(record):
    from portbench.harness import device_seconds

    spent = device_seconds(record.get("trace", {}), _c_or_d, "first_s")
    bound_ms = record.get("composite_bwd_bound_ms")
    if not spent or bound_ms is None:
        return None
    return bound_ms / (spent * 1e3) * 100.0
