"""sweep_bwd_ms.train: device ms a step under the program's
``unimatch.sweep_bwd`` span (ops/grid_sample.py: the plane sweep's
backward, opened on autograd's thread; each chunk of pairs warped again
with an ``inv`` of its intrinsics, gathered and scattered per bilinear
tap), over every step of the traced window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "unimatch.sweep_bwd", "device_ms", "steps")
