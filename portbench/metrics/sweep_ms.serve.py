"""sweep_ms.serve: device ms a scene under the program's
``unimatch.sweep`` span (models/unimatch.py: the relative poses, and each
scale's candidates, source-view gather, plane-sweep correlation and cost
mean), over every scene of the traced window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "unimatch.sweep", "device_ms", "scenes")
