"""regressor_ms.serve: device ms a scene under the program's
``unimatch.regressor`` span (models/unimatch.py: each scale's
concatenation, UNet regressor and residual, depth head, softmax and
expectation), over every scene of the traced window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "unimatch.regressor", "device_ms", "scenes")
