"""lpips_ms.train: device ms a step under the program's ``loss.lpips``
span (train/losses.py: the LPIPS network on the rendered and target views),
forward and backward (each backward node joined to the span of the forward
operation that made it), over every step of the traced window
(portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "loss.lpips", "device_ms", "steps")
