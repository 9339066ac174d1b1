"""vit_ms.train: device ms a step under the program's ``unimatch.vit``
span (models/unimatch.py: the resize to a multiple of 14, the DINOv2 ViT,
the resizes of its maps to 1/8 and the mono pyramid), forward and backward
(each backward node joined to the span of the forward operation that made
it), over every step of the traced window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "unimatch.vit", "device_ms", "steps")
