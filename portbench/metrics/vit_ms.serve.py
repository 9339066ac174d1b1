"""vit_ms.serve: device ms a scene under the program's ``unimatch.vit``
span (models/unimatch.py: the resize to a multiple of 14, the ViT-B, the
resizes of its maps to 1/8 and the mono pyramid), over every scene of the
traced window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "unimatch.vit", "device_ms", "scenes")
