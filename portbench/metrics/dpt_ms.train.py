"""dpt_ms.train: device ms a step under the program's ``promptda.dpt``
span (models/promptda.py: the prompt-fused DPT head and the
de-normalisation), forward and backward (each backward node joined to the
span of the forward operation that made it), over every step of the traced
window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "promptda.dpt", "device_ms", "steps")
