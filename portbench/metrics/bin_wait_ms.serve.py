"""bin_wait_ms.serve: idle device ms a target view in the gaps opened
under the program's ``render.bin`` span: the stalls of each group's host
read of kernel A's instance total (render/expand.py), over every view of
the traced window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "render.bin", "idle_ms", "views")
