"""bin_ms.serve: device ms a target view under the program's
``render.bin`` span (render/pallas_raster.py: the grouped layout's depth
sort and gathers, and each group's kernel A passes, key sort and run
bounds), over every view of the traced window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "render.bin", "device_ms", "views")
