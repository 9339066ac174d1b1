"""instances_per_view.serve: tile-gaussian instances a rendered target
view, what kernel A emits for the view's depth groups (render/expand.py):
the exact ``expand_tiles.instances`` over the traced window
(``launches["expand_instances"]``), over the views rendered."""


def read(record):
    instances = record.get("launches", {}).get("expand_instances")
    views = record.get("views", 0)
    return instances / views if instances and views else None
