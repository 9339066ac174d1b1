"""groups_per_view.serve: depth groups composited a rendered target view
(render/instances.py, render/expand.py bin them; the walk stops after the
first group that leaves no pixel live): the chained forward wrapper's
exact ``.launches`` over the window, over the views rendered."""


def read(record):
    launches = record.get("launches", {}).get("composite_chained", 0)
    views = record.get("views", 0)
    return launches / views if launches and views else None
