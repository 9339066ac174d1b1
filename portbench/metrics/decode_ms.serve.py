"""decode_ms.serve: ms of ``decode_splatting`` a target view, the
benchmark's span around the call (both targets of a scene in one call),
host clock ending in a synchronise, over every view of the traced window."""


def read(record):
    total, n = record.get("spans", {}).get("decode", (0.0, 0))
    views = record.get("views", 0)
    return total / views * 1e3 if n and views else None
