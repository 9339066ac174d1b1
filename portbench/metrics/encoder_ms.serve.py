"""encoder_ms.serve: ms of the encoder call a scene (models/encoder.py under
models/precision.py), the benchmark's span around the call, host clock
ending in a synchronise, over every scene of the traced window."""


def read(record):
    total, n = record.get("spans", {}).get("encoder", (0.0, 0))
    return total / n * 1e3 if n else None
