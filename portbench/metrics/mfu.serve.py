"""mfu.serve: the network's matmul, convolution and attention FLOPs in the
traced window over its wall time over the card's peak for the
configuration's compute type (``bounds.peak_flops``), in %: the encoder's forward a
scene (FLOPs of the reference, counted by count_flops.py; the render's
composite has no matmul)."""


def read(record):
    flops, units = record.get("flops"), record.get("scenes", 0)
    if not flops or not units:
        return None
    from portbench.bounds import mfu_percent

    return mfu_percent(flops * units, record["window_s"], record["peak_flops"])
