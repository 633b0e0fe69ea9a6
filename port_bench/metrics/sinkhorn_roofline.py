"""Share of its roofline of the Sinkhorn kernels in a training step,
forward and backward."""

from port_bench.readers import roofline_percent


def read(rec):
    return roofline_percent(rec, "sinkhorn") if rec["driver"] == "train" else None
