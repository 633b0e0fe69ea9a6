"""Device milliseconds a training step of every kernel that is not one of
the port's (``kernels/*.json``): cuDNN and cuBLAS, norms, elementwise,
Adam."""

from port_bench.readers import family_seconds


def read(rec):
    if rec["driver"] != "train":
        return None
    return 1e3 * family_seconds(rec, None) / rec["units"]
