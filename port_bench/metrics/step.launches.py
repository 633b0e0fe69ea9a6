"""Device kernels and copies a training step, from the trace."""


def read(rec):
    if rec["driver"] != "train":
        return None
    return len(rec["trace"]["ops"]) / rec["units"]
