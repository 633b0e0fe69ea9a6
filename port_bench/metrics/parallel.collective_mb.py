"""Megabytes a training step that rank 0's collectives move (inputs and
outputs, ``parallel.comm.COUNTERS``), over the trace run's untraced
steps."""


def read(rec):
    if rec["driver"] != "train" or not rec.get("mesh"):
        return None
    return rec["collective_bytes"] / rec["timed_units"] / 1e6
