"""Percent of the traced training window in which no operation ran on the
device."""

from port_bench.readers import idle_percent


def read(rec):
    return idle_percent(rec) if rec["driver"] == "train" else None
