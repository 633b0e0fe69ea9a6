"""Percent of the traced window of a closed-loop sampling job in which no
operation ran on the device."""

from port_bench.readers import idle_percent, kind


def read(rec):
    return idle_percent(rec) if kind(rec) == "sample" else None
