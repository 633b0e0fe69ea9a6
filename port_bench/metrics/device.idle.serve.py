"""Percent of the traced window in which no operation ran on the device,
its requests served back to back (so the idle time is the service's own,
not a wait for arrivals)."""

from port_bench.readers import idle_percent, kind


def read(rec):
    return idle_percent(rec) if kind(rec) == "serve" else None
