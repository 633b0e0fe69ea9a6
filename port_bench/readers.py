"""What the per-layer metric readers share: sums over the traced window's
device operations by kernel family, per unit of work (a training step or a
rollout).  A reader that finds nothing to read returns None."""

from __future__ import annotations

from .roofline import bound_s, rollout_work, train_work
from .trace import is_copy

__all__ = ["family_seconds", "idle_percent", "kind", "roofline_percent"]


def kind(rec: dict) -> str:
    """``train``, ``serve`` (requests on a fixed schedule) or ``sample``
    (a closed-loop job): which end-to-end metric a cell's layers move."""
    if rec["driver"] == "train":
        return "train"
    return "serve" if rec["traffic"].get("rate_per_s") else "sample"


def family_seconds(rec: dict, family) -> float:
    """Device seconds of the ops of ``family`` (None: ops of no family,
    kernels only) in the traced window."""
    of = rec["family_of"]
    return sum(dur for name, _, dur in rec["trace"]["ops"]
               if of(name) == family and not (family is None and is_copy(name))) / 1e6


def roofline_percent(rec: dict, family: str):
    """100 x the least time of the family's required work over the
    family's device time, or None if none of its kernels ran.  On a data
    mesh the traced rank runs its share of the rows, and the Sinkhorn on
    the gathered global batch in the exact mode."""
    spent = family_seconds(rec, family)
    if spent <= 0:
        return None
    if kind(rec) == "train":
        ranks = rec.get("ranks", 1)
        rows = rec["batch"] // ranks
        work = train_work(rec["cfg"], rows, rec["batch"] if rec["cfg"]["global_batch_sinkhorn"] else rows)
    else:
        work = rollout_work(rec["cfg"], rec["batch"])
    ops, nbytes, peak = work[family]
    return 100.0 * bound_s(ops, nbytes, peak) * rec["units"] / spent


def idle_percent(rec: dict) -> float:
    w0, w1 = rec["trace"]["window_us"]
    return 100.0 * (1.0 - rec["trace"]["busy_us"] / (w1 - w0))
