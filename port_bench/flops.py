"""Model FLOPs of a training step and of a rollout: the convolutions' and
matrix products' FLOPs that ``torch.utils.flop_counter`` counts over the
plain reference, run on the meta device at the cell's shapes (forward and
backward, no recomputation).  They depend on the shapes alone, so they
are the same whatever implements the step.  The Sinkhorn's dual updates
hold no product the counter counts, so the step is counted with one
update (``sinkhorn_l=1``) and the same result."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["rollout_flops", "train_step_flops"]


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _params(ref, cfg, groups, device):
    gen = ref.gen_spec(cfg)
    disc, bns = ref.disc_spec(cfg)
    spec = {"enc": gen["encoder"], "dec": gen["decoder"], "h": disc, "m": disc}
    params = {g: {k: torch.zeros(shape, device=device) for k, shape, *_ in spec[g]} for g in groups}
    return params, bns


def train_step_flops(ref, cfg: dict, b: int) -> int:
    """FLOPs of one training step of the reference at batch ``b``."""
    dev = torch.device("meta")
    params, bns = _params(ref, cfg, ("enc", "dec", "h", "m"), dev)
    stats = {g: ref.init_stats(bns, dev) for g in ("h", "m")}
    m = cfg["model"]
    tp = cfg["total_time_steps"] - cfg["int_time_steps"]
    real = torch.zeros(b, m["x_height"], cfg["total_time_steps"], m["x_width"], m["n_channels"], device=dev)
    z = torch.zeros(b, tp, m["z_height"], m["z_width"], m["z_channels"], device=dev)
    state = ref.train_state(params, stats)
    cfg = {**cfg, "sinkhorn_l": 1}
    return _count(lambda: ref.train_step(cfg, state, real, z, z, ref.Precision(cfg["compute_dtype"])))


def rollout_flops(ref, cfg: dict, b: int) -> int:
    """FLOPs of one rollout of the reference at batch ``b``."""
    dev = torch.device("meta")
    params, _ = _params(ref, cfg, ("enc", "dec"), dev)
    m = cfg["model"]
    tp = cfg["total_time_steps"] - cfg["int_time_steps"]
    ctx = torch.zeros(b, m["x_height"], cfg["int_time_steps"], m["x_width"], m["n_channels"], device=dev)
    z = torch.zeros(tp, b, 1, m["z_height"], m["z_width"], m["z_channels"], device=dev)
    gen = {"encoder": params["enc"], "decoder": params["dec"]}
    with torch.no_grad():
        return _count(lambda: ref.rollout(cfg, gen, ctx, z, ref.Precision(cfg["compute_dtype"])))
