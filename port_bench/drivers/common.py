"""What the drivers share: the weights made from the seed, the rows of a
batch, and the host ranges that name the trace's idle gaps."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..spec import sub_seed

__all__ = ["make_weights", "ranges", "rows_of", "sync"]


def make_weights(ref, cfg: dict, seed: int, device, groups) -> tuple[dict, dict]:
    """``(params, stats)``: the parameter groups ``groups`` (of ``enc``,
    ``dec``, ``h``, ``m``) drawn on ``device`` from a generator on it, in
    one uniform draw (``reference.init_params``), and fresh BatchNorm
    statistics for the discriminators among them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    g_spec = ref.gen_spec(cfg)
    d_spec, bns = ref.disc_spec(cfg)
    spec = {"enc": g_spec["encoder"], "dec": g_spec["decoder"], "h": d_spec, "m": d_spec}
    params = ref.init_params({g: spec[g] for g in groups}, gen, device)
    stats = {g: ref.init_stats(bns, device) for g in groups if g in ("h", "m")}
    return params, stats


def rows_of(order: np.ndarray, i: int, b: int) -> np.ndarray:
    """The rows of the ``i``-th batch of ``b``: the seeded order, cycled."""
    return order[(i * b + np.arange(b)) % len(order)]


def ranges(on: bool):
    """``range(name)``: a ``record_function`` range when tracing, else
    nothing."""
    if on:
        return torch.profiler.record_function
    return lambda name: contextlib.nullcontext()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
