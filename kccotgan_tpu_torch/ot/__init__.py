"""Causal-OT costs, Sinkhorn solvers and the martingale penalty of the
PyTorch port (counterpart of ``kccotgan_tpu/ot``)."""

from .cost import bi_causal_modified_cost, causal_penalty, cost_xy, modified_cost
from .cuda_sinkhorn import mixed_sinkhorn, sinkhorn_batch
from .martingale import delta_m, martingale_regularization
from .sinkhorn import (
    benchmark_sinkhorn,
    compute_sinkhorn,
    compute_sinkhorn_loss,
    flatten_video,
    sinkhorn_from_cost,
)

__all__ = [
    "benchmark_sinkhorn",
    "bi_causal_modified_cost",
    "causal_penalty",
    "compute_sinkhorn",
    "compute_sinkhorn_loss",
    "cost_xy",
    "delta_m",
    "flatten_video",
    "martingale_regularization",
    "mixed_sinkhorn",
    "modified_cost",
    "sinkhorn_batch",
    "sinkhorn_from_cost",
]
