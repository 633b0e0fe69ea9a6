"""Serving path of the PyTorch port."""

from .rollout import build_rollout

__all__ = ["build_rollout"]
