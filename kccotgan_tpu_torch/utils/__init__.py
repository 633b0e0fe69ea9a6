"""Run utilities: metrics logging, throughput, run notes."""

from .logging import MetricsLogger, Throughput, write_run_notes

__all__ = ["MetricsLogger", "Throughput", "write_run_notes"]
