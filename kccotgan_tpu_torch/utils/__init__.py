"""Run utilities: metrics logging, throughput, run notes, profiling, viz."""

from .logging import MetricsLogger, Throughput, write_run_notes
from .profiling import StepTimer, annotate, start_trace, stop_trace, trace
from .viz import display_frames, samples_to_video, save_low_d, save_video_gif, video_grid

__all__ = [
    "MetricsLogger",
    "StepTimer",
    "Throughput",
    "annotate",
    "display_frames",
    "samples_to_video",
    "save_low_d",
    "save_video_gif",
    "start_trace",
    "stop_trace",
    "trace",
    "video_grid",
    "write_run_notes",
]
