"""Run utilities: metrics logging, throughput, run notes, profiling, viz."""

from .logging import MetricsLogger, Throughput, write_run_notes
from .profiling import start_trace, stop_trace
from .viz import display_frames, samples_to_video, save_low_d, save_video_gif, video_grid

__all__ = [
    "MetricsLogger",
    "Throughput",
    "display_frames",
    "samples_to_video",
    "save_low_d",
    "save_video_gif",
    "start_trace",
    "stop_trace",
    "video_grid",
    "write_run_notes",
]
