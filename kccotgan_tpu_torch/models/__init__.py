"""Generator modules and layers of the PyTorch port."""

from .conv import same_conv
from .cuda_convlstm import convlstm_scan, convlstm_scan_reference
from .layers import ConvLSTM2D, ConvTranspose2D, LayerNorm
from .video import VideoDecoder, VideoEncoder, generator_modules

__all__ = [
    "ConvLSTM2D",
    "ConvTranspose2D",
    "LayerNorm",
    "VideoDecoder",
    "VideoEncoder",
    "convlstm_scan",
    "convlstm_scan_reference",
    "generator_modules",
    "same_conv",
]
