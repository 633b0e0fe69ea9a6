"""Generator and discriminator modules and layers of the PyTorch port."""

from .conv import same_conv
from .cuda_convlstm import convlstm_scan, convlstm_scan_reference
from .layers import LSTM, BatchNorm, Conv2D, ConvLSTM2D, ConvTranspose2D, LayerNorm, leaky_relu
from .video import (
    VideoDecoder,
    VideoDiscriminator,
    VideoEncoder,
    discriminator_modules,
    generator_modules,
)

__all__ = [
    "LSTM",
    "BatchNorm",
    "Conv2D",
    "ConvLSTM2D",
    "ConvTranspose2D",
    "LayerNorm",
    "VideoDecoder",
    "VideoDiscriminator",
    "VideoEncoder",
    "convlstm_scan",
    "convlstm_scan_reference",
    "discriminator_modules",
    "generator_modules",
    "leaky_relu",
    "same_conv",
]
