"""KCCOT-GAN in PyTorch: ConvLSTM context encoder, U-Net ConvLSTM
decoder (teacher-forcing training path and single-frame inference path)
and the per-frame CNN + LSTM video discriminator.

Counterparts of ``VideoEncoder``, ``VideoDecoder`` and
``VideoDiscriminator`` in ``kccotgan_tpu/models/video.py``, with the same
submodule and parameter names (``encoder1``, ``norm1``,
``conv_transpose1``, ``decoder2_norm``, ``conv1``, ``bn1``, ``lstm1``,
``rnn_bn1``, ...) so flax parameter trees map onto ``state_dict`` keys by
joining the path with dots.  Videos are film-strips ``[B, H, T, W, C]`` at
the boundaries; pyramid levels are ``[B, T, h, w, c]``.  ``plain=True``
sends every ConvLSTM / LSTM recurrence to its plain loop instead of the
fused recurrence (``layers.py``); ``generator_modules`` and
``discriminator_modules`` set it from ``cfg.kernel_impl``.  For the
meshes: ``seq_axis`` (a process group) makes every generator ConvLSTM a
ring relay over the group's ranks, each holding a chunk of the frames
(``parallel/seqmodel.py``), and ``bn_group`` takes every discriminator
BatchNorm's statistics over the group's ranks, each holding some of the
batch's rows.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import LSTM, BatchNorm, Conv2D, ConvLSTM2D, ConvTranspose2D, LayerNorm, leaky_relu

__all__ = [
    "VideoDecoder",
    "VideoDiscriminator",
    "VideoEncoder",
    "discriminator_modules",
    "generator_modules",
]

_LN_EPS = 1e-3  # Keras LayerNormalization default


class VideoEncoder(nn.Module):
    """ConvLSTM feature pyramid: filters f*4..f*32, kernels 6, 6, 5, 5,
    all stride 2, no bias, optional LayerNorm after each level."""

    def __init__(
        self,
        int_time_steps: int,
        n_channels: int,
        filter_size: int = 8,
        use_norm: bool = False,
        dropout: float = 0.0,
        rnn_dropout: float = 0.0,
        compute_dtype: str = "float32",
        plain: bool = False,
        seq_axis=None,
    ):
        super().__init__()
        self.int_time_steps = int_time_steps
        self.use_norm = use_norm
        f = filter_size
        c_in = n_channels
        for i, (filters, k) in enumerate([(f * 4, 6), (f * 8, 6), (f * 16, 5), (f * 32, 5)]):
            self.add_module(f"encoder{i + 1}", ConvLSTM2D(
                c_in, filters, (k, k), strides=(2, 2), use_bias=False,
                compute_dtype=compute_dtype, dropout=dropout,
                recurrent_dropout=rnn_dropout, plain=plain, seq_axis=seq_axis, name=f"encoder{i + 1}",
            ))
            if use_norm:
                self.add_module(f"norm{i + 1}", LayerNorm(filters, _LN_EPS))
            c_in = filters

    def forward(self, video, carry=None, return_carry=False, slice_time=True, training=False, masks=None):
        """Encode ``video [B, H, T, W, C]``.

        Returns the 5-level pyramid (raw input and the four ConvLSTM
        outputs), each sliced to ``[:, Tc-1:]`` unless ``slice_time`` is
        False.  ``carry`` / ``return_carry`` thread the four ``(h, c)``
        states so a rollout extends the encoding one frame at a time.
        ``training`` turns the ConvLSTMs' dropout on, drawn from the mask
        source ``masks`` layer by layer in forward order.
        """
        x = video.permute(0, 2, 1, 3, 4)  # -> [B, T, H, W, C]
        tc = self.int_time_steps if slice_time else 1
        pyramid = [x[:, tc - 1 :]]
        h = x
        new_carry = []
        for i in range(4):
            h, state = getattr(self, f"encoder{i + 1}")(
                h, initial_state=None if carry is None else carry[i], training=training, masks=masks
            )
            new_carry.append(state)
            if self.use_norm:
                h = getattr(self, f"norm{i + 1}")(h)
            pyramid.append(h[:, tc - 1 :])
        if return_carry:
            return pyramid, tuple(new_carry)
        return pyramid


def _decoder_geometry(x_height: int, x_width: int):
    """(kernel, stride) of the ConvTranspose stages per aspect ratio."""
    if x_height == x_width:
        return dict(k1=(2, 2), s1=(2, 2), k2=(4, 4), s2=(2, 2), k3=(6, 6), s3=(2, 2))
    if x_height < x_width:
        return dict(k1=(6, 7), s1=(2, 2), k2=(6, 7), s2=(2, 2), k3=(6, 7), s3=(2, 2))
    return dict(k1=(7, 6), s1=(3, 2), k2=(7, 6), s2=(3, 2), k3=(7, 6), s3=(3, 2))


class VideoDecoder(nn.Module):
    """U-Net ConvLSTM decoder.

    ``forward(pyramid, z, training=False, masks=None, pre_sliced=False)``
    takes the encoder's 5-level pyramid and noise ``z [B, T_z, h4, w4,
    z_channels]`` and returns frames ``[B, H, T_z, W, C]``.  Training
    (teacher forcing) consumes the skip frames ``[:, :-1]``, so ``T_z`` is
    the pyramid's time minus one, and turns the ConvLSTMs' dropout on,
    drawn from the mask source ``masks``; inference consumes the last
    frame's features only, with ``T_z = 1``.  ``pre_sliced``: the pyramid
    holds the skip frames already (the time-sharded decode slices in
    global time, ``parallel/seqmodel.py``).
    """

    def __init__(
        self,
        x_height: int,
        x_width: int,
        nchannel: int = 1,
        filter_size: int = 8,
        z_channels: int = 128,
        use_norm: bool = False,
        dropout: float = 0.0,
        rnn_dropout: float = 0.0,
        output_activation: str = "sigmoid",
        compute_dtype: str = "float32",
        plain: bool = False,
        seq_axis=None,
    ):
        super().__init__()
        f = filter_size
        g = _decoder_geometry(x_height, x_width)
        self.x_height, self.x_width, self.nchannel = x_height, x_width, nchannel
        self.use_norm = use_norm

        def convlstm(c_in, filters, k, bias, name):
            return ConvLSTM2D(
                c_in, filters, k, use_bias=bias, compute_dtype=compute_dtype,
                dropout=dropout, recurrent_dropout=rnn_dropout, plain=plain, seq_axis=seq_axis, name=name,
            )

        def conv_t(c_in, filters, k, s, act="tanh"):
            return ConvTranspose2D(
                c_in, filters, k, s, activation=act, compute_dtype=compute_dtype
            )

        def norm(name, features):
            if use_norm:
                self.add_module(name, LayerNorm(features, _LN_EPS))

        self.conv_transpose1 = conv_t(f * 32 + z_channels, f * 32, g["k1"], g["s1"])
        norm("conv_norm1", f * 32)
        # (skip level, skip channels, convlstm filters/kernel/bias, convT filters/kernel/stride)
        self.stages = [
            (3, f * 16, (f * 16, (4, 4), False), (f * 16, g["k2"], g["s2"]), "decoder2", "conv_transpose2"),
            (2, f * 8, (f * 8, (6, 6), False), (f * 8, g["k3"], g["s3"]), "decoder3", "conv_transpose3"),
            (1, f * 4, (f * 4, (8, 8), True), (f * 2, g["k3"], g["s3"]), "decoder4", "conv_transpose4"),
        ]
        c = f * 32
        for _, skip_c, (cf, ck, cb), (tf_, tk, ts), dec_name, ct_name in self.stages:
            self.add_module(dec_name, convlstm(skip_c + c, cf, ck, cb, dec_name))
            norm(dec_name + "_norm", cf)
            self.add_module(ct_name, conv_t(cf, tf_, tk, ts))
            norm(ct_name + "_norm", tf_)
            c = tf_
        self.decoder5 = convlstm(nchannel + c, f, (8, 8), True, "decoder5")
        norm("decoder5_norm", f)
        self.conv_transpose5 = conv_t(f, nchannel, (8, 8), (1, 1), output_activation)

    def _norm(self, h, name):
        return getattr(self, name)(h) if self.use_norm else h

    def forward(self, pyramid, z, training=False, masks=None, pre_sliced=False):
        b, t = z.shape[0], z.shape[1]

        def skip(level):
            if pre_sliced:
                return pyramid[level]
            return pyramid[level][:, :-1] if training else pyramid[level][:, -1:]

        def fold(seq):  # [B, T, h, w, c] -> [B*T, h, w, c]
            return seq.reshape((b * t,) + tuple(seq.shape[2:]))

        def unfold(frames):  # [B*T, h, w, c] -> [B, T, h, w, c]
            return frames.reshape((b, t) + tuple(frames.shape[1:]))

        h = self.conv_transpose1(fold(torch.cat([skip(4), z], dim=-1)))
        h = self._norm(h, "conv_norm1")
        for level, _, _, _, dec_name, ct_name in self.stages:
            h = torch.cat([skip(level), unfold(h)], dim=-1)
            h, _ = getattr(self, dec_name)(h, training=training, masks=masks)
            h = self._norm(h, dec_name + "_norm")
            h = getattr(self, ct_name)(fold(h))
            h = self._norm(h, ct_name + "_norm")
        h = torch.cat([skip(0), unfold(h)], dim=-1)
        h, _ = self.decoder5(h, training=training, masks=masks)
        h = self._norm(h, "decoder5_norm")
        y = self.conv_transpose5(fold(h))
        y = y.reshape(b, t, self.x_height, self.x_width, self.nchannel)
        return y.permute(0, 2, 1, 3, 4)  # film-strip [B, H, T, W, C]


def _plain(cfg) -> bool:
    """``kernel_impl`` 'scan' (and 'auto', which resolves to it) runs the
    plain loops; 'pallas' the fused recurrences."""
    return cfg.kernel_impl != "pallas"


def generator_modules(cfg, seq_axis=None):
    """The ``(VideoEncoder, VideoDecoder)`` pair a ``TrainConfig``
    describes, created on the current default device; ``seq_axis`` as in
    the module docstring."""
    m = cfg.model
    common = dict(
        filter_size=m.g_filter_size, use_norm=m.use_norm, dropout=m.dropout,
        rnn_dropout=m.rnn_dropout, compute_dtype=cfg.compute_dtype, plain=_plain(cfg), seq_axis=seq_axis,
    )
    encoder = VideoEncoder(cfg.int_time_steps, m.n_channels, **common)
    decoder = VideoDecoder(
        m.x_height, m.x_width, nchannel=m.n_channels, z_channels=m.z_channels,
        output_activation=m.output_activation, **common,
    )
    return encoder, decoder


class VideoDiscriminator(nn.Module):
    """Per-frame CNN (three 5x5 stride-2 Conv2D, f*4, f*8, f*16, optional
    BatchNorm, LeakyReLU 0.3) then three LSTMs (f*8, f*4, then
    ``state_size`` sigmoid units, BatchNorm between them) ->
    ``[B, T, state_size]``.

    ``forward(video, stats)`` runs in training mode: every BatchNorm
    normalizes by its batch and ``stats`` (``{"bn1.mean": ..., "bn1.var":
    ..., "rnn_bn2.var": ...}``, the flax ``batch_stats`` paths joined by
    dots) comes back updated as ``(out, new_stats)``.  With
    ``training=False`` every BatchNorm normalizes by the running
    ``stats``, which come back unchanged.  Each frame's conv
    output is flattened in NHWC order, as in the JAX package, so lstm1's
    kernel rows line up.
    """

    def __init__(
        self,
        x_height: int,
        x_width: int,
        n_channels: int = 1,
        state_size: int = 8,
        filter_size: int = 8,
        use_batch_norm: bool = False,
        compute_dtype: str = "float32",
        plain: bool = False,
        bn_group=None,
    ):
        super().__init__()
        f = filter_size
        self.use_batch_norm = use_batch_norm
        self.bn_group = bn_group
        c_in, h, w = n_channels, x_height, x_width
        for i, filters in enumerate((f * 4, f * 8, f * 16)):
            self.add_module(f"conv{i + 1}", Conv2D(
                c_in, filters, (5, 5), strides=(2, 2), compute_dtype=compute_dtype
            ))
            if use_batch_norm:
                self.add_module(f"bn{i + 1}", BatchNorm(filters, bn_group))
            c_in, h, w = filters, -(-h // 2), -(-w // 2)
        common = dict(compute_dtype=compute_dtype, plain=plain)
        self.lstm1 = LSTM(h * w * c_in, f * 8, **common)
        self.lstm2 = LSTM(f * 8, f * 4, **common)
        self.lstm3 = LSTM(f * 4, state_size, activation="sigmoid", **common)
        if use_batch_norm:
            self.rnn_bn1 = BatchNorm(f * 8, bn_group)
            self.rnn_bn2 = BatchNorm(f * 4, bn_group)

    def init_stats(self) -> dict:
        """Fresh running statistics: means 0, variances 1 (as flax)."""
        stats = {}
        for name, module in self.named_children():
            if isinstance(module, BatchNorm):
                stats[f"{name}.mean"] = torch.zeros_like(module.scale)
                stats[f"{name}.var"] = torch.ones_like(module.scale)
        return stats

    def forward(self, video, stats, training=True):
        new_stats = {}

        def norm(x, name):
            if not self.use_batch_norm:
                return x
            x, (mean, var) = getattr(self, name)(x, stats[f"{name}.mean"], stats[f"{name}.var"], training)
            new_stats[f"{name}.mean"], new_stats[f"{name}.var"] = mean, var
            return x

        b, h, t, w, c = video.shape
        x = video.permute(0, 2, 1, 3, 4).reshape(b * t, h, w, c)
        for i in range(3):
            x = leaky_relu(norm(getattr(self, f"conv{i + 1}")(x), f"bn{i + 1}"))
        x = x.reshape(b, t, -1)
        x = norm(self.lstm1(x), "rnn_bn1")
        x = norm(self.lstm2(x), "rnn_bn2")
        return self.lstm3(x), new_stats


def discriminator_modules(cfg, bn_group=None):
    """The two identical discriminators ``(h, m)`` a ``TrainConfig``
    describes, created on the current default device; ``bn_group`` as in
    the module docstring."""
    m = cfg.model
    return tuple(
        VideoDiscriminator(
            m.x_height, m.x_width, m.n_channels, state_size=m.d_state_size,
            filter_size=m.d_filter_size, use_batch_norm=m.use_norm,
            compute_dtype=cfg.compute_dtype, plain=_plain(cfg), bn_group=bn_group,
        )
        for _ in range(2)
    )
