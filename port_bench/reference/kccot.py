"""Plain PyTorch reference of KCCOT-GAN for the benchmark's correctness check.

A frozen copy of the port's plain path (the loops that ``kernel_impl='scan'``
and ``sinkhorn_solver='scan'`` run), written against parameter dicts: the
ConvLSTM encoder and U-Net ConvLSTM decoder, the two CNN + LSTM
discriminators with their BatchNorm statistics, the mixed causal Sinkhorn
divergence with pM (L dual updates, autograd through every one), the four
Keras-exact Adams on the warmup + staircase schedule, one training step
(shared context encoding, discriminator phase, then generator phase), the
conditioned rollout, and PSNR / SSIM / best-of-K.

It imports only torch.  Every ConvLSTM and LSTM recurrence is a Python loop
and every Sinkhorn solve is L plain dual updates: nothing here launches a
kernel of the program.  Conv and matmul operands are rounded where the
configuration rounds them (``Precision``); states, gates, the Sinkhorn and
the optimizer stay float32.  ``Precision("float8")`` rounds those operands
to e4m3 instead of bfloat16: the control that the comparison has to fail.

Parameters are dicts keyed as the port's ``state_dict`` keys (the flax
paths joined by dots), laid out as the JAX package lays them out (NHWC
images, HWIO conv kernels, Keras ``(kh, kw, filters, in)`` transposed
kernels), so one set of weights made by the benchmark feeds both sides.
Only the smoothing mode ``'none'`` and configurations without dropout are
covered; a configuration that needs more brings its own reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "Precision", "best_of_k", "disc_spec", "gen_spec", "init_params", "init_stats", "psnr", "rollout",
    "ssim", "train_state", "train_step",
]

_LN_EPS = 1e-3
_BN_MOMENTUM, _BN_EPS = 0.99, 1e-3
_FP8_MAX = 448.0  # largest finite float8_e4m3fn


# --------------------------------------------------------------- precision


class Precision:
    """Where conv and matmul operands are rounded: ``'bfloat16'`` (the
    configurations' ``compute_dtype``), ``'float32'``, or ``'float8'``
    (e4m3 with a power-of-two scale per tensor, the values then exact in
    bfloat16).  Results of those ops are rounded to ``cdt``."""

    def __init__(self, name: str):
        if name not in ("bfloat16", "float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.cdt = torch.float32 if name == "float32" else torch.bfloat16

    def op(self, x):
        if self.name == "float8":
            x = x.float()
            amax = x.detach().abs().amax().clamp_min(1e-30)
            scale = torch.exp2(torch.floor(torch.log2(_FP8_MAX / amax)))
            q = (x * scale).to(torch.float8_e4m3fn).float() / scale
            x = x + (q - x).detach()  # rounded forward, straight-through backward
        return x.to(self.cdt)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def same_conv(x, kernel, strides, prec: Precision, out_dtype=torch.float32):
    """NHWC conv with TF 'SAME' padding and an HWIO kernel, operands rounded
    by ``prec``, the result (accumulated in float32) rounded to ``out_dtype``."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    sh, sw = strides
    ph, pw = _same_pads(x.shape[1], kh, sh), _same_pads(x.shape[2], kw, sw)
    xc = F.pad(prec.op(x).permute(0, 3, 1, 2), (*pw, *ph))
    out = F.conv2d(xc, prec.op(kernel).permute(3, 2, 0, 1), stride=(sh, sw))
    return out.permute(0, 2, 3, 1).to(out_dtype)


# ------------------------------------------------------------------ layers


def layer_norm(p, name, x):
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + _LN_EPS) * p[f"{name}.scale"]) + p[f"{name}.bias"]


def convlstm(p, name, x_seq, prec, strides=(1, 1), state=None):
    """Keras ConvLSTM2D, gates [i, f, c, o]: ``(y [B, T, H', W', f] f32,
    (h, c))``.  The input conv is hoisted over all frames; each step adds
    the recurrent conv of ``h`` (rounded to ``cdt``) in float32."""
    kernel, rk = p[f"{name}.kernel"], p[f"{name}.recurrent_kernel"]
    b, t, hh, ww, c = x_seq.shape
    f = rk.shape[2]
    cdt = prec.cdt
    xconv = same_conv(x_seq.reshape(b * t, hh, ww, c), kernel, strides, prec, out_dtype=cdt)
    ho, wo = xconv.shape[1], xconv.shape[2]
    xconv = xconv.reshape(b, t, ho, wo, 4 * f)
    bias = p.get(f"{name}.bias")
    if bias is None:
        bias = xconv.new_zeros(4 * f, dtype=torch.float32)
    if state is None:
        h = x_seq.new_zeros(b, ho, wo, f, dtype=torch.float32)
        cc = torch.zeros_like(h)
    else:
        h, cc = state
    ys = []
    for s in range(t):
        rconv = same_conv(h, rk, (1, 1), prec, out_dtype=cdt).float()
        z = (xconv[:, s].float() + bias) + rconv
        i = torch.sigmoid(z[..., :f])
        fg = torch.sigmoid(z[..., f : 2 * f])
        cc = fg * cc + i * torch.tanh(z[..., 2 * f : 3 * f])
        h = torch.sigmoid(z[..., 3 * f :]) * torch.tanh(cc)
        ys.append(h.to(cdt))
    return torch.stack(ys, dim=1).float(), (h, cc)


def conv_transpose(p, name, x, strides, prec, activation):
    """Keras 'SAME' transposed conv (``out = in * stride``), no bias: the
    taps flipped, the input dilated by the stride, a stride-1 conv."""
    kernel = p[f"{name}.kernel"]
    kh, kw = kernel.shape[0], kernel.shape[1]
    sh, sw = strides
    n, h, w, c = x.shape
    k = prec.op(torch.flip(kernel, (0, 1)).permute(2, 3, 0, 1))
    xd = x.new_zeros(n, c, (h - 1) * sh + 1, (w - 1) * sw + 1, dtype=prec.cdt)
    xd[:, :, ::sh, ::sw] = prec.op(x).permute(0, 3, 1, 2)

    def pads(ksize, stride):
        total = max(ksize - stride, 0)
        return ksize - 1 - total // 2, ksize - 1 - (total - total // 2)

    out = F.conv2d(F.pad(xd, (*pads(kw, sw), *pads(kh, sh))), k).permute(0, 2, 3, 1).float()
    return torch.tanh(out) if activation == "tanh" else torch.sigmoid(out)


def batch_norm(p, name, x, stats, new_stats):
    """flax BatchNorm in training: the batch's statistics (fast variance),
    the running ones updated with momentum 0.99 and no gradient."""
    dims = tuple(range(x.dim() - 1))
    mu = x.mean(dims)
    var = ((x * x).mean(dims) - mu * mu).clamp_min(0.0)
    y = (x - mu) * (torch.rsqrt(var + _BN_EPS) * p[f"{name}.scale"]) + p[f"{name}.bias"]
    m = _BN_MOMENTUM
    new_stats[f"{name}.mean"] = m * stats[f"{name}.mean"] + (1.0 - m) * mu.detach()
    new_stats[f"{name}.var"] = m * stats[f"{name}.var"] + (1.0 - m) * var.detach()
    return y


def lstm(p, name, x_seq, prec, activation="tanh"):
    """Keras LSTM: the input product hoisted and rounded to ``cdt``; each
    step ``(x_t + bias) + h @ R`` in float32, output rounded to ``cdt``."""
    kernel, rk, bias = p[f"{name}.kernel"], p[f"{name}.recurrent_kernel"], p[f"{name}.bias"]
    b, t, feat = x_seq.shape
    u = rk.shape[0]
    act = torch.tanh if activation == "tanh" else torch.sigmoid
    xproj = (prec.op(x_seq.reshape(b * t, feat)) @ prec.op(kernel)).reshape(b, t, 4 * u)
    h = x_seq.new_zeros(b, u, dtype=torch.float32)
    c = torch.zeros_like(h)
    ys = []
    for s in range(t):
        z = (xproj[:, s].float() + bias) + (prec.op(h) @ prec.op(rk)).float()
        i = torch.sigmoid(z[:, :u])
        fg = torch.sigmoid(z[:, u : 2 * u])
        c = fg * c + i * act(z[:, 2 * u : 3 * u])
        h = torch.sigmoid(z[:, 3 * u :]) * act(c)
        ys.append(h.to(prec.cdt))
    return torch.stack(ys, dim=1).float()


def leaky_relu(x):
    return torch.where(x >= 0, x, 0.3 * x)


# ------------------------------------------------------------------ models


def _enc_layers(cfg):
    f = cfg["model"]["g_filter_size"]
    return [(f * 4, 6), (f * 8, 6), (f * 16, 5), (f * 32, 5)]


def encode(cfg, p, video, prec, carry=None, slice_time=True):
    """The 5-level pyramid of ``video [B, H, T, W, C]`` (input and the four
    ConvLSTM levels), each from frame ``Tc - 1`` on unless ``slice_time``
    is off, and the four carries."""
    x = video.permute(0, 2, 1, 3, 4)
    tc = cfg["int_time_steps"] if slice_time else 1
    pyramid, new_carry, h = [x[:, tc - 1 :]], [], x
    for i in range(4):
        h, state = convlstm(p, f"encoder{i + 1}", h, prec, (2, 2), None if carry is None else carry[i])
        new_carry.append(state)
        if cfg["model"]["use_norm"]:
            h = layer_norm(p, f"norm{i + 1}", h)
        pyramid.append(h[:, tc - 1 :])
    return pyramid, new_carry


def _geometry(cfg):
    m = cfg["model"]
    if m["x_height"] != m["x_width"]:
        raise ValueError("the reference covers square frames only")
    return dict(k1=(2, 2), s1=(2, 2), k2=(4, 4), s2=(2, 2), k3=(6, 6), s3=(2, 2))


def decode(cfg, p, pyramid, z, prec, training):
    """Frames ``[B, H, T_z, W, C]`` from the pyramid and noise ``z [B, T_z,
    h4, w4, zc]``: teacher forcing (skips ``[:, :-1]``) in training, the last
    frame's features otherwise."""
    m = cfg["model"]
    g = _geometry(cfg)
    b, t = z.shape[0], z.shape[1]
    norm = m["use_norm"]

    def skip(level):
        return pyramid[level][:, :-1] if training else pyramid[level][:, -1:]

    def fold(seq):
        return seq.reshape((b * t,) + tuple(seq.shape[2:]))

    def unfold(frames):
        return frames.reshape((b, t) + tuple(frames.shape[1:]))

    h = conv_transpose(p, "conv_transpose1", fold(torch.cat([skip(4), z], dim=-1)), g["s1"], prec, "tanh")
    if norm:
        h = layer_norm(p, "conv_norm1", h)
    for level, dec, ct, s in ((3, "decoder2", "conv_transpose2", g["s2"]), (2, "decoder3", "conv_transpose3", g["s3"]),
                              (1, "decoder4", "conv_transpose4", g["s3"])):
        h, _ = convlstm(p, dec, torch.cat([skip(level), unfold(h)], dim=-1), prec)
        if norm:
            h = layer_norm(p, dec + "_norm", h)
        h = conv_transpose(p, ct, fold(h), s, prec, "tanh")
        if norm:
            h = layer_norm(p, ct + "_norm", h)
    h, _ = convlstm(p, "decoder5", torch.cat([skip(0), unfold(h)], dim=-1), prec)
    if norm:
        h = layer_norm(p, "decoder5_norm", h)
    y = conv_transpose(p, "conv_transpose5", fold(h), (1, 1), prec, m["output_activation"])
    return y.reshape(b, t, m["x_height"], m["x_width"], m["n_channels"]).permute(0, 2, 1, 3, 4)


def discriminate(cfg, p, video, stats, prec):
    """``(out [B, T, state], new stats)``: three 5x5 stride-2 convs with
    BatchNorm and LeakyReLU 0.3, then three LSTMs with BatchNorm between."""
    norm = cfg["model"]["use_norm"]
    new_stats = {}

    def bn(x, name):
        return batch_norm(p, name, x, stats, new_stats) if norm else x

    b, h, t, w, c = video.shape
    x = video.permute(0, 2, 1, 3, 4).reshape(b * t, h, w, c)
    for i in range(3):
        name = f"conv{i + 1}"
        x = same_conv(x, p[f"{name}.kernel"], (2, 2), prec) + p[f"{name}.bias"]
        x = leaky_relu(bn(x, f"bn{i + 1}"))
    x = x.reshape(b, t, -1)
    x = bn(lstm(p, "lstm1", x, prec), "rnn_bn1")
    x = bn(lstm(p, "lstm2", x, prec), "rnn_bn2")
    return lstm(p, "lstm3", x, prec, "sigmoid"), new_stats


def rollout(cfg, gen_params, context, z, prec):
    """Conditioned rollout: ``context [B, H, Tc, W, C]`` and ``z [Tp, B, 1,
    h4, w4, zc]`` -> ``[B, H, Tc + Tp, W, C]``; each new frame decoded from
    the last frame's features, then encoded onto the carries."""
    enc, dec = gen_params["encoder"], gen_params["decoder"]
    pyramid, carry = encode(cfg, enc, context, prec)
    frames = []
    for s in range(z.shape[0]):
        frame = decode(cfg, dec, [q[:, -1:] for q in pyramid], z[s], prec, training=False)
        pyramid, carry = encode(cfg, enc, frame, prec, carry=carry, slice_time=False)
        frames.append(frame)
    return torch.cat([context, *frames], dim=2)


# -------------------------------------------------------------- objective


def _cost(x, y, h, m, scaling):
    """Gram-form squared-L2 cost plus the causal Lagrangian ``<h[:-1], dM>``."""
    xf, yf = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
    sq = (xf * xf).sum(-1)[:, None] + (yf * yf).sum(-1)[None, :] - 2.0 * (xf @ yf.T)
    c = torch.maximum(sq, torch.zeros_like(sq)) * scaling
    dm, ht = m[:, 1:] - m[:, :-1], h[:, :-1]
    return c + (ht.reshape(ht.shape[0], -1) @ dm.reshape(dm.shape[0], -1).T) * scaling


def _sinkhorn(c, eps, num_iters):
    """Entropic OT cost with uniform marginals: L dual updates, u then v."""
    log_mu = -torch.log(torch.tensor(float(c.shape[-1]), dtype=torch.float32)).to(c.device)
    u, v = c.new_zeros(c.shape[0], 1), c.new_zeros(1, c.shape[0])
    for _ in range(num_iters):
        u = eps * (log_mu - torch.logsumexp((-c + u + v) / eps, dim=-1, keepdim=True)) + u
        v = eps * (log_mu - torch.logsumexp((-c + u + v) / eps, dim=-2, keepdim=True)) + v
    return (torch.exp((-c + u + v) / eps) * c).sum()


def mixed_sinkhorn_loss(cfg, real, fake, h_fake, m_real, h_real, m_fake):
    """``2 W(x, y) - W(x, x) - W(y, y)`` on the flattened videos."""
    def flat(v):
        x = v.permute(0, 2, 1, 3, 4)
        return x.reshape(x.shape[0], x.shape[1], -1)

    x, y = flat(real), flat(fake)
    s, eps, n = 1.0 / cfg["scaling_coef"], cfg["sinkhorn_eps"], cfg["sinkhorn_l"]
    xy = _sinkhorn(_cost(x, y, h_fake, m_real, s), eps, n)
    xx = _sinkhorn(_cost(x, x, h_real, m_real, s), eps, n)
    yy = _sinkhorn(_cost(y, y, h_fake, m_fake, s), eps, n)
    return 2.0 * xy - xx - yy


def martingale_penalty(cfg, m):
    n = m[:, 1:] - m[:, :-1]
    std = torch.std(m, dim=(0, 1), correction=0)
    mean_n = (n / (std + 1e-6)).sum(0) / m.shape[0]
    return cfg["reg_penalty"] * (mean_n.abs().sum() * (1.0 / cfg["scaling_coef"]))


def gan_forward(cfg, dec, hp, mp, h_stats, m_stats, real, z, prec, pyramid):
    """``(loss, pm, h_stats, m_stats)`` from the shared context encoding
    ``pyramid``: decode in teacher forcing, the four discriminator passes
    h(fake), h(real), m(real), m(fake) with the statistics chained in that
    order, the mixed divergence and pM."""
    fake = torch.cat([real[:, :, : cfg["int_time_steps"]], decode(cfg, dec, pyramid, z, prec, True)], dim=2)
    h_fake, h_stats = discriminate(cfg, hp, fake, h_stats, prec)
    h_real, h_stats = discriminate(cfg, hp, real, h_stats, prec)
    m_real, m_stats = discriminate(cfg, mp, real, m_stats, prec)
    m_fake, m_stats = discriminate(cfg, mp, fake, m_stats, prec)
    loss = mixed_sinkhorn_loss(cfg, real, fake, h_fake, m_real, h_real, m_fake)
    return loss, martingale_penalty(cfg, m_real), h_stats, m_stats


# -------------------------------------------------------------- optimizer


def _lr(cfg, it: int):
    step = torch.tensor(float(it), dtype=torch.float32)
    warm = cfg["lr"] * step / max(cfg["warmup_steps"], 1)
    t = torch.clamp_min(step - cfg["warmup_steps"], 0.0)
    decayed = cfg["lr"] * torch.pow(torch.tensor(cfg["decay_rate"], dtype=torch.float32),
                                    torch.floor(t / cfg["decay_steps"]))
    return torch.where(step < cfg["warmup_steps"], warm, decayed)


def adam_update(cfg, grads, opt, params, offset):
    """Keras-3 Adam: the schedule read at iteration ``2n + offset`` (the
    two updates a shared optimizer makes each step), bias corrections
    folded into the step size, epsilon added to ``sqrt(v)``."""
    count, mu, nu = opt
    it = 2 * count + offset if cfg["keras_double_step_quirk"] else count
    b1, b2 = cfg["beta1"], cfg["beta2"]
    t = torch.tensor(it + 1, dtype=torch.float32)
    alpha = _lr(cfg, it) * torch.sqrt(1.0 - torch.tensor(b2, dtype=torch.float32) ** t) / (
        1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = mu[k] + (g - mu[k]) * (1.0 - b1)
        v = nu[k] + (torch.square(g) - nu[k]) * (1.0 - b2)
        new_p[k] = p + (-(m * alpha) / (torch.sqrt(v) + cfg["adam_eps"]))
        new_mu[k], new_nu[k] = m, v
    return new_p, (count + 1, new_mu, new_nu)


_OFFSETS = {"enc": 0, "dec": 1, "h": 0, "m": 1}


def train_state(params, stats):
    """The reference's state from parameters ``{enc, dec, h, m}`` and
    statistics ``{h, m}``: fresh Adam moments, step 0."""
    opt = {g: (0, {k: torch.zeros_like(v) for k, v in p.items()}, {k: torch.zeros_like(v) for k, v in p.items()})
           for g, p in params.items()}
    return {"params": params, "stats": stats, "opt": opt}


def _leaves(p):
    return {k: v.detach().requires_grad_() for k, v in p.items()}


def _grads(loss, *groups):
    flat = [v for g in groups for v in g.values()]
    it = iter(torch.autograd.grad(loss, flat))
    return [{k: next(it) for k in g} for g in groups]


def train_step(cfg, state, real, z1, z2, prec):
    """One GAN step on ``real [B, H, T, W, C]`` with the two phases' noise:
    ``(new state, {"loss": generator phase's loss, "pm": discriminator
    phase's pM})``.  The context is encoded once; the discriminator phase
    reads it detached and minimizes ``-loss + pM`` over h and m; the
    generator phase meets the updated discriminators and minimizes the
    loss over the encoder and the decoder."""
    if cfg["kernel"] != "none" or cfg["model"]["dropout"] or cfg["model"]["rnn_dropout"]:
        raise ValueError("the reference covers kernel='none' without dropout")
    if not cfg["share_context_encoding"]:
        raise ValueError("the reference covers the shared context encoding")
    p, opt = state["params"], state["opt"]
    enc = _leaves(p["enc"])
    pyramid, _ = encode(cfg, enc, real, prec)

    hp, mp = _leaves(p["h"]), _leaves(p["m"])
    loss, pm, h_stats, m_stats = gan_forward(
        cfg, p["dec"], hp, mp, state["stats"]["h"], state["stats"]["m"], real, z1, prec,
        [q.detach() for q in pyramid])
    gh, gm = _grads(-loss + pm, hp, mp)
    new_opt, new_p = {}, {}
    new_p["h"], new_opt["h"] = adam_update(cfg, gh, opt["h"], p["h"], _OFFSETS["h"])
    new_p["m"], new_opt["m"] = adam_update(cfg, gm, opt["m"], p["m"], _OFFSETS["m"])

    dec = _leaves(p["dec"])
    gen_loss, _, h_stats, m_stats = gan_forward(
        cfg, dec, new_p["h"], new_p["m"], h_stats, m_stats, real, z2, prec, pyramid)
    ge, gd = _grads(gen_loss, enc, dec)
    new_p["enc"], new_opt["enc"] = adam_update(cfg, ge, opt["enc"], p["enc"], _OFFSETS["enc"])
    new_p["dec"], new_opt["dec"] = adam_update(cfg, gd, opt["dec"], p["dec"], _OFFSETS["dec"])
    new_state = {"params": new_p, "stats": {"h": h_stats, "m": m_stats}, "opt": new_opt}
    return new_state, {"loss": gen_loss.detach(), "pm": pm.detach()}


# ------------------------------------------------------------ evaluation


def psnr(pred, target, dtype=torch.float32):
    """Per-frame PSNR (dB) of two film-strips, max value 1 -> ``[B, T]``,
    computed in ``dtype``."""
    mse = torch.mean(torch.square(pred.to(dtype) - target.to(dtype)), dim=(1, 3, 4))
    return (10.0 * (0.0 - torch.log10(mse))).float()


def ssim(pred, target, dtype=torch.float32):
    """Per-frame SSIM (tf.image's: 11x11 Gaussian window, sigma 1.5, VALID,
    the map clipped to [-1, 1]) of two film-strips -> ``[B, T]``, computed
    in ``dtype``."""
    b, h, t, w, c = pred.shape

    def frames(v):
        return v.to(dtype).permute(0, 2, 4, 1, 3).reshape(b * t, c, h, w)

    x, y = frames(pred), frames(target)
    g = torch.arange(11, dtype=torch.float32, device=x.device) - 5.0
    g = torch.exp(-torch.square(g) / (2.0 * 1.5 * 1.5))
    g = (g / g.sum()).to(dtype)

    def blur(v):
        v = F.conv2d(v, g.view(1, 1, 11, 1).expand(c, 1, 11, 1), groups=c)
        return F.conv2d(v, g.view(1, 1, 1, 11).expand(c, 1, 1, 11), groups=c)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mx, my = blur(x), blur(y)
    num0, den0 = 2.0 * mx * my, torch.square(mx) + torch.square(my)
    lum = (num0 + c1) / (den0 + c1)
    cs = (2.0 * blur(x * y) - num0 + c2) / (blur(torch.square(x)) + blur(torch.square(y)) - den0 + c2)
    return torch.mean(torch.clamp(lum * cs, -1.0, 1.0).float(), dim=(1, 2, 3)).reshape(b, t)


def best_of_k(preds, truth, dtype=torch.float32):
    """Best-of-K scores of K predicted futures ``preds`` (each ``[B, H, Tp,
    W, C]``) against ``truth``: ``(mean of each sample's best mean PSNR,
    the same for SSIM)``, both computed in ``dtype``."""
    best_ps = best_ss = None
    for pred in preds:
        ps, ss = psnr(pred, truth, dtype).mean(1), ssim(pred, truth, dtype).mean(1)
        best_ps = ps if best_ps is None else torch.maximum(best_ps, ps)
        best_ss = ss if best_ss is None else torch.maximum(best_ss, ss)
    return best_ps.mean(), best_ss.mean()


# ------------------------------------------------------------- parameters


def gen_spec(cfg):
    """``{"encoder": [...], "decoder": [...]}``: each parameter as ``(key,
    shape, init, fan_in, fan_out)``, init one of ``glorot``, ``recurrent``,
    ``forget_bias``, ``ones``, ``zeros``."""
    m = cfg["model"]
    f, zc, nch = m["g_filter_size"], m["z_channels"], m["n_channels"]
    g = _geometry(cfg)
    enc, dec = [], []

    def cl(out, name, c_in, filters, k, bias):
        out += [(f"{name}.kernel", (k, k, c_in, 4 * filters), "glorot", k * k * c_in, k * k * 4 * filters),
                (f"{name}.recurrent_kernel", (k, k, filters, 4 * filters), "recurrent",
                 k * k * filters, 4 * filters)]
        if bias:
            out.append((f"{name}.bias", (4 * filters,), "forget_bias", 0, 0))

    def ln(out, name, n):
        if m["use_norm"]:
            out += [(f"{name}.scale", (n,), "ones", 0, 0), (f"{name}.bias", (n,), "zeros", 0, 0)]

    def ct(out, name, c_in, filters, k):
        out.append((f"{name}.kernel", (k[0], k[1], filters, c_in), "glorot", k[0] * k[1] * filters,
                    k[0] * k[1] * c_in))

    c_in = nch
    for i, (filters, k) in enumerate(_enc_layers(cfg)):
        cl(enc, f"encoder{i + 1}", c_in, filters, k, False)
        ln(enc, f"norm{i + 1}", filters)
        c_in = filters
    ct(dec, "conv_transpose1", f * 32 + zc, f * 32, g["k1"])
    ln(dec, "conv_norm1", f * 32)
    c = f * 32
    for skip_c, (cf, ck, cb), (tf_, tk), dn, cn in (
        (f * 16, (f * 16, 4, False), (f * 16, g["k2"]), "decoder2", "conv_transpose2"),
        (f * 8, (f * 8, 6, False), (f * 8, g["k3"]), "decoder3", "conv_transpose3"),
        (f * 4, (f * 4, 8, True), (f * 2, g["k3"]), "decoder4", "conv_transpose4"),
    ):
        cl(dec, dn, skip_c + c, cf, ck, cb)
        ln(dec, dn + "_norm", cf)
        ct(dec, cn, cf, tf_, tk)
        ln(dec, cn + "_norm", tf_)
        c = tf_
    cl(dec, "decoder5", nch + c, f, 8, True)
    ln(dec, "decoder5_norm", f)
    ct(dec, "conv_transpose5", f, nch, (8, 8))
    return {"encoder": enc, "decoder": dec}


def disc_spec(cfg):
    """One discriminator's parameters as ``gen_spec`` gives them, and the
    names of its BatchNorms."""
    m = cfg["model"]
    f = m["d_filter_size"]
    out, bns = [], []
    c_in, h, w = m["n_channels"], m["x_height"], m["x_width"]
    for i, filters in enumerate((f * 4, f * 8, f * 16)):
        out += [(f"conv{i + 1}.kernel", (5, 5, c_in, filters), "glorot", 25 * c_in, 25 * filters),
                (f"conv{i + 1}.bias", (filters,), "zeros", 0, 0)]
        if m["use_norm"]:
            out += [(f"bn{i + 1}.scale", (filters,), "ones", 0, 0), (f"bn{i + 1}.bias", (filters,), "zeros", 0, 0)]
            bns.append((f"bn{i + 1}", filters))
        c_in, h, w = filters, -(-h // 2), -(-w // 2)
    for name, n_in, u in (("lstm1", h * w * c_in, f * 8), ("lstm2", f * 8, f * 4),
                          ("lstm3", f * 4, m["d_state_size"])):
        out += [(f"{name}.kernel", (n_in, 4 * u), "glorot", n_in, 4 * u),
                (f"{name}.recurrent_kernel", (u, 4 * u), "recurrent", u, 4 * u),
                (f"{name}.bias", (4 * u,), "forget_bias", 0, 0)]
    if m["use_norm"]:
        for name, n in (("rnn_bn1", f * 8), ("rnn_bn2", f * 4)):
            out += [(f"{name}.scale", (n,), "ones", 0, 0), (f"{name}.bias", (n,), "zeros", 0, 0)]
            bns.append((name, n))
    return out, bns


def init_params(groups: dict, generator: torch.Generator, device) -> dict:
    """Weights for ``groups`` (name -> spec list), made on ``device`` from
    ``generator`` in one uniform draw: kernels glorot-uniform, recurrent
    kernels uniform with the variance of an orthogonal matrix's entries
    (``1 / max(rows, cols)`` of the ``[kh kw f, 4f]`` matrix), biases zero
    with the forget gate's at one, norms at scale one and bias zero."""
    random = [(g, s) for g, spec in groups.items() for s in spec if s[2] in ("glorot", "recurrent")]
    total = sum(math.prod(s[1]) for _, s in random)
    flat = torch.rand(total, generator=generator, device=device)
    out, at = {g: {} for g in groups}, 0
    for g, (key, shape, kind, fan_in, fan_out) in random:
        n = math.prod(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out)) if kind == "glorot" else math.sqrt(3.0 / max(fan_in, fan_out))
        out[g][key] = ((flat[at : at + n] * 2.0 - 1.0) * limit).reshape(shape)
        at += n
    for g, spec in groups.items():
        for key, shape, kind, _, _ in spec:
            if kind == "ones":
                out[g][key] = torch.ones(shape, device=device)
            elif kind == "zeros":
                out[g][key] = torch.zeros(shape, device=device)
            elif kind == "forget_bias":
                u = shape[0] // 4
                out[g][key] = torch.zeros(shape, device=device)
                out[g][key][u : 2 * u] = 1.0
        out[g] = {key: out[g][key] for key, *_ in spec}  # in the spec's order
    return out


def init_stats(bns, device) -> dict:
    """Fresh BatchNorm running statistics: means 0, variances 1."""
    out = {}
    for name, n in bns:
        out[f"{name}.mean"] = torch.zeros(n, device=device)
        out[f"{name}.var"] = torch.ones(n, device=device)
    return out
