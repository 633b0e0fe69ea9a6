"""The tensor-core ConvLSTM kernels' operand layouts, emulated on the CPU.

The bf16 engine of ``csrc/convlstm_fwd.cu`` and ``csrc/convlstm_bwd.cu``
runs every product of the recurrence as an implicit GEMM on the tensor
cores; those kernels run only on the card.  Their index maps do not need
it: this file rebuilds each GEMM in plain PyTorch exactly as the kernels
lay it out, and checks the result against the plain versions (the
forward's ``_fwd_plain``, ``convlstm_bwd_reference``), which
``test_torch_convlstm.py`` and ``test_torch_convlstm_grad.py`` pin to JAX.

* The gate GEMM (the forward step): A[m][k] gathered from h_{t-1} with
  k = (ky*kw + kx)*f + ci in chunks of 8 channels of one tap, summed a k16
  step at a time (two taps a step at f = 8); B the packed weight of
  ``_pack_gates``, read back through the epilogue's column map (gate g of
  channel j at 16*(j//4) + 8*(g//2) + 2*(j%4) + g%2).  Under autograd the
  epilogue stores the four gates of (pixel, j) together, at 4j + g of the
  gate stack, from which the backward's cell adjoint reads them (it runs
  no gate GEMM).
* dh: A gathered from dz with the flipped pads (source pixel y - ky + lo),
  B the transposed weight of ``_pack_dh``.
* drk: A^T[p][m] the shifted h_{t-1} over the B*T*H*W pixels, split over
  K into partials that are added in the finalize's order; db from
  partial rows, one a block of consecutive pixels of the adjoint,
  accumulated over the steps and added in order.
* Recurrent dropout (the kernels' masked mode): the gate GEMM gathers
  the gate-major masked h's (4f channels) against the block-diagonal
  weight (``_block_diagonal``); dh takes the gate-quad columns of
  ``_pack_dh_gates`` and sums the four gates times their masks; drk is
  one GEMM a gate, hm_g against dz_g.

All in f32, where the products and sums are the plain versions' own up to
summation order: tolerance 1e-5 of each output's largest entry.  Small
sizes (B=2, T=3, 5x6 frames): the file takes a few seconds.
"""

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch.models.cuda_convlstm import (
    _block_diagonal,
    _fwd_plain,
    _gate_major,
    _pack_dh,
    _pack_dh_gates,
    _pack_gates,
    _wgrad_splits,
    convlstm_bwd_reference,
)

TOL = 1e-5  # of each output's largest entry, f32


def _inputs(b, t, h, w, f, k, seed):
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    xconv = randn(b, t, h, w, 4 * f)
    h0, c0 = randn(b, h, w, f, scale=0.5), randn(b, h, w, f, scale=0.5)
    rk = randn(k, k, f, 4 * f, scale=(k * k * f) ** -0.5)
    bias = randn(4 * f, scale=0.1)
    return xconv, h0, c0, rk, bias


def _shift(src, dy, dx):
    """out[b, y, x] = src[b, y + dy, x + dx], zero outside the frame."""
    out = torch.zeros_like(src)
    h, w = src.shape[1], src.shape[2]
    ys, yd = max(0, dy), max(0, -dy)
    xs, xd = max(0, dx), max(0, -dx)
    ny, nx = h - abs(dy), w - abs(dx)
    if ny > 0 and nx > 0:
        out[:, yd : yd + ny, xd : xd + nx] = src[:, ys : ys + ny, xs : xs + nx]
    return out


def _gather(src, kh, kw, sgn, oy, ox):
    """The conv GEMM's A [B*H*W, kh*kw*C]: A[m][(ky*kw + kx)*C + c] =
    src[b, y + sgn*ky + oy, x + sgn*kx + ox, c], gathered as the kernel
    does, one 8-channel chunk of one tap at a time."""
    b, h, w, c = src.shape
    assert c % 8 == 0  # the kernels' vectorised gather: a chunk never crosses a tap
    k_total = kh * kw * c
    a = torch.zeros(b * h * w, k_total)
    shifted = {}
    for k in range(0, k_total, 8):
        tap, c0 = divmod(k, c)
        if tap not in shifted:
            ky, kx = divmod(tap, kw)
            shifted[tap] = _shift(src, sgn * ky + oy, sgn * kx + ox).reshape(-1, c)
        a[:, k : k + 8] = shifted[tap][:, c0 : c0 + 8]
    return a


def _gemm_k16(a, b_mat, taps_per_step=None, c=None):
    """A @ B summed one k16 step at a time, in the kernel's order.  With
    ``c`` given, checks which taps each step spans."""
    k_total = a.shape[1]
    acc = torch.zeros(a.shape[0], b_mat.shape[1])
    for k0 in range(0, k_total, 16):
        if c is not None:
            taps = {k // c for k in range(k0, min(k0 + 16, k_total))}
            # the last step may hold fewer taps, the rest of it zero padding
            assert len(taps) == min(taps_per_step, -(-(k_total - k0) // c)), (k0, taps)
        acc += a[:, k0 : k0 + 16] @ b_mat[k0 : k0 + 16]
    return acc


def _unpack_gates(acc, f):
    """[M, 16*ceil(f/4)] in the epilogue's column order -> [M, 4f] in
    gate-major order g*f + j."""
    j = torch.arange(f)
    out = []
    for g in range(4):
        cols = 16 * (j // 4) + 8 * (g // 2) + 2 * (j % 4) + g % 2
        out.append(acc[:, cols])
    return torch.cat(out, dim=1)


def _gate_conv(hp, rk, taps_per_step=None):
    kh, kw, f, _ = rk.shape
    a = _gather(hp, kh, kw, 1, -((kh - 1) // 2), -((kw - 1) // 2))
    acc = _gemm_k16(a, _pack_gates(rk, torch.float32), taps_per_step, f if taps_per_step else None)
    return _unpack_gates(acc, f).reshape(*hp.shape[:3], 4 * f)


def _store_quads(z, f):
    """The epilogue's gate-stack store: gate-major [..., 4f] -> gate g of
    channel j at 4j + g."""
    out = torch.empty_like(z)
    for g, j in np.ndindex(4, f):
        out[..., 4 * j + g] = z[..., g * f + j]
    return out


def _load_quads(gates, f):
    """The adjoint's 16-byte load of (pixel, j)'s gates, back to
    gate-major."""
    return torch.cat([gates[..., g : 4 * f : 4] for g in range(4)], dim=-1)


def _emulate_fwd(xconv, h0, c0, rk, bias):
    f = h0.shape[-1]
    taps_per_step = 2 if f == 8 else None
    h, c, ys, cs, zs = h0, c0, [], [], []
    for t in range(xconv.shape[1]):
        z = (xconv[:, t] + bias) + _gate_conv(h, rk, taps_per_step)
        i, fg = torch.sigmoid(z[..., :f]), torch.sigmoid(z[..., f : 2 * f])
        c = fg * c + i * torch.tanh(z[..., 2 * f : 3 * f])
        h = torch.sigmoid(z[..., 3 * f :]) * torch.tanh(c)
        ys.append(h)
        cs.append(c)
        zs.append(_store_quads(z, f))
    return torch.stack(ys, 1), torch.stack(cs, 1), h, c, torch.stack(zs, 1)


def _emulate_bwd(gates, h0, c0, rk, y, c_stack, dy, dh_n, dc_n, bm=64, splits=3):
    """The bf16 engine's backward with its two GEMMs in their kernel
    layouts (f32): per step the adjoint on the gate stack, db into rows
    of bm consecutive pixels, dh by the transposed-conv GEMM; then drk by
    the split-K GEMM."""
    b, t_total, h, w, f4 = gates.shape
    f = f4 // 4
    kh, kw = rk.shape[0], rk.shape[1]
    m_total = b * h * w
    rows = -(-m_total // bm)
    dbpart = torch.zeros(rows, f4)
    wT = _pack_dh(rk, torch.float32)
    assert wT.shape == (kh * kw * f4, -(-f // 8) * 8)
    dh, dc = dh_n.clone(), dc_n.clone()
    dx = torch.empty_like(gates)
    for t in reversed(range(t_total)):
        cp = c0 if t == 0 else c_stack[:, t - 1]
        z = _load_quads(gates[:, t], f)
        i, fg = torch.sigmoid(z[..., :f]), torch.sigmoid(z[..., f : 2 * f])
        g, o = torch.tanh(z[..., 2 * f : 3 * f]), torch.sigmoid(z[..., 3 * f :])
        tc = torch.tanh(fg * cp + i * g)
        dhv = dh + dy[:, t]
        dcv = dc + dhv * o * (1.0 - tc * tc)
        dz = torch.cat([dcv * g * i * (1 - i), dcv * cp * fg * (1 - fg), dcv * i * (1 - g * g),
                        dhv * tc * o * (1 - o)], dim=-1)
        dx[:, t] = dz
        flat = dz.reshape(m_total, f4)
        for r in range(rows):  # each adjoint block owns row r across all steps
            dbpart[r] += flat[r * bm : (r + 1) * bm].sum(0)
        a = _gather(dz, kh, kw, -1, (kh - 1) // 2, (kw - 1) // 2)
        dh = _gemm_k16(a, wT)[:, :f].reshape(b, h, w, f)
        dc = dcv * fg
    # drk: A^T[p][m] over p = ((b*T + t)*H + y)*W + x, split over K
    hprev = torch.cat([h0[:, None], y[:, :-1]], dim=1).reshape(b * t_total, h, w, f)
    a_t = _gather(hprev, kh, kw, 1, -((kh - 1) // 2), -((kw - 1) // 2))  # [P, M]
    b_mat = dx.reshape(-1, f4)
    pixels = a_t.shape[0]
    chunk = -(-pixels // splits)
    parts = [a_t[s * chunk : (s + 1) * chunk].T @ b_mat[s * chunk : (s + 1) * chunk]
             for s in range(splits)]
    drk = torch.zeros_like(parts[0])
    for p in parts:  # the finalize: splits in order
        drk += p
    db = torch.zeros(f4)
    for r in range(rows):
        db += dbpart[r]
    return dx, dh, dc, drk.reshape(kh, kw, f, f4), db


def _assert_rel(got, want, name):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * scale, f"{name}: {err} > {TOL} * {scale}"


def test_packed_weights_layout():
    """Every weight lands where the kernels read it, and the padding is zero."""
    rk = torch.arange(3 * 2 * 6 * 24, dtype=torch.float32).reshape(3, 2, 6, 24)
    kh, kw, f, f4 = rk.shape
    wp = _pack_gates(rk, torch.float32)
    assert wp.shape == (kh * kw * f, 16 * 2)
    for ky, kx, ci, g, j in np.ndindex(kh, kw, f, 4, f):
        col = 16 * (j // 4) + 8 * (g // 2) + 2 * (j % 4) + g % 2
        assert wp[(ky * kw + kx) * f + ci, col] == rk[ky, kx, ci, g * f + j]
    assert int((wp != 0).sum()) == rk.numel() - 1  # rk[0, 0, 0, 0] is 0
    wt = _pack_dh(rk, torch.float32)
    assert wt.shape == (kh * kw * f4, 8)
    for ky, kx, ci, n in np.ndindex(kh, kw, f, f4):
        assert wt[(ky * kw + kx) * f4 + n, ci] == rk[ky, kx, ci, n]
    assert not bool(wt[:, f:].any())
    # bf16 packing rounds once, like the kernels' operands
    assert _pack_gates(rk / 7, torch.bfloat16).dtype == torch.bfloat16


def test_wgrad_splits():
    assert _wgrad_splits(655_360, 36) == (15, 43_691)
    assert _wgrad_splits(100, 4) == (1, 100)
    splits, chunk = _wgrad_splits(10_240, 1600)
    assert splits * chunk >= 10_240 and splits == 1


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("f", [8, 16, 24])
def test_gate_gemm_matches_reference(f, k):
    args = _inputs(2, 3, 5, 6, f, k, seed=f + k)
    want = _fwd_plain(*args, None, with_gates=True)
    got = _emulate_fwd(*args)
    for g, w, name in zip(got, want[:4] + want[5:], ("y", "c_stack", "h", "c", "gates")):
        _assert_rel(g, w, name)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("f", [8, 16, 24])
def test_backward_gemms_match_reference(f, k):
    args = _inputs(2, 3, 5, 6, f, k, seed=10 + f + k)
    y, cs, h, c, gates = _emulate_fwd(*args)
    rng = np.random.default_rng(f * k)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in (y.shape, h.shape, c.shape)]
    want = convlstm_bwd_reference(*args, y, cs, *cot)
    got = _emulate_bwd(gates, *args[1:4], y, cs, *cot)
    for g, w, name in zip(got, want, ("dx", "dh0", "dc0", "drk", "db")):
        _assert_rel(g, w, name)


def _masks(b, h, w, f, seed, keep=0.7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((4, b, h, w, f)) < keep).astype(np.float32) / keep)


def _emulate_fwd_masked(xconv, h0, c0, rk, bias, masks):
    """The masked gate GEMM: A gathered from hm = h_{t-1} * mask_g
    (gate-major, 4f channels), B packed from the block-diagonal weight;
    each step also writes hm_t, as the epilogue does."""
    f = h0.shape[-1]
    mask = _gate_major(masks)
    wp = _pack_gates(_block_diagonal(rk), torch.float32)
    kh, kw = rk.shape[0], rk.shape[1]
    h, c, ys, cs, zs = h0, c0, [], [], []
    hm = (h0.unsqueeze(3) * mask.view(*h0.shape[:3], 4, f)).reshape(mask.shape)
    hms = [hm]
    for t in range(xconv.shape[1]):
        a = _gather(hm, kh, kw, 1, -((kh - 1) // 2), -((kw - 1) // 2))
        z = (xconv[:, t] + bias) + _unpack_gates(_gemm_k16(a, wp), f).reshape(*h.shape[:3], 4 * f)
        i, fg = torch.sigmoid(z[..., :f]), torch.sigmoid(z[..., f : 2 * f])
        c = fg * c + i * torch.tanh(z[..., 2 * f : 3 * f])
        h = torch.sigmoid(z[..., 3 * f :]) * torch.tanh(c)
        hm = (h.unsqueeze(3) * mask.view(*h.shape[:3], 4, f)).reshape(mask.shape)
        hms.append(hm)
        ys.append(h)
        cs.append(c)
        zs.append(_store_quads(z, f))
    return (torch.stack(ys, 1), torch.stack(cs, 1), h, c, (hms[0], torch.stack(hms[1:], 1)),
            torch.stack(zs, 1))


def _emulate_bwd_masked(gates, h0, c0, rk, y, c_stack, dy, dh_n, dc_n, masks, hm):
    """The masked backward's GEMMs in their kernel layouts (f32); the
    adjoint is the unmasked one, on the gate stack."""
    b, t_total, h, w, f4 = gates.shape
    f = f4 // 4
    kh, kw = rk.shape[0], rk.shape[1]
    mask = _gate_major(masks).view(b, h, w, 4, f)
    wq = _pack_dh_gates(rk, torch.float32)
    assert wq.shape == (kh * kw * f4, 16 * -(-f // 4))
    dh, dc = dh_n.clone(), dc_n.clone()
    dx = torch.empty_like(gates)
    db = torch.zeros(f4)
    hms = [hm[0]] + [hm[1][:, s] for s in range(t_total - 1)]  # hm_{t-1} of step t
    for t in reversed(range(t_total)):
        cp = c0 if t == 0 else c_stack[:, t - 1]
        z = _load_quads(gates[:, t], f)
        i, fg = torch.sigmoid(z[..., :f]), torch.sigmoid(z[..., f : 2 * f])
        g, o = torch.tanh(z[..., 2 * f : 3 * f]), torch.sigmoid(z[..., 3 * f :])
        tc = torch.tanh(fg * cp + i * g)
        dhv = dh + dy[:, t]
        dcv = dc + dhv * o * (1.0 - tc * tc)
        dz = torch.cat([dcv * g * i * (1 - i), dcv * cp * fg * (1 - fg), dcv * i * (1 - g * g),
                        dhv * tc * o * (1 - o)], dim=-1)
        dx[:, t] = dz
        db += dz.reshape(-1, f4).sum(0)
        quads = _gemm_k16(_gather(dz, kh, kw, -1, (kh - 1) // 2, (kw - 1) // 2), wq)
        dhm = _unpack_gates(quads, f).reshape(b, h, w, 4, f)
        dh = sum(mask[..., q, :] * dhm[..., q, :] for q in range(4))
        dc = dcv * fg
    hprev = torch.stack(hms, 1).reshape(b * t_total, h, w, f4)
    drk = []
    for q in range(4):  # one GEMM a gate: hm_g against dz_g
        a_t = _gather(hprev[..., q * f : (q + 1) * f].contiguous(), kh, kw, 1,
                      -((kh - 1) // 2), -((kw - 1) // 2))
        drk.append(a_t.T @ dx[..., q * f : (q + 1) * f].reshape(-1, f))
    return dx, dh, dc, torch.cat(drk, 1).reshape(kh, kw, f, f4), db


@pytest.mark.parametrize("f,k", [(8, 3), (16, 4)])
def test_masked_gemms_match_reference(f, k):
    """Recurrent dropout: the forward's and the backward's GEMMs in their
    masked layouts against the plain versions with the same masks."""
    args = _inputs(2, 3, 5, 6, f, k, seed=20 + f + k)
    masks = _masks(2, 5, 6, f, seed=f)
    want = _fwd_plain(*args, masks, with_gates=True)
    got = _emulate_fwd_masked(*args, masks)
    for g, w, name in zip(got[:4] + got[5:], want[:4] + want[5:], ("y", "c_stack", "h", "c", "gates")):
        _assert_rel(g, w, name)
    _assert_rel(got[4][0], want[4][0], "hm0")
    _assert_rel(got[4][1][:, :-1], want[4][1][:, :-1], "hm")
    y, cs, h, c, hm, gates = got
    rng = np.random.default_rng(f * k)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in (y.shape, h.shape, c.shape)]
    want = convlstm_bwd_reference(*args, y, cs, *cot, rec_masks=masks, hm=hm)
    got = _emulate_bwd_masked(gates, *args[1:4], y, cs, *cot, masks, hm)
    for g, w, name in zip(got, want, ("dx", "dh0", "dc0", "drk", "db")):
        _assert_rel(g, w, name)


def test_masked_packings_layout():
    """The block-diagonal weight feeds gate g's columns from hm_g's rows
    alone, and the masked dh weight holds gate g's rows in its gate-g
    columns, zero elsewhere."""
    rk = torch.arange(1, 2 * 2 * 4 * 16 + 1, dtype=torch.float32).reshape(2, 2, 4, 16)
    kh, kw, f, f4 = rk.shape
    bd = _block_diagonal(rk)
    assert bd.shape == (kh, kw, f4, f4)
    for ky, kx, gi, ci, n in np.ndindex(kh, kw, 4, f, f4):
        assert bd[ky, kx, gi * f + ci, n] == (rk[ky, kx, ci, n] if n // f == gi else 0)
    wq = _pack_dh_gates(rk, torch.float32)
    for ky, kx, n, g, ci in np.ndindex(kh, kw, f4, 4, f):
        col = 16 * (ci // 4) + 8 * (g // 2) + 2 * (ci % 4) + g % 2
        assert wq[(ky * kw + kx) * f4 + n, col] == (rk[ky, kx, ci, n] if n // f == g else 0)
