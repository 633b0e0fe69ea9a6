"""The Sinkhorn kernels' register path (B <= 64), emulated in f32 torch on the CPU.

``csrc/sinkhorn_fwd.cu`` and ``csrc/sinkhorn_bwd.cu`` hold a problem of
B <= 64 points in registers: a group of P = 16 lanes owns row r and
column r of C, lane q of it the elements x = q + P e, each lane summing
its elements in order before a butterfly over the group.  The backward keeps
c_bar in row layout only, taking each step's b_bar (computed by columns)
through a shared [N][N + 1] tile (N = 32 or 64), so c_bar takes b_bar /
eps, then a_bar / eps, in the reference's order; the column sums of
a_bar come back through a second tile.  Divisions are a correctly
rounded reciprocal times the dividend with one FMA correction.  This
file replays those orders and layouts in f32 and holds them against the
plain versions (``sinkhorn_fwd_reference``, ``sinkhorn_bwd_reference``)
at the CPU test's tolerances (``tests/test_torch_ot.py``): costs rtol
1e-5, histories 1e-5 abs, c_bar rtol 1e-4 / atol 1e-6.  No JAX.
"""

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch.ot.cuda_sinkhorn import sinkhorn_bwd_reference, sinkhorn_fwd_reference

L, EPS, WARP, P = 20, 0.7, 32, 16


def _costs(b, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor((np.abs(rng.normal(size=(3, b, b))) * 3.0 + 0.1).astype(np.float32))


def _lane_sum(x, p):
    """Sum over the last dim as a group of p lanes does: lane q adds the
    elements q, q + p, ... in order, then a butterfly (xor 1, 2, ...)."""
    lanes = []
    for q in range(p):
        acc = torch.zeros(x.shape[:-1])
        for e in range(q, x.shape[-1], p):
            acc = acc + x[..., e]
        lanes.append(acc)
    o = 1
    while o < p:
        lanes = [lanes[i] + lanes[i ^ o] for i in range(p)]
        o <<= 1
    return lanes[0]


def _update(x, lse, log_mu):
    return EPS * (log_mu - lse) + x  # two roundings, no FMA


def _fwd_emulated(c, p):
    """The forward warp kernel: lse by lane groups, u then v, L times."""
    b = c.shape[-1]
    log_mu = -torch.log(torch.tensor(float(b)))
    u, v = torch.zeros(3, b), torch.zeros(3, b)
    us, vs = [], []
    for _ in range(L):
        a = ((-c + u[:, :, None]) + v[:, None, :]) / EPS
        m = a.amax(-1)
        u = _update(u, torch.log(_lane_sum(torch.exp(a - m[..., None]), p)) + m, log_mu)
        a = ((-c + u[:, :, None]) + v[:, None, :]) / EPS  # column j of row-major c
        m = a.amax(-2)
        v = _update(v, torch.log(_lane_sum(torch.exp(a - m[:, None, :]).transpose(1, 2), p)) + m, log_mu)
        us.append(u)
        vs.append(v)
    pi_c = torch.exp(((-c + u[:, :, None]) + v[:, None, :]) / EPS) * c
    return _lane_sum(pi_c.reshape(3, -1), WARP), torch.stack(us), torch.stack(vs)


def _softmax_scaled(a, scale, p):
    """softmax over the last dim, divided by the lane-group sum, times scale."""
    m = a.amax(-1, keepdim=True)
    return torch.exp(a - m) / _lane_sum(torch.exp(a - m), p)[..., None] * scale[..., None]


def _bwd_emulated(c, uhist, vhist, g, p):
    """The backward warp kernel: one row-layout accumulator, b_bar and
    a_bar through the transposing tile."""
    b = c.shape[-1]
    ul, vl = uhist[-1], vhist[-1]
    gp = g[:, None, None] * torch.exp(((-c + ul[:, :, None]) + vl[:, None, :]) / EPS)
    mb = gp * c
    acc = gp - mb / EPS
    ub = _lane_sum(mb, p) / EPS
    vb = _lane_sum(mb.transpose(1, 2), p) / EPS
    zeros = torch.zeros(3, b)
    for it in reversed(range(L)):
        un = uhist[it]
        up = uhist[it - 1] if it else zeros
        vp = vhist[it - 1] if it else zeros
        # column r: b_bar[:, x, r], the softmax over rows x
        a_col = ((-c + un[:, :, None]) + vp[:, None, :]).transpose(1, 2) / EPS  # [k, r, x]
        bb_col = _softmax_scaled(a_col, -EPS * vb, p)
        vb = vb + _lane_sum(bb_col, p) / EPS
        bb = bb_col.transpose(1, 2)  # the tile, read back by rows
        ubi = ub + _lane_sum(bb, p) / EPS
        a_row = ((-c + up[:, :, None]) + vp[:, None, :]) / EPS
        ab = _softmax_scaled(a_row, -EPS * ubi, p)
        acc = (acc - bb / EPS) - ab / EPS
        ub = ubi + _lane_sum(ab, p) / EPS
        vb = vb + _lane_sum(ab.transpose(1, 2), p) / EPS
    return acc


# B = 1, fewer elements than a group (5), the 32-row kernel's edges (31,
# 32), the 64-row kernel's first and last (33, 64)
BATCHES = [1, 5, 31, 32, 33, 64]


@pytest.mark.parametrize("b", BATCHES)
def test_forward_lane_order_matches_plain(b):
    c = _costs(b, seed=b)
    cost, uh, vh = _fwd_emulated(c, P)
    want = sinkhorn_fwd_reference(c, EPS, L)
    torch.testing.assert_close(cost, want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(uh, want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(vh, want[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("b", BATCHES)
def test_backward_tile_order_matches_plain(b):
    c = _costs(b, seed=100 + b)
    _, uh, vh = sinkhorn_fwd_reference(c, EPS, L)
    g = torch.tensor([2.0, -1.0, -1.0])
    got = _bwd_emulated(c, uh, vh, g, P)
    torch.testing.assert_close(got, sinkhorn_bwd_reference(c, uh, vh, g, EPS), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n, b", [(32, 32), (64, 33)])
def test_tiles_hand_each_group_its_row(n, b):
    """The backward's [N][N + 1] tiles at P = 16, addressed as the kernel
    addresses them: thread (r, q) writes b_bar[x][r] of its column r at
    tb[x][r] and reads its row r back from tb[r][x], and writes its row of
    a_bar at ta[r][x] and reads column r from ta[x][r], for x = q + P e <
    B; every live element is written once and read by its owner."""
    x = torch.arange(b * b, dtype=torch.float32).reshape(b, b)  # x[row][col]
    tile = torch.full((n * (n + 1),), float("nan"))
    writes = []
    for r in range(b):
        for q in range(P):
            for e in range(n // P):
                col = q + P * e
                if col < b:
                    writes.append(col * (n + 1) + r)
                    tile[col * (n + 1) + r] = x[col, r]  # column layout in
    assert len(set(writes)) == len(writes) == b * b
    for r in range(b):
        row = [tile[r * (n + 1) + q + P * e] for q in range(P) for e in range(n // P) if q + P * e < b]
        cols = [q + P * e for q in range(P) for e in range(n // P) if q + P * e < b]
        assert torch.equal(torch.stack(row), x[r, cols])  # row layout out
    tile.fill_(float("nan"))
    for r in range(b):
        for col in range(b):
            tile[r * (n + 1) + col] = x[r, col]  # a_bar's row r in
    for r in range(b):
        got = torch.stack([tile[col * (n + 1) + r] for col in range(b)])
        assert torch.equal(got, x[:, r])  # column r out


def test_reciprocal_division_is_correctly_rounded():
    """x / y as the kernels take it, q = x * (1/y) and one FMA correction
    (the FMA emulated exactly in f64), equals the IEEE f32 quotient."""
    rng = np.random.default_rng(0)
    for y in np.float32([0.7, 1.0, 0.3, 1.7, 31.0, 0.123456]):
        x = (rng.normal(size=20000) * rng.choice([1e-3, 1.0, 30.0, 300.0], size=20000)).astype(np.float32)
        inv = np.float32(1.0) / y
        q = x * inv
        r = x.astype(np.float64) - np.float64(y) * q.astype(np.float64)  # exact: the FMA's residual
        got = (q.astype(np.float64) + r.astype(np.float32).astype(np.float64) * np.float64(inv)).astype(np.float32)
        np.testing.assert_array_equal(got, x / y)
