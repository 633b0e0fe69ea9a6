"""The tensor-core LSTM kernels' operand layouts, emulated on the CPU.

The bf16 engine of ``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu`` runs each
step's products on the tensor cores; those kernels run only on the card.
Their index maps do not need it: this file reads the maps out of the CUDA
sources (``gcol``, the thread's element ``tc_row`` / ``tc_unit`` in
``lstm_tile.cuh``; the dR accumulators' column -> (unit, gate) map in
``lstm_bwd.cu``),
rebuilds every product in plain PyTorch as the kernels lay it out, and
checks the result against the plain versions (``lstm_scan_reference``,
``lstm_bwd_reference``), which ``test_torch_lstm.py`` pins to JAX:

* R staged as Rs [Kp][4Kp]: row k, column gcol(g, j); the gate product
  h @ Rs read back through the accumulator slots a thread owns;
* dh^T = Rs dz^T, the other read of the same Rs, its K split in four
  slices whose partials the unit's owner adds in order;
* blocks of 8 rows, the valid half of a 16-row mma tile whose other
  rows are zero, with B padded (B = 5, 33: ragged last blocks);
* each block's dR = h^T dz over its rows and steps and its db, stored as
  the kernels store their partials, then added block by block in rank
  order (the cluster's, and the second launch's beyond one cluster);
* past U = 64 (the L2 kernels, no tensor cores), dR summed from dx and y
  in the second launch's order, and db from 4-row blocks' partials.

All in f32, where the products and sums are the plain versions' own up to
summation order: tolerance 1e-5 of each output's largest entry.  Small
sizes (T = 3): the file takes about a second.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch.models.cuda_lstm import lstm_bwd_reference, lstm_scan_reference

TOL = 1e-5  # of each output's largest entry, f32
ROWS = 8  # kTcRows: a block's rows, the valid half of its m16 tile
TILE = 16  # the mma's m16: rows ROWS .. 15 of every staged operand are zero
_CSRC = Path(__file__).resolve().parent.parent / "kccotgan_tpu_torch" / "csrc"


def _c_expr(text):
    """A C integer expression on non-negative ints as a Python one."""
    return text.replace("threadIdx.x", "tx").replace("/", "//")


def _cuh_fn(name, args):
    """The one-line ``return`` of ``name`` in lstm_tile.cuh, as a lambda."""
    src = (_CSRC / "lstm_tile.cuh").read_text()
    body = re.search(rf"\b{name}\([^)]*\)\s*\{{\s*return (.*?);\s*\}}", src, re.S).group(1)
    return eval(f"lambda {args}: {_c_expr(' '.join(body.split()))}")  # noqa: S307


def _bwd_decl(var):
    """``const int var = ...`` of lstm_bwd.cu's dR store, as a lambda of its inputs."""
    src = (_CSRC / "lstm_bwd.cu").read_text()
    src = src[src.index("// The block's partials") :]
    line = re.search(rf"const int (?:\w+ = [^,;]*, )?{var} = ([^,;]*)[,;]", src).group(1)
    return _c_expr(line)


gcol = _cuh_fn("gcol", "g, j")
tc_row = _cuh_fn("tc_row", "tx")
tc_unit = _cuh_fn("tc_unit", "tx")
col_unit = eval(f"lambda c: {_bwd_decl('jj')}")  # noqa: S307
col_gate = eval(f"lambda c: {_bwd_decl('g')}")  # noqa: S307


def _kt(u):
    return 1 if u <= 16 else (2 if u <= 32 else (4 if u <= 64 else 8))


def _inputs(b, t, u, seed):
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    xproj = randn(b, t, 4 * u)
    h0, c0 = randn(b, u, scale=0.5), randn(b, u, scale=0.5)
    rk = randn(u, 4 * u, scale=u ** -0.5)
    bias = randn(4 * u, scale=0.1)
    return xproj, h0, c0, rk, bias


def _stage_r(rk):
    """Rs [Kp][4Kp] as stage_r_tc writes it (zero elsewhere)."""
    u = rk.shape[0]
    kp = 16 * _kt(u)
    rs = torch.zeros(kp, 4 * kp)
    k, g, j = np.indices((u, 4, u)).reshape(3, -1)  # the maps are plain arithmetic: vectorised
    rs[torch.from_numpy(k), torch.from_numpy(gcol(g, j))] = rk[torch.from_numpy(k), torch.from_numpy(g * u + j)]
    return rs


def _elements(u):
    """Every (row in block, unit, accumulator column of each gate) a
    thread of the block owns: tc_row, tc_unit, and the column tc_gate
    reads (n-tile g//2 of the warp's two, slot g%2 of the m16n8 tile:
    row lane/4, column 2*(lane%4) + g%2)."""
    out = []
    for tx in range(32 * 4 * _kt(u)):
        warp, lane = tx // 32, tx % 32
        cols = [16 * warp + 8 * (g // 2) + 2 * (lane % 4) + g % 2 for g in range(4)]
        assert tc_row(tx) == lane // 4
        out.append((tc_row(tx), tc_unit(tx), cols))
    return out


def _element_index(u):
    """_elements(u) of real units as index tensors: rows, units and the
    gate columns [n, 4]."""
    elems = [(r, j, cols) for r, j, cols in _elements(u) if j < u]
    rows = torch.tensor([r for r, _, _ in elems])
    units = torch.tensor([j for _, j, _ in elems])
    cols = torch.tensor([c for _, _, c in elems])
    return rows, units, cols


def _pad_rows(x, b_pad):
    return torch.cat([x, x.new_zeros(b_pad - x.shape[0], *x.shape[1:])])


def _emulate_fwd(xproj, h0, c0, rk, bias):
    """The forward, block by block: h in position order, the gate product
    on Rs, the gates gathered from the accumulator columns each thread owns."""
    b, t_total, u4 = xproj.shape
    u = u4 // 4
    kp = 16 * _kt(u)
    rs = _stage_r(rk)
    rows, units, cols = _element_index(u)
    gates = torch.arange(4)[None] * u + units[:, None]  # [n, 4]: g*U + j
    b_pad = -(-b // ROWS) * ROWS
    xp, hp, cp = (_pad_rows(v, b_pad) for v in (xproj, h0, c0))
    ys, cs = torch.zeros(b_pad, t_total, u), torch.zeros(b_pad, t_total, u)
    hn, cn = torch.zeros(b_pad, u), torch.zeros(b_pad, u)
    for r0 in range(0, b_pad, ROWS):
        hb = torch.zeros(TILE, kp)
        c = cp[r0 : r0 + ROWS].clone()
        h = hp[r0 : r0 + ROWS].clone()
        for j in range(u):
            hb[:ROWS, j] = h[:, j]
        for t in range(t_total):
            acc = hb @ rs  # [16, 4Kp]: rows ROWS .. 15 are the tile's zero padding
            z = (xp[r0 + rows[:, None], t, gates] + bias[gates]) + acc[rows[:, None], cols]
            ce = torch.sigmoid(z[:, 1]) * c[rows, units] + torch.sigmoid(z[:, 0]) * torch.tanh(z[:, 2])
            c[rows, units] = ce
            h[rows, units] = torch.sigmoid(z[:, 3]) * torch.tanh(ce)
            hb = torch.zeros(TILE, kp)
            hb[rows, units] = h[rows, units]
            for j in range(u):  # the coalesced y store reads h back by position
                ys[r0 : r0 + ROWS, t, j] = hb[:ROWS, j]
            cs[r0 : r0 + ROWS, t] = c
        hn[r0 : r0 + ROWS], cn[r0 : r0 + ROWS] = h, c
    return ys[:b], cs[:b], hn[:b], cn[:b]


def _emulate_bwd(xproj, h0, c0, rk, bias, y, c_stack, dy, dh_n, dc_n):
    """The backward, block by block: the recompute as the forward, dz
    staged at its gate columns, dh^T = Rs dz^T in four K slices, the
    block's dR = h^T dz and db stored as the
    kernel's partials (part[k*4U + 4j + g], part[4U*U + 4j + g]), then
    the blocks' partials added in rank order and unpacked as finish_wgrad does."""
    b, t_total, u4 = xproj.shape
    u = u4 // 4
    kp = 16 * _kt(u)
    rs = _stage_r(rk)
    rows, units, cols = _element_index(u)
    gates = torch.arange(4)[None] * u + units[:, None]  # [n, 4]: g*U + j
    b_pad = -(-b // ROWS) * ROWS
    valid = (torch.arange(b_pad) < b).float()
    xp, h0p, c0p, yp, csp, dyp, dhp, dcp = (
        _pad_rows(v, b_pad) for v in (xproj, h0, c0, y, c_stack, dy, dh_n, dc_n))
    dx = torch.zeros(b_pad, t_total, u4)
    dh0, dc0 = torch.zeros(b_pad, u), torch.zeros(b_pad, u)
    parts = []
    for r0 in range(0, b_pad, ROWS):
        sl = slice(r0, r0 + ROWS)
        dh, dc = dhp[sl].clone(), dcp[sl].clone()
        dracc = torch.zeros(kp, 4 * kp)
        dbacc = torch.zeros(4 * kp)
        for t in reversed(range(t_total)):
            h_prev = h0p[sl] if t == 0 else yp[sl, t - 1]
            c_prev = c0p[sl] if t == 0 else csp[sl, t - 1]
            hb = torch.zeros(TILE, kp)
            for j in range(u):
                hb[:ROWS, j] = h_prev[:, j] * valid[sl]
            acc = hb @ rs
            z = (xp[r0 + rows[:, None], t, gates] + bias[gates]) + acc[rows[:, None], cols]
            i, fg = torch.sigmoid(z[:, 0]), torch.sigmoid(z[:, 1])
            gg, o = torch.tanh(z[:, 2]), torch.sigmoid(z[:, 3])
            cp = c_prev[rows, units]
            tc = torch.tanh(fg * cp + i * gg)
            dhv = dh[rows, units] + dyp[r0 + rows, t, units]
            dcv = dc[rows, units] + dhv * o * (1 - tc * tc)
            dz = torch.stack([dcv * gg * i * (1 - i), dcv * cp * fg * (1 - fg), dcv * i * (1 - gg * gg),
                              dhv * tc * o * (1 - o)], dim=1) * valid[r0 + rows, None]
            dc[rows, units] = dcv * fg
            dzs = torch.zeros(TILE, 4 * kp)
            dzs[rows[:, None], cols] = dz  # padding rows stage zero
            for g, j in np.ndindex(4, u):  # the coalesced dx store
                dx[sl, t, g * u + j] = dzs[:ROWS, gcol(g, j)]
            dbacc += dzs.sum(0)
            # dh^T = Rs dz^T over the 8 rows, K in four slices of 16*KT
            # gate columns, the partials added in slice order by the owner
            kq = 4 * kp // 4
            parts_dh = [rs[:, q * kq : (q + 1) * kq] @ dzs[:ROWS, q * kq : (q + 1) * kq].T for q in range(4)]
            d = ((parts_dh[0] + parts_dh[1]) + parts_dh[2]) + parts_dh[3]  # [Kp units, 8 rows]
            dh[rows, units] = d[units, rows]
            dracc += hb.T @ dzs  # [Kp positions, 4Kp columns]
        dh0[sl], dc0[sl] = dh, dc
        part = torch.zeros(4 * u * u + 4 * u)
        for m, c in np.ndindex(kp, 4 * kp):
            k, j, g = m, col_unit(c), col_gate(c)
            if k < u and j < u:
                part[k * u4 + 4 * j + g] = dracc[m, c]
        for g, j in np.ndindex(4, u):
            part[u4 * u + 4 * j + g] = dbacc[gcol(g, j)]
        parts.append(part)
    total = torch.zeros_like(parts[0])
    for part in parts:  # rank order, one cluster or the second launch
        total += part
    m = np.arange(u4 * u + u4) % u4
    idx = torch.from_numpy((m % 4) * u + m // 4)
    drk = torch.zeros(u, u4)
    drk.view(-1)[torch.from_numpy(np.arange(u4 * u) // u4 * u4) + idx[: u4 * u]] = total[: u4 * u]
    db = torch.zeros(u4)
    db[idx[u4 * u :]] = total[u4 * u :]
    return dx[:b], dh0[:b], dc0[:b], drk, db


def _assert_rel(got, want, name):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * scale, f"{name}: {err} > {TOL} * {scale}"


@pytest.mark.parametrize("u", [3, 5, 8, 20, 32, 64, 100, 128])
def test_maps_are_consistent(u):
    """Every (row, unit) of a block has one owner thread; the gate columns
    it reads are gcol's; the dR store's column map inverts gcol."""
    kp = 16 * _kt(u)
    owned = {}
    for row, j, cols in _elements(u):
        assert (row, j) not in owned
        owned[row, j] = cols
        assert cols == [gcol(g, j) for g in range(4)]
    assert set(owned) == {(r, j) for r in range(ROWS) for j in range(kp)}
    assert sorted(gcol(g, j) for g in range(4) for j in range(kp)) == list(range(4 * kp))
    assert all((col_unit(gcol(g, j)), col_gate(gcol(g, j))) == (j, g) for g in range(4) for j in range(kp))


def test_staged_r_layout():
    u = 5
    rk = torch.arange(1, u * 4 * u + 1, dtype=torch.float32).reshape(u, 4 * u)
    rs = _stage_r(rk)
    assert rs.shape == (16, 64)
    assert int((rs != 0).sum()) == rk.numel()
    for k, n in np.ndindex(u, 4 * u):
        assert rs[k, gcol(n // u, n % u)] == rk[k, n]


@pytest.mark.parametrize("b,u", [(5, 3), (33, 8), (5, 32), (33, 5), (18, 64), (9, 100)])
def test_forward_layout_matches_reference(b, u):
    args = _inputs(b, 3, u, seed=b + u)
    want = lstm_scan_reference(*args, "tanh")
    got = _emulate_fwd(*args)
    for g, w, name in zip(got, want, ("y", "c_stack", "h", "c")):
        _assert_rel(g, w, name)


@pytest.mark.parametrize("b,u", [(5, 3), (33, 8), (5, 32), (33, 5), (18, 64)])
def test_backward_layout_and_block_partials_match_reference(b, u):
    args = _inputs(b, 3, u, seed=10 + b + u)
    y, cs, h, c = lstm_scan_reference(*args, "tanh")
    rng = np.random.default_rng(b * u)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in (y.shape, h.shape, c.shape)]
    want = lstm_bwd_reference(*args, y, cs, *cot, "tanh")
    got = _emulate_bwd(*args, y, cs, *cot)
    for g, w, name in zip(got, want, ("dx", "dh0", "dc0", "dR", "db")):
        _assert_rel(g, w, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_path_weight_gradient_from_dx_matches_reference(dtype):
    """Past U = 64 (the L2 kernels) the backward's recurrence writes only
    dx = cdt(dz) and each block's db partial (4 rows a block); the second
    launch sums dR[k][m] = cdt(h_{t-1})[b][k] dx[b][t][m] over rows b,
    then steps t, and db over the partials in block order.  Both equal the
    plain version's dR and db (db checked in f32, where dx is dz)."""
    b, t, u = 6, 3, 96
    xproj, h0, c0, rk, bias = _inputs(b, t, u, seed=7)
    args = (xproj.to(dtype), h0, c0, rk, bias)
    y, cs, _, _ = lstm_scan_reference(*args, "tanh")
    rng = np.random.default_rng(8)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32)).to(dtype)
    dh, dc = (torch.from_numpy(rng.standard_normal((b, u)).astype(np.float32)) for _ in range(2))
    dx, _, _, drk, db = lstm_bwd_reference(*args, y, cs, dy, dh, dc, "tanh")
    hprev = torch.cat([h0.to(dtype)[:, None], y[:, :-1]], dim=1).float()  # cdt(h_{t-1}), h_{-1} = h0
    dr = torch.zeros(u, 4 * u)
    for row, step in np.ndindex(b, t):
        dr = dr + torch.outer(hprev[row, step], dx[row, step].float())
    _assert_rel(dr, drk, "dR")
    if dtype == torch.float32:
        total = torch.zeros(4 * u)
        for r0 in range(0, b, 4):  # the blocks' partials, in block order
            total = total + dx[r0 : r0 + 4].sum((0, 1))
        _assert_rel(total, db, "db")
