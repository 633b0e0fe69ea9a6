"""Sequence (time-axis) parallelism: the ring-relay scan.

Counterpart of ``kccotgan_tpu/parallel/seqpar.py``.  The time axis of a
recurrence is split over the ranks of a seq group, rank r holding chunk
r.  Rank r waits for the carry ``(h, c)`` that rank r - 1 ends its chunk
with (rank 0 starts from the given one), runs its ``T / S`` steps through
the same recurrence (the ConvLSTM or LSTM kernels from a non-zero carry,
or the plain loop) and sends its final carry to rank r + 1.  The carry
after the last step then reaches every rank, as JAX's ``psum`` of the
last chunk's carry does (``broadcast_replicated`` from the last rank:
every rank is taken to compute the same from it, so its gradient goes to
the last rank alone, as JAX's transpose of that ``psum`` hands each
device its own).  Like JAX's, the relay scales memory, not
time: the chunks run one after another.

Backward runs the reverse ring inside the same autograd node: the rank
that sent ``(h_n, c_n)`` receives ``(dh_n, dc_n)`` from rank r + 1 (the
last rank has none to wait for), runs the recurrence's backward (the
kernels' adjoint for the kernel engine) and sends ``(dh0, dc0)`` to rank
r - 1.  The gradients of the weights are this chunk's part: the caller
sums them over the group (the train step's gradient all-reduce does).

Why this cannot deadlock: each relay, forward and backward, is one
autograd node whose receive, computation and send run together, and
every rank holds the same node (rank 0 receives nothing, the last rank
sends nothing).  Every rank builds the same graph from the same code and
runs its backward on one device's autograd thread, in the order its
sequence numbers give, so every rank meets the relays and the
collectives in the same order.  Inside a relay, rank 0 needs nobody and
rank r needs only rank r - 1 (forward) or r + 1 (backward), which is in
the same node; a rank that has finished it may go on to a collective,
which waits until every rank has finished too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .comm import broadcast_replicated, recv_carry, send_carry, tag_of

__all__ = ["time_sharded_scan"]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, xs, h0, c0, *params):
        scan, group, name = plan
        r, s = dist.get_rank(group), dist.get_world_size(group)
        if r > 0:
            h0, c0 = recv_carry((h0, c0), r - 1, group, tag_of(name, "fwd"))
        ctx.plan, ctx.r, ctx.s = plan, r, s
        if any(ctx.needs_input_grad):
            # The recurrence's own graph, kept for the backward: the carry
            # in needs a gradient on every rank that has one to send back.
            ins = [xs, h0, c0, *params]
            wants = [ctx.needs_input_grad[1], r > 0 or ctx.needs_input_grad[2],
                     r > 0 or ctx.needs_input_grad[3], *ctx.needs_input_grad[4:]]
            ins = [x.detach().requires_grad_(w) for x, w in zip(ins, wants)]
            with torch.enable_grad():
                ys, (h, c) = scan(*ins)
            ctx.graph = ins, wants, (ys, h, c)
        else:
            ys, (h, c) = scan(xs, h0, c0, *params)
        if r < s - 1:
            send_carry((h.detach(), c.detach()), r + 1, group, tag_of(name, "fwd"))
        return ys.detach(), h.detach(), c.detach()

    @staticmethod
    def backward(ctx, dys, dh, dc):
        (_, group, name), r, s = ctx.plan, ctx.r, ctx.s
        ins, wants, outs = ctx.graph
        if r < s - 1:
            dh_next, dc_next = recv_carry((dh, dc), r + 1, group, tag_of(name, "bwd"))
            dh, dc = dh + dh_next, dc + dc_next
        needed = [x for x, w in zip(ins, wants) if w]
        got = iter(torch.autograd.grad(outs, needed, (dys, dh, dc), allow_unused=True))
        grads = [next(got) if w else None for w in wants]
        grads = [torch.zeros_like(x) if w and g is None else g for x, w, g in zip(ins, wants, grads)]
        del ctx.graph
        if r > 0:
            send_carry((grads[1], grads[2]), r - 1, group, tag_of(name, "bwd"))
            grads[1] = grads[2] = None  # this rank's h0, c0 were replaced by the relayed carry
        return (None, *grads)


def time_sharded_scan(scan, xs, h0, c0, *params, group, name: str):
    """``scan(xs, h0, c0, *params) -> (ys, (h_n, c_n))`` over a time axis
    split across ``group`` (module docstring).  ``xs`` is this rank's
    chunk (time on axis 1), ``(h0, c0)`` the initial carry (read on rank 0
    only), ``name`` names the layer in the relay's tags.  Returns this
    chunk's ``ys`` and the carry after the last global step, the same on
    every rank.  With no group it is ``scan`` itself."""
    if group is None:
        return scan(xs, h0, c0, *params)
    ys, h, c = _Ring.apply((scan, group, name), xs, h0, c0, *params)
    h, c = broadcast_replicated(dist.get_world_size(group) - 1, group, h, c)
    return ys, (h, c)
