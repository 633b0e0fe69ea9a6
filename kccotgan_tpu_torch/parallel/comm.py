"""Collectives of the port's meshes, each with its gradient written out.

The exactness of the mesh modes rests on which backward each collective
takes, so none comes from ``torch.distributed.nn`` (whose ``all_gather``
takes a reduce-scatter as its backward: right where each rank goes on
with its own part, N times too large where every rank then computes the
same loss, and a collective gloo does not have on CUDA tensors).

* ``all_reduce_sum(x, group)``: the sum over the group's ranks.
  Backward: ``all_reduce_sum`` of the gradient (each rank's input reaches
  every rank's output).  Under ``torch.func.vmap`` it reduces all
  instances in one call (the sums are elementwise).
* ``gather_replicated(x, dim, group)``: the ranks' parts concatenated
  along ``dim``, for a caller that then computes the same thing on every
  rank (the Sinkhorn loss on the gathered features).  Every rank then
  holds the same gradient of the whole, so the backward is the rank's
  own slice of it, with no sum.
* ``gather_resharded(x, dim, group)``: the same forward, for a caller
  whose ranks each go on with a different part of the whole (the
  pyramid's shift by ``Tc - 1`` frames under sequence parallelism).
  Backward: the gradients of the whole summed over the ranks, then the
  rank's own slice.
* ``broadcast_replicated(src, group, *xs)``: the tensors of the group's
  rank ``src`` on every rank (in one message), for callers that then
  compute the same thing from them on every rank (the ring relay's final
  carry, JAX's ``psum`` of the last chunk's).  Every rank then holds the
  same gradient, so the backward hands ``src`` its own and the others
  zero, with no collective.
* ``global_amax(x, group)``: the largest element over every rank's
  ``x`` (the smoothing's normalizer over a batch split by rows).  Each
  rank's loss takes its own part of the whole's gradient, so the
  backward sums the incoming gradients over the ranks and splits the sum
  evenly among the elements equal to the maximum on every rank, as
  ``amax``'s backward does among ties.
* ``send_carry`` / ``recv_carry``: one message of a few tensors between
  two ranks of a group (the ring relay's ``(h, c)`` and its gradient),
  under a tag that names the layer and the phase.

Transport: gloo takes CUDA tensors in its collectives but not in
``send`` / ``recv``; there the message goes through pinned host memory
(``_HOST_STAGED``, looked up by the backend's name).  That is a copy on
the way, not a computation on the CPU.

``COUNTERS`` counts each operation's calls, the bytes of its inputs and
outputs on this rank, and the host's seconds in it (``reset_counters``).
A training step replayed from a CUDA graph (``train/steps.py``) adds to
``calls`` and ``bytes`` what its capture issued, each replay, so they
count what ran, graphed or eager; ``host_s`` counts only the host's
seconds in eager calls (the enqueue, under NCCL), the capture's among
them: a replay issues its collectives with no call on the host.
"""

from __future__ import annotations

import time
import zlib

import torch
import torch.distributed as dist

__all__ = [
    "COUNTERS", "all_reduce_sum", "all_reduce_sum_", "all_reduce_sum_flat", "broadcast_", "broadcast_replicated", "gather_replicated",
    "gather_resharded", "global_amax", "recv_carry", "reset_counters", "send_carry", "tag_of",
]

_HOST_STAGED = {"gloo": ("send", "recv")}
_OPS = ("all_reduce", "all_gather", "send", "recv", "broadcast")
COUNTERS = {op: {"calls": 0, "bytes": 0, "host_s": 0.0} for op in _OPS}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.update(calls=0, bytes=0, host_s=0.0)


def _count(op: str, nbytes: int, t0: float) -> None:
    c = COUNTERS[op]
    c["calls"] += 1
    c["bytes"] += nbytes
    c["host_s"] += time.perf_counter() - t0


def _staged(op: str, x: torch.Tensor, group) -> bool:
    return x.is_cuda and op in _HOST_STAGED.get(dist.get_backend(group), ())


def tag_of(name: str, phase: str) -> int:
    """The point-to-point tag of a layer's ring in one phase."""
    return zlib.crc32(f"{name}/{phase}".encode()) & 0x7FFFFFFF


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place, outside autograd (the train
    step's gradients); returns ``x``."""
    t0 = time.perf_counter()
    dist.all_reduce(x, group=group)
    _count("all_reduce", 2 * x.numel() * x.element_size(), t0)
    return x


def all_reduce_sum_flat(tensors, group) -> list:
    """``tensors`` summed over ``group`` in one all-reduce of their
    concatenation in f32, outside autograd; each comes back in its own
    shape and dtype."""
    flat = all_reduce_sum_(torch.cat([t.reshape(-1).float() for t in tensors]), group)
    return [part.view(t.shape).to(t.dtype) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of the group's rank ``src`` on every rank, in place; returns
    ``x``."""
    t0 = time.perf_counter()
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    _count("broadcast", x.numel() * x.element_size(), t0)
    return x


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    _count("all_gather", (1 + len(parts)) * x.numel() * x.element_size(), t0)
    return out


def _own_slice(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = g.shape[dim] // dist.get_world_size(group)
    return g.narrow(dim, dist.get_rank(group) * n, n).contiguous()


class AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return AllReduceSum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return AllReduceSum.apply(x, group), None
        return AllReduceSum.apply(x, group), in_dims[0]


class GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group), None, None


class GatherResharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(all_reduce_sum_(g.contiguous().clone(), ctx.group), ctx.dim, ctx.group), None, None


class BroadcastReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, group, *xs):
        ctx.mine = dist.get_rank(group) == src
        flat = broadcast_(torch.cat([x.reshape(-1) for x in xs]), src, group)
        return tuple(p.view(x.shape) for p, x in zip(flat.split([x.numel() for x in xs]), xs))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(g if ctx.mine else torch.zeros_like(g) for g in grads))


def broadcast_replicated(src: int, group, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``xs`` (one dtype) of the group's rank ``src`` on every rank; the
    gradient goes to ``src`` alone (module docstring)."""
    return BroadcastReplicated.apply(src, group, *xs)


class GlobalAmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        top = x.amax().reshape(1)
        t0 = time.perf_counter()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        _count("all_reduce", 2 * top.element_size(), t0)
        ctx.save_for_backward(x, top)
        ctx.group = group
        return top[0]

    @staticmethod
    def backward(ctx, g):
        x, top = ctx.saved_tensors
        ties = x == top
        # the gradient's sum and the ties' count over the ranks, in one call
        both = all_reduce_sum_(torch.stack([g.float(), ties.sum().float()]), ctx.group)
        return ties * (both[0] / both[1]).to(x.dtype), None


def global_amax(x: torch.Tensor, group) -> torch.Tensor:
    """The largest element of ``x`` over ``group``'s ranks, 0-d (module
    docstring)."""
    return GlobalAmax.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks (module docstring)."""
    return AllReduceSum.apply(x, group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` in rank order along ``dim``; the
    gradient is the own slice (module docstring)."""
    return GatherReplicated.apply(x, dim, group)


def gather_resharded(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` in rank order along ``dim``; the
    gradient is summed over the ranks, then sliced (module docstring)."""
    return GatherResharded.apply(x, dim, group)


def send_carry(tensors, dst: int, group, tag: int) -> None:
    """Send ``tensors`` (one dtype) as one message to the group's rank
    ``dst``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    t0 = time.perf_counter()
    if _staged("send", flat, group):
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat)
        flat = host
    dist.send(flat, dst=dist.get_global_rank(group, dst), group=group, tag=tag)
    _count("send", flat.numel() * flat.element_size(), t0)


def recv_carry(like, src: int, group, tag: int) -> list[torch.Tensor]:
    """Receive from the group's rank ``src`` the message ``send_carry``
    made of tensors shaped and typed as ``like``; returned on their
    device."""
    n = sum(t.numel() for t in like)
    dev, dtype = like[0].device, like[0].dtype
    t0 = time.perf_counter()
    staged = _staged("recv", like[0], group)
    flat = torch.empty(n, dtype=dtype, pin_memory=staged) if staged else torch.empty(n, dtype=dtype, device=dev)
    dist.recv(flat, src=dist.get_global_rank(group, src), group=group, tag=tag)
    if staged:
        flat = flat.to(dev, non_blocking=True)
    _count("recv", n * flat.element_size(), t0)
    return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in like]), like)]
