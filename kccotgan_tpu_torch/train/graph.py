"""CUDA-graph replay of a computation whose weights stay fixed.

``GraphReplay(fn)(*inputs)`` runs ``fn(*inputs)`` as a captured CUDA
graph: the first call with inputs of a new signature (shapes, dtypes,
device) copies them into static buffers, runs ``fn`` once on a side
stream (the warm-up, which builds the kernels, picks the cuDNN plans and
fills the caching allocator outside the capture), then captures one
``fn`` on those buffers.  Every call copies its inputs into the buffers
of its signature, replays that graph and clones the result out of the
graph's memory pool.  A graph reads every tensor at the address it saw
when captured, so ``fn`` may read nothing but its inputs and tensors
that stay the same, such as the weights.  The replay runs the captured
kernels in their order, so its result equals ``fn``'s, bit for bit.
CUDA tensors only: on the CPU there is nothing to capture, and callers
call ``fn`` itself.

``StepGraph`` captures one call of a function whose result feeds its
next call, a training step: its state goes in with one multi-tensor
copy and out through one flat buffer, so that a replay costs a handful
of launches besides the graph's own, and what it hands back is the
caller's to keep.
"""

from __future__ import annotations

import math

import torch

__all__ = ["GraphReplay", "StepGraph"]


class GraphReplay:
    """``fn(*inputs) -> tensor`` replayed from one CUDA graph per input
    signature (module docstring).  ``graphs`` maps each signature to its
    ``(graph, static inputs, static output)``."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs: dict = {}

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in inputs)
        if key not in self.graphs:
            self.graphs[key] = self._capture(inputs)
        graph, static, out = self.graphs[key]
        for buf, x in zip(static, inputs):
            buf.copy_(x)
        graph.replay()
        return out.clone()

    def _capture(self, inputs):
        if any(x.device.type != "cuda" for x in inputs):
            raise ValueError("GraphReplay: CUDA tensors only")
        static = [x.clone() for x in inputs]
        side = torch.cuda.Stream(static[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(*static)
        return graph, static, out


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _set(obj, name, value) -> None:
    if isinstance(obj, dict):
        obj[name] = value
    else:
        setattr(obj, name, value)


def _views(flat: torch.Tensor, shapes: list) -> list:
    """``flat`` cut into consecutive tensors of ``shapes``."""
    return [p.view(s) for p, s in zip(flat.split([math.prod(s) for s in shapes]), shapes)]


class StepGraph:
    """``fn(carried, fresh) -> outputs``, captured once as a CUDA graph and
    then replayed by each call.

    ``carried``: tensors of one dtype that each call hands to the next (a
    training state).  The graph reads them from its buffers and
    gathers its ``outputs``, the carried tensors' successors first and in
    their order, then any others of that dtype, into another; each call
    clones that buffer once and returns views of the clone, so later
    replays never overwrite what a caller keeps.  The carried tensors come
    in with one ``torch._foreach_copy_``.  ``fresh``: the other inputs
    (a batch, noise, values computed on the host), each copied into its
    buffer in ``buffers`` with a stream-ordered copy, a host tensor through
    pinned memory; an entry that is its buffer is not copied, so that a
    caller may write a buffer in place.
    ``counters``: ``(object, attribute)`` or ``(dict, key)`` pairs that
    ``fn`` advances as it runs (launch counts, collectives' calls and
    bytes).  The capture launches nothing, so its advance is taken back,
    and each replay adds it: they count what ran.

    Like ``GraphReplay``, the graph reads every other tensor at the
    address it saw when captured: ``fn`` may read nothing but its inputs
    and tensors that stay the same.  The caller runs ``fn`` eagerly at
    least once before the capture, to build the kernels and pick the
    library's algorithms outside it.
    """

    def __init__(self, fn, carried: list, fresh: list, counters=()):
        if len({t.dtype for t in carried}) != 1:
            raise TypeError("StepGraph: the carried tensors must share one dtype")
        dev = carried[0].device
        self.carried = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in carried]
        self.buffers = [torch.empty(x.shape, dtype=x.dtype, device=dev) for x in fresh]

        def run():
            outs = fn(self.carried, self.buffers)
            return torch.cat([t.detach().reshape(-1) for t in outs]), [t.shape for t in outs]

        before = [_get(obj, name) for obj, name in counters]
        self._replay, self._out, self._shapes = self._capture(run)
        if self._shapes[: len(carried)] != [t.shape for t in carried]:
            raise ValueError("StepGraph: fn must return the carried tensors' successors first, in their order")
        self._advance = []
        for (obj, name), n in zip(counters, before):
            self._advance.append((obj, name, _get(obj, name) - n))
            _set(obj, name, n)

    def _capture(self, run):
        """``(replay, flat output, output shapes)`` of ``run()`` captured as
        a CUDA graph."""
        if self.carried[0].device.type != "cuda":
            raise ValueError("StepGraph: CUDA tensors only")
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread (a batch prefetcher pinning host
        # memory) may call into CUDA while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out, shapes = run()
        return graph.replay, out, shapes

    def __call__(self, carried: list, fresh: list) -> list:
        torch._foreach_copy_(self.carried, list(carried))
        # a host tensor goes through pinned memory, which the allocator
        # does not hand out again until the copy from it has run
        pairs = [(buf, x.pin_memory() if buf.is_cuda and x.device.type == "cpu" else x)
                 for buf, x in zip(self.buffers, fresh) if x is not buf]
        if pairs:
            torch._foreach_copy_([b for b, _ in pairs], [x for _, x in pairs], non_blocking=True)
        self._replay()
        for obj, name, n in self._advance:
            _set(obj, name, _get(obj, name) + n)
        return _views(self._out.clone(), self._shapes)
