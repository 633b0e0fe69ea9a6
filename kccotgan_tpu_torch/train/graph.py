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
"""

from __future__ import annotations

import torch

__all__ = ["GraphReplay"]


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
