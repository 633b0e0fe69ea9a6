"""Host-side streaming pipeline, and the copy of each batch to the card.

Counterpart of ``kccotgan_tpu/data/pipeline.py``.  The iterator
combinators are the JAX package's, unchanged, and yield the same items in
the same order for the same seed (``tests/test_torch_data.py``):
``shuffle_stream`` (tf.data's reservoir ``shuffle``), ``interleave``
(cycle/block round-robin over open files), ``parallel_map`` (ordered
threaded map), ``ArrayDataset`` and ``GeneratorDataset``.
``device_prefetch`` takes the place of the JAX thread around
``jax.device_put``: a background thread pins each host batch, and the
copy to the card runs on a side stream one batch ahead of the consumer.
"""

from __future__ import annotations

import collections
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

import numpy as np
import torch

_T = TypeVar("_T")
_U = TypeVar("_U")

__all__ = [
    "ArrayDataset",
    "GeneratorDataset",
    "device_prefetch",
    "shuffle_stream",
    "interleave",
    "parallel_map",
]


def shuffle_stream(
    it: Iterable[_T], buffer_size: int, *, seed: int | None = None
) -> Iterator[_T]:
    """tf.data ``shuffle(buffer_size)`` semantics: keep a buffer of
    ``buffer_size`` items; each yield swaps a uniformly random buffer
    slot for the next upstream item, draining at end of stream."""
    if buffer_size <= 1:
        yield from it
        return
    rng = random.Random(seed)
    buf: list[_T] = []
    for item in it:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        j = rng.randrange(buffer_size)
        out, buf[j] = buf[j], item
        yield out
    rng.shuffle(buf)
    yield from buf


def interleave(
    source: Iterable[_T],
    make_inner: Callable[[_T], Iterable[_U]],
    *,
    cycle_length: int = 4,
    block_length: int = 16,
) -> Iterator[_U]:
    """tf.data ``interleave`` semantics: keep ``cycle_length`` inner
    iterators open concurrently, emitting ``block_length`` consecutive
    items from each in round-robin; an exhausted slot is refilled from
    ``source``.  Mixes records across files at block granularity —
    the record-level shuffle the reference's GQN pipeline gets from
    `data_utils.py:420-421`."""
    source_it = iter(source)
    slots: collections.deque[Iterator[_U]] = collections.deque()

    def refill() -> bool:
        try:
            slots.append(iter(make_inner(next(source_it))))
            return True
        except StopIteration:
            return False

    while len(slots) < cycle_length and refill():
        pass
    while slots:
        inner = slots.popleft()
        emitted = 0
        exhausted = False
        for item in inner:
            yield item
            emitted += 1
            if emitted >= block_length:
                break
        else:
            exhausted = True
        if exhausted:
            refill()
        else:
            slots.append(inner)


def parallel_map(
    fn: Callable[[_T], _U],
    it: Iterable[_T],
    *,
    workers: int = 4,
    prefetch: int | None = None,
) -> Iterator[_U]:
    """Order-preserving threaded map (tf.data ``map(num_parallel_calls)``).

    Keeps up to ``prefetch`` (default ``2 * workers``) items in flight so
    decode work overlaps the consumer's device step.  PIL/cv2/numpy all
    release the GIL in their decode hot paths, so threads suffice — no
    pickling tax of a process pool."""
    if workers <= 0:
        yield from map(fn, it)
        return
    if prefetch is None:
        prefetch = 2 * workers
    src = iter(it)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: collections.deque = collections.deque()
        try:
            for item in src:
                pending.append(pool.submit(fn, item))
                if len(pending) >= prefetch:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()


class ArrayDataset:
    """In-memory film-strip dataset ``[N, H, T, W, C]`` with epoch
    shuffling and ragged-tail dropping (the reference skips ragged
    batches, `kernel_train.py:298-299`)."""

    def __init__(self, data: np.ndarray, batch_size: int, *, seed: int = 0, drop_remainder: bool = True):
        if data.ndim != 5:
            raise ValueError(f"expected [N,H,T,W,C] film-strip, got {data.shape}")
        self.data = data
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.data) // self.batch_size

    def epoch(self, shuffle: bool = True) -> Iterator[np.ndarray]:
        idx = np.arange(len(self.data))
        if shuffle:
            self._rng.shuffle(idx)
        n_full = len(idx) // self.batch_size
        for i in range(n_full):
            sel = idx[i * self.batch_size : (i + 1) * self.batch_size]
            yield self.data[sel]

    def repeat(self, epochs: int, shuffle: bool = True) -> Iterator[np.ndarray]:
        for _ in range(epochs):
            yield from self.epoch(shuffle)


class GeneratorDataset:
    """Wraps a Python sample generator factory into batched epochs
    (KTH/Penn-style loaders, `data_utils.py:114-205`).

    ``shuffle=True`` routes samples through a real reservoir shuffle
    buffer (``shuffle_buffer`` slots) before batching."""

    def __init__(
        self,
        gen_factory: Callable[[], Iterator[np.ndarray]],
        batch_size: int,
        *,
        shuffle_buffer: int = 100,
        seed: int | None = None,
    ):
        self.gen_factory = gen_factory
        self.batch_size = batch_size
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed

    def repeat(self, epochs: int, shuffle: bool = True) -> Iterator[np.ndarray]:
        for epoch in range(epochs):
            stream: Iterator[np.ndarray] = self.gen_factory()
            if shuffle and self.shuffle_buffer > 1:
                seed = None if self.seed is None else self.seed + epoch
                stream = shuffle_stream(stream, self.shuffle_buffer, seed=seed)
            buf = []
            for sample in stream:
                buf.append(np.asarray(sample, dtype=np.float32))
                if len(buf) == self.batch_size:
                    yield np.stack(buf)
                    buf = []


def device_prefetch(it: Iterator[np.ndarray], *, device, size: int = 2) -> Iterator[torch.Tensor]:
    """Yield the host batches of ``it`` as float32 tensors on ``device``.

    On ``cuda``: a background thread pulls ``it`` and copies each batch
    into pinned host memory, at most ``size`` ahead; the copy to the card
    is issued on a side stream, with an event that the consuming stream
    waits on.  Each batch is yielded as soon as its own copy is issued;
    the next batch's copy is issued with it if that batch is pinned by
    then (so it overlaps the step), else when the consumer asks for it.
    On ``cpu``: each batch as a tensor, no thread.  An error of ``it`` is
    raised in the consumer.
    """
    device = torch.device(device)
    if device.type == "cpu":
        for batch in it:
            yield torch.as_tensor(np.asarray(batch, dtype=np.float32))
        return
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device_prefetch: no CUDA device for {device}")

    q: queue.Queue = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for batch in it:
                if not put(torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)).pin_memory()):
                    return
        except Exception as e:  # raised on the consumer's side
            put(e)
            return
        put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    side = torch.cuda.Stream(device)

    def stage(block: bool):
        """The next item off the queue, its copy to the card issued on the
        side stream; None if ``block`` is false and none is pinned yet."""
        try:
            item = q.get(block=block)
        except queue.Empty:
            return None
        if item is done or isinstance(item, Exception):
            return item
        with torch.cuda.stream(side):
            batch = item.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return batch, ready

    try:
        ahead = None
        while True:
            cur = ahead if ahead is not None else stage(block=True)
            if cur is done:
                return
            if isinstance(cur, Exception):
                raise cur
            batch, ready = cur
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            batch.record_stream(consumer)
            # the next copy goes out now if its batch is already pinned;
            # this batch is never held back waiting for it
            ahead = stage(block=False)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
