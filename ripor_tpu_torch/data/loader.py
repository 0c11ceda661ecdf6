"""Host-side data loading: background collation + device prefetch.

Port of ripor_tpu/data/loader.py: ``PrefetchLoader`` and ``epoch_batches``
are copies; ``device_prefetch`` moves batches with pinned host tensors and
asynchronous copies where the JAX module uses jax.device_put, and takes a
mesh for its ``sharding``.

The reference keeps its accelerators fed with torch DataLoader worker
processes (dataset/dataloader.py:42-185). Here a thread runs the
(pure-Python) sample+collate path ahead of the training loop, plus an
N-deep device prefetch queue so the host->device transfer of batch t+1
overlaps the device step t.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional



class PrefetchLoader:
    """Wrap a batch iterable with a background producer thread.

    ``batches`` may be any iterable of numpy-batch dicts (e.g. the
    generators from data/collators.py). ``buffer`` batches are collated
    ahead. Exceptions in the producer re-raise in the consumer.
    """

    _DONE = object()

    def __init__(self, batches: Iterable[Dict], buffer: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _produce(self, it: Iterator[Dict]) -> None:
        try:
            for b in it:
                self._q.put(b)
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item


def device_prefetch(batches: Iterable[Dict], size: int = 2,
                    device=None, sharding=None) -> Iterator[Dict]:
    """Move numpy batches to ``device`` (default "cuda", which raises
    without CUDA) ``size`` steps ahead of consumption, so the
    host-to-device copy of batch t+1 overlaps step t: each array is copied
    into a pinned host tensor and sent with ``non_blocking=True`` (tensors
    already on the device pass through).

    ``sharding``: a mesh. Each batch (the same global batch on every
    rank) lands as this rank's 'data' slice along its leading dim, a
    parallel/sharding.py::DataSlice, which ``Trainer.run`` on that mesh
    takes as it is (the JAX ``NamedSharding(mesh, P('data'))``; for
    grad_accum > 1, whose batches split the micro-batch dim, pass global
    batches instead)."""
    import torch

    from ripor_tpu_torch.decode.beam import resolve_device
    from ripor_tpu_torch.parallel.sharding import DataSlice, shard_batch
    device = resolve_device(device)
    pin = device.type == "cuda"

    def put(b):
        if sharding is not None:
            b = shard_batch(b, sharding)
        out = {}
        for k, v in b.items():
            t = torch.as_tensor(v)
            if pin and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return DataSlice(out) if sharding is not None else out

    buf: "collections.deque" = collections.deque()
    it = iter(batches)
    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield out


def epoch_batches(make_epoch: Callable[[int], Iterable[Dict]],
                  num_epochs: int) -> Iterator[Dict]:
    """Chain per-epoch batch iterables (reference epoch loop,
    tasks/trainer.py:582-727)."""
    for e in range(num_epochs):
        yield from make_epoch(e)
