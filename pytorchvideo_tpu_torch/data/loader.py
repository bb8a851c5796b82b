"""Host batch loading and the prefetch to the card (counterpart of
pytorchvideo_tpu/data/loader.py; upstream's DataLoader workers and their
CUDA prefetch).

Three stages overlap:

    decode and transform (BatchLoader's worker threads; OpenCV and torch's
    CPU ops release the GIL)
      -> collate (the thread that iterates the loader)
      -> copy to the card (:func:`device_prefetch`: a producer thread fills
         a ring of pinned host buffers and copies them on a stream of its
         own while the consumer computes on the previous batch).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np
import torch


class _Sentinel:
    pass


_END = _Sentinel()


def _put(que: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put ``item`` unless ``stop`` is set first; whether it was put."""
    while not stop.is_set():
        try:
            que.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class BatchLoader:
    """Collated batches (``default_collate`` unless ``collate_fn``) of a
    sample-dict dataset, decoded by ``num_workers`` threads.

    A dataset with the ``plan_clips`` / ``load_clip`` split
    (LabeledVideoDataset) decodes in parallel: the workers take the
    sequential planner's work items under a lock and decode them outside
    it, and a failed decode drops its item, as in the JAX package. Any
    other iterable is advanced under the lock. The samples' order then
    depends on the threads' timing.

    Each worker runs torch's CPU ops on one intra-op thread
    (``torch.set_num_threads(1)`` in the worker: PyTorch's OpenMP count is
    per thread, and threads started meanwhile inherit it; the count of the
    thread that iterates is restored at the end): six workers each with a
    pool of all the cores slow small ops tens of times. Leaving the
    iteration early (``close()`` or dropping the generator) stops the
    workers.
    """

    def __init__(self, dataset: Iterable, batch_size: int, num_workers: int = 2,
                 collate_fn: Optional[Callable] = None, prefetch_batches: int = 2,
                 drop_last: bool = True):
        if collate_fn is None:
            from pytorchvideo_tpu_torch.train.transforms import default_collate as collate_fn
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)
        self.collate_fn = collate_fn
        self.prefetch_batches = prefetch_batches
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[Any]:
        sample_q: "queue.Queue" = queue.Queue(maxsize=self.batch_size * (self.prefetch_batches + 1))
        lock = threading.Lock()
        stop = threading.Event()
        active = [self.num_workers]
        parallel = (hasattr(self.dataset, "plan_clips") and hasattr(self.dataset, "load_clip")
                    and self.num_workers > 1)
        source = self.dataset.plan_clips() if parallel else iter(self.dataset)

        def next_item():
            with lock:
                try:
                    return next(source)
                except (StopIteration, RuntimeError):
                    return _END

        def worker():
            torch.set_num_threads(1)
            try:
                while not stop.is_set():
                    item = next_item()
                    if item is _END:
                        break
                    if parallel:
                        try:
                            samples = self.dataset.load_clip(item)
                        except Exception:  # a decode failure drops the video
                            continue
                    else:
                        samples = [item]
                    for sample in samples:
                        if not _put(sample_q, sample, stop):
                            return
            finally:
                with lock:
                    active[0] -= 1
                    last = active[0] == 0
                if last:
                    _put(sample_q, _END, stop)

        caller_threads = torch.get_num_threads()
        threads = [threading.Thread(target=worker, name=f"batch_loader_{i}", daemon=True)
                   for i in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            batch: List[Any] = []
            while True:
                sample = sample_q.get()
                if sample is _END:
                    break
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
            torch.set_num_threads(caller_threads)


def _numeric(leaf) -> Optional[torch.Tensor]:
    """``leaf`` as a CPU tensor when it holds numbers, else None (names and
    other metadata stay on the host)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, (str, bytes)):
        return None
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biuf":
        return None
    return torch.from_numpy(np.ascontiguousarray(arr))


def _map_leaves(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (tree and isinstance(tree[0], str)):
        return type(tree)(_map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


class DevicePrefetch:
    """Iterator over ``batches`` moved to ``device``, ``size`` batches ahead
    of the consumer (:func:`device_prefetch`)."""

    def __init__(self, batches: Iterable, device: Union[str, torch.device] = "cuda",
                 size: int = 2, gather: Optional[Callable] = None,
                 transform: Optional[Callable] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.size = max(1, size)
        # A pinned buffer is refilled only after its last copy completed, so
        # ring_size buffers per leaf keep the queue's batches and the one
        # being filled apart.
        self.ring_size = self.size + 1
        self.pinned_allocations = 0
        self._rings: Dict[tuple, list] = {}
        self._gather = gather
        self._transform = transform
        self._source = iter(batches)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.size)
        self._stop = threading.Event()
        self._error: List[BaseException] = []
        self._done = False
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self._thread = threading.Thread(target=self._produce, name="device_prefetch",
                                        daemon=True)
        self._thread.start()

    # -- producer thread --

    def _pinned(self, key: tuple, shape, dtype: torch.dtype) -> list:
        """The next ring slot [buffer, its last copy's event] of ``key``."""
        ring = self._rings.setdefault((key, tuple(shape), dtype), [])
        if len(ring) < self.ring_size:
            ring.append([torch.empty(tuple(shape), dtype=dtype, pin_memory=True), None])
            self.pinned_allocations += 1
            slot = ring[-1]
        else:
            slot = ring.pop(0)
            ring.append(slot)
            if slot[1] is not None:
                slot[1].synchronize()
        return slot

    def _host_batch(self, item, slots: list):
        """The host batch of ``item``: ``gather(item, out)`` writing into
        pinned ring buffers (on a card) where a gather is given."""
        if self._gather is None:
            return item
        if self.device.type == "cpu":
            return self._gather(item, lambda name, shape, dtype: torch.empty(shape, dtype=dtype))

        def out(name, shape, dtype):
            slots.append(self._pinned((name,), shape, dtype))
            return slots[-1][0]
        return self._gather(item, out)

    def _to_device(self, item):
        slots: list = []
        batch = self._host_batch(item, slots)
        if self.device.type == "cpu":
            def leaf(path, x):
                t = _numeric(x)
                return x if t is None else t
            moved = _map_leaves(leaf, batch)
            return (moved if self._transform is None else self._transform(moved)), None
        filled = {id(slot[0]) for slot in slots}

        def leaf(path, x):
            t = _numeric(x)
            if t is None:
                return x
            if id(t) not in filled:
                slot = self._pinned(path, t.shape, t.dtype)
                slot[0].copy_(t)
                slots.append(slot)
                t = slot[0]
            with torch.cuda.stream(self._copy_stream):
                out = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                out.copy_(t, non_blocking=True)
            return out

        moved = _map_leaves(leaf, batch)
        copied = torch.cuda.Event()
        copied.record(self._copy_stream)
        for slot in slots:
            slot[1] = copied
        if self._transform is None:
            return moved, copied
        with torch.cuda.stream(self._copy_stream):
            moved = self._transform(moved)
        done = torch.cuda.Event()
        done.record(self._copy_stream)
        return moved, done

    def _produce(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            for batch in self._source:
                if self._stop.is_set() or not _put(self._queue, self._to_device(batch), self._stop):
                    return
        except BaseException as e:  # re-raised in the consumer
            self._error.append(e)
        finally:
            close = getattr(self._source, "close", None)
            if close is not None:
                close()
            _put(self._queue, _END, self._stop)

    # -- consumer --

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is _END:
            self._done = True
            self._thread.join()
            if self._error:
                raise self._error[0]
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)

            def keep(path, x):
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(stream)
                return x
            _map_leaves(keep, batch)
        return batch

    def close(self, timeout: float = 30.0) -> None:
        """Stop the producer (mid-epoch too) and wait for its thread; the
        source iterator is closed by it."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("device_prefetch: the producer thread did not stop")

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self._stop.set()


def device_prefetch(batches: Iterable, device: Union[str, torch.device] = "cuda",
                    size: int = 2, gather: Optional[Callable] = None,
                    transform: Optional[Callable] = None) -> DevicePrefetch:
    """Keep ``size`` batches on ``device`` ahead of the consumer: the
    PyTorch counterpart of the JAX package's ``device_prefetch``
    (jax.device_put in a producer thread).

    A producer thread drives ``batches`` (dicts, lists and tuples of numpy
    arrays or CPU tensors) and moves each numeric leaf; names and other
    metadata stay on the host. On a CUDA device:

    - each leaf is copied into a ring of ``size + 1`` pinned host buffers
      per (leaf, shape, dtype), allocated once (``pinned_allocations``
      counts them); a buffer is refilled only after the event of its last
      copy has completed;
    - the copy to the card runs on a stream of the prefetcher's own, with
      ``non_blocking=True``; the consumer's current stream waits on the
      batch's event when the batch is handed over, and each tensor is
      recorded on that stream (``record_stream``) for the caching
      allocator;
    - the producer thread sets its CUDA device first.

    ``gather``: each item of ``batches`` is then a request (a store's clip
    indices) and ``gather(item, out)`` builds the host batch in buffers
    that ``out(name, shape, dtype)`` hands it: the ring's pinned buffers on
    a card, so the batch is written once, with no copy into pinned memory
    and no fresh buffer to fault in (ClipStore.prefetch).

    ``transform``: applied to each batch on the device, in the producer
    thread and on the prefetcher's stream, so that a chain of small ops
    overlaps the consumer's work instead of queueing behind it on the
    consumer's stream (where a replayed CUDA graph fills the command
    buffer and holds the host back until it drains).

    A CPU ``device`` gets the leaves as CPU tensors: no pinning, no stream.
    Nothing falls back: a buffer that cannot be pinned or a copy that fails
    raises, and the producer's error is raised in the consumer. Stopping
    early: ``close()`` (or the ``with`` block's end) stops the producer
    and closes the source iterator; a prefetcher dropped without it stops
    at its next batch.
    """
    return DevicePrefetch(batches, device, size, gather, transform)
