"""Fixed-shape batching and the input pipeline, the port's copy of
``univl_tpu/data/batching.py``'s ``collate``, ``Batcher`` (with its
per-rank slices), ``pad_rows``,
``cast_floats`` and ``prefetch_to_device``.

Samples are fixed-shape numpy arrays, fetched by a thread pool and stacked.
``prefetch_to_device`` builds the next batches on a worker thread while the
step runs; with ``DeviceTransfer`` as its ``put`` the worker also stages
each batch in pinned memory and starts its copy to the card on a side
stream, and the consumer's stream waits for that copy before the step reads
the batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


class Batcher:
    """Deterministic shuffling batcher.

    Yields ``[batch_size, ...]`` dicts; with ``grad_accum > 1``,
    ``[grad_accum, batch_size, ...]`` (the trainer's layout). ``batch_size``
    is the global batch; with ``process_count > 1`` every rank walks the same
    seeded order and builds only its slice of each micro-batch, rows
    ``[process_index * local, (process_index + 1) * local)`` with ``local =
    batch_size // process_count`` (the DistributedSampler's counterpart)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, grad_accum: int = 1, num_workers: int = 8,
                 process_index: int = 0, process_count: int = 1):
        if batch_size % process_count:
            raise ValueError(f"batch {batch_size} does not split over {process_count} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.grad_accum = grad_accum
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = batch_size // process_count

    def __len__(self):
        chunk = self.batch_size * self.grad_accum
        n = len(self.dataset)
        return n // chunk if self.drop_last else -(-n // chunk)

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's update-batches in the order seeded by (seed, epoch);
        ``start_batch`` skips the first update-batches without reading their
        samples (a resume inside the epoch)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        chunk = self.batch_size * self.grad_accum

        def fetch(i):
            return self.dataset[int(i)]

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            for off in range(start_batch * chunk, n - chunk + 1 if self.drop_last else n, chunk):
                idxs = order[off: off + chunk]
                if len(idxs) < chunk and (self.grad_accum > 1 or self.process_count > 1):
                    # the accum and rank reshapes need a full chunk: wrap-pad
                    # the last partial one with indices from the epoch's start
                    # (torch DistributedSampler's equal-size padding)
                    idxs = np.concatenate([idxs, np.resize(order, chunk - len(idxs))])
                if self.process_count > 1:  # the rank's rows of each micro-batch
                    lo = self.process_index * self.local_batch
                    idxs = idxs.reshape(self.grad_accum, self.batch_size)[
                        :, lo:lo + self.local_batch].reshape(-1)
                batch = collate(list(ex.map(fetch, idxs)))
                if self.grad_accum > 1:
                    batch = {k: v.reshape(self.grad_accum, self.local_batch, *v.shape[1:])
                             for k, v in batch.items()}
                yield batch


def pad_rows(x: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad the leading (row) dim to ``size``: the fixed serving batch."""
    if x.shape[0] == size:
        return x
    pad = np.zeros((size - x.shape[0], *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad], axis=0)


def cast_floats(batch: Dict[str, Any], dtype: str) -> Dict[str, Any]:
    """The float32 arrays of ``batch`` (the video features) as torch tensors
    of ``dtype`` on the host, before the copy to the device: bfloat16 halves
    the bytes moved. Other arrays pass through. The model takes the video to
    f32 before its feature LayerNorm either way (``NormalizeVideo``), so
    only the inputs' fidelity changes (about 3 significant digits in bf16)."""
    if dtype == "float32":
        return batch
    dt = {"bfloat16": torch.bfloat16}[dtype]
    return {k: torch.from_numpy(v).to(dt) if getattr(v, "dtype", None) == np.float32 else v
            for k, v in batch.items()}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or CPU tensors) on ``device``, copied on
    the current stream (the synchronous path: ``--no_prefetch``)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class DeviceTransfer:
    """``prefetch_to_device``'s ``put`` and ``ready`` for a device.

    On a CUDA device ``put`` copies each array of a host batch into pinned
    memory and starts its copy to the card, ``non_blocking``, on a side
    stream of its own, and records an event after it; ``ready``, on the
    consumer's thread, makes the consumer's current stream wait for that
    event and marks the tensors as used there (so the caching allocator
    keeps their blocks until that stream is done with them). A failure to
    pin, to copy or to make the stream raises: there is no synchronous
    fallback. On another device ``put`` is ``to_device`` and ``ready`` the
    identity."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(device=self.device) if self.device.type == "cuda"
                       else None)

    def put(self, batch: Dict[str, Any]):
        if self.stream is None:
            return to_device(batch, self.device), None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: torch.as_tensor(v).pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, staged) -> Dict[str, torch.Tensor]:
        batch, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch


def prefetch_to_device(it: Iterator[Any], put: Optional[Callable[[Any], Any]] = None,
                       size: int = 2, put_in_worker: bool = True,
                       ready: Optional[Callable[[Any], Any]] = None) -> Iterator[Any]:
    """The items of ``it`` through ``put`` (default: the identity), built
    ``size`` ahead on a worker thread. With ``put_in_worker`` the worker
    also runs ``put`` (the copy overlaps the running step); without it
    ``put`` runs on the consumer's thread and the worker only builds the
    host batches. ``ready``, if given, runs on the consumer's thread on each
    item just before it is yielded. An exception in the worker is raised in
    the consumer. Closing the generator early (a ``break``, a preemption's
    return) stops the worker, closes ``it`` and drops the batches it
    holds. The port's callers all run ``put`` in the worker (the trainers'
    ``DeviceTransfer.put``, the evals' identity); ``put_in_worker=False``
    and ``size`` keep the JAX package's signature and meaning."""
    put = put or (lambda x: x)
    ready = ready or (lambda x: x)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def offer(obj) -> bool:
        # a bounded put, so that a worker whose consumer left sees the stop
        # instead of blocking forever on a full queue
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if stop.is_set() or not offer(put(item) if put_in_worker else item):
                    return
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            if stop.is_set() and hasattr(it, "close"):
                it.close()
            offer(end)

    thread = threading.Thread(target=worker, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield ready(item if put_in_worker else put(item))
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
