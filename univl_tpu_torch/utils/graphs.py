"""CUDA graphs of the port's device functions: the caption decode's
(``evals/beam.py``), the retrieval index's (``serving/index.py``), the
retrieval evaluator's (``evals/retrieval.py``) and the training step's
(``train/trainer.py``), the port's counterpart of the JAX package's jitted
functions there.

``GraphCapture.capture(fn)`` runs ``fn`` eagerly on a side stream
(``run``), then captures it into a graph of one memory pool (``record``);
the caller keeps the graph and replays it. ``GraphCalls`` keeps one graph
per function and input shapes, its static inputs fed from host arrays
through pinned buffers (``StaticInputs``). ``LaunchCounts`` counts the
kernels that run inside such graphs: a kernel wrapper counts a launch where
it runs, which is at a capture (where nothing launches) and not at a replay
(where its kernel runs).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from univl_tpu_torch.parallel.mesh import kernel_launches


class GraphCapture:
    """Captures CUDA graphs into one memory pool, on one side stream: the
    graphs of an owner replay one at a time, so they share the pool.
    ``captures`` and ``seconds`` count the captures and the time they took,
    their eager first runs included."""

    def __init__(self):
        self.pool = self.stream = None
        self.captures = 0
        self.seconds = 0.0

    def capture(self, fn) -> "torch.cuda.CUDAGraph":
        """``run(fn)``, then ``record(fn)``; returns the graph."""
        t0 = time.perf_counter()
        self.run(fn)
        self.seconds += time.perf_counter() - t0
        return self.record(fn)

    def run(self, fn):
        """``fn()`` eagerly on the side stream, the current stream then
        waiting for it; returns what ``fn`` returns."""
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        current, side = torch.cuda.current_stream(), self.stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        return out

    def record(self, fn, generators=()) -> "torch.cuda.CUDAGraph":
        """``fn`` captured (which runs nothing) into a graph of the pool,
        ``generators`` (device generators) registered with it first;
        returns the graph. Whatever ``fn`` allocates in the capture lives in
        the pool, as long as the graph. ``torch.cuda.graph`` without its
        ``empty_cache``: an owner's graphs are many and small, and the
        cached blocks it would free are what the next eager first use
        allocates again. A failed capture raises."""
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        current, side = torch.cuda.current_stream(), self.stream
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            # other threads' device work (a prefetch, a server's other service) goes on
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        current.wait_stream(side)
        self.captures += 1
        self.seconds += time.perf_counter() - t0
        return graph

    def reset(self) -> None:
        """Capture into a new memory pool from now on: an owner that drops
        all its graphs calls it, since a pool whose graphs are all gone
        takes no further capture."""
        self.pool = None


class StaticInputs:
    """The static inputs of one function's graph at one set of input
    shapes, the pinned host buffers that host arrays reach them through,
    and the graph and the outputs that a replay writes."""

    def __init__(self, args, device):
        host = [torch.from_numpy(a) if isinstance(a, np.ndarray) else None for a in args]
        self.inputs = [torch.empty(a.shape, dtype=(a if h is None else h).dtype, device=device)
                       for a, h in zip(args, host)]
        self.staging = [None if h is None else torch.empty_like(h, pin_memory=True)
                        for h in host]
        self.copied = torch.cuda.Event()  # the last copies out of the staging buffers
        self.graph = self.outputs = None

    def load(self, args) -> None:
        self.copied.synchronize()  # the staging buffers are free again
        for x, a, host in zip(self.inputs, args, self.staging):
            if host is None:
                x.copy_(a)
            else:
                # numpy's copy, one thread: torch's would start an OpenMP team in
                # every new thread, and the server serves each request on one
                np.copyto(host.numpy(), a)
                x.copy_(host, non_blocking=True)
        self.copied.record()


class GraphCalls:
    """Device functions called through CUDA graphs (``graph``), one graph
    per function and input shapes: captured at the shapes' first call after
    that call ran eagerly, then every later call copies its inputs into the
    graph's static inputs (host arrays through pinned buffers) and replays
    it. Without ``graph`` every call runs eagerly (the CPU's route).
    ``replays`` counts the replays by function name."""

    def __init__(self, params, device, graph: Optional[bool]):
        self.device = torch.device(device)
        graph = self.device.type == "cuda" if graph is None else bool(graph)
        if graph and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs run on a CUDA device, not {self.device}")
        self.graph = graph
        self.graphs: Dict[tuple, StaticInputs] = {}  # (function, input shapes) -> its graph
        self.capturer = GraphCapture()  # the graphs' pool, stream and capture count
        self.replays = collections.Counter()  # by function
        self._params = list(params)
        self.addresses = tuple(p.data_ptr() for p in self._params)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def check_weights(self) -> bool:
        """Drop the graphs where a parameter's storage moved since they were
        captured (they read the old one); returns whether it did."""
        addresses = tuple(p.data_ptr() for p in self._params)
        if addresses == self.addresses:
            return False
        self.graphs.clear()
        self.capturer.reset()
        self.addresses = addresses
        return True

    def _call(self, name, fn, *args):
        """``fn`` on ``args`` (host arrays or device tensors). Without graphs,
        eagerly. With them, the args go into the static inputs of the graph
        of ``name`` and their shapes, which replays; at the shapes' first
        call ``fn`` runs eagerly (its outputs returned), then the capture. A
        replay's outputs are the graph's: the next replay overwrites them."""
        if not self.graph:
            return fn(*(self._tensor(a) if isinstance(a, np.ndarray) else a for a in args))
        key = (name, *((tuple(a.shape), str(a.dtype)) for a in args))
        entry = self.graphs.get(key)
        if entry is not None:
            entry.load(args)
            entry.graph.replay()
            self.replays[name] += 1
            return entry.outputs
        entry = StaticInputs(args, self.device)
        entry.load(args)
        runs = []
        entry.graph = self.capturer.capture(lambda: runs.append(fn(*entry.inputs)))
        entry.outputs = runs[-1]
        self.graphs[key] = entry
        return runs[0]


class _CountedGraph:
    """A captured graph and the wrappers' counts at its capture, added back
    at every replay."""

    def __init__(self, graph, counts: dict, owner: "LaunchCounts"):
        self.graph, self.counts, self.owner = graph, counts, owner

    def replay(self) -> None:
        self.graph.replay()
        with self.owner.lock:
            self.owner.graphed.update(self.counts)


class LaunchCounts:
    """The kernels' launches on the device, graphs included: while
    installed (``with LaunchCounts() as counts:``), ``GraphCapture.record``
    returns graphs that add the wrappers' counts at their capture back at
    each replay, and takes those counts off, so that ``launches()`` (keyed
    as ``parallel/mesh.py:kernel_launches``) is each wrapper's count with
    every capture counted as nothing and every replay as its kernels. Not
    reentrant: one installed at a time."""

    def __init__(self):
        self.graphed = collections.Counter()  # key -> launches to add to the wrappers'
        self.lock = threading.Lock()
        self._original = None

    def __enter__(self) -> "LaunchCounts":
        original = self._original = GraphCapture.record
        owner = self

        def counted(capturer, fn, *args, **kw):
            marks = []

            def marked():
                marks.append(kernel_launches())
                try:
                    return fn()
                finally:
                    marks.append(kernel_launches())

            graph = original(capturer, marked, *args, **kw)
            counts = {k: n - marks[0][k] for k, n in marks[1].items() if n != marks[0][k]}
            with owner.lock:
                owner.graphed.subtract(counts)
            return _CountedGraph(graph, counts, owner)

        GraphCapture.record = counted
        return self

    def __exit__(self, *exc) -> None:
        GraphCapture.record = self._original

    def reset(self) -> None:
        """Forget the graphs' adjustments (with the wrappers' counts set to 0
        by the caller, every count starts again from 0; graphs captured
        before still add their kernels at each replay)."""
        with self.lock:
            self.graphed.clear()

    def launches(self) -> dict:
        with self.lock:
            return {k: n + self.graphed[k] for k, n in kernel_launches().items()}
