"""CUDA graphs of the serving paths: the caption decode's (``evals/beam.py``)
and the retrieval index's (``serving/index.py``), the port's counterpart of
the JAX package's jitted functions there.

``GraphCapture.capture(fn)`` runs ``fn`` eagerly on a side stream, then
captures it into a graph of one memory pool; the caller keeps the graph and
replays it. ``LaunchCounts`` counts the kernels that run inside such graphs:
a kernel wrapper counts a launch where it runs, which is at a capture (where
nothing launches) and not at a replay (where its kernel runs).
"""

from __future__ import annotations

import collections
import threading
import time

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
        """Run ``fn`` eagerly on the side stream, then capture it (which runs
        nothing) into a graph of the pool; returns the graph. Whatever
        ``fn`` allocates in the capture lives in the pool, as long as the
        graph. ``torch.cuda.graph`` without its ``empty_cache``: an owner's
        graphs are many and small, and the cached blocks it would free are
        what the next eager first use allocates again. A failed capture
        raises."""
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        current, side = torch.cuda.current_stream(), self.stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
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
    installed (``with LaunchCounts() as counts:``), ``GraphCapture.capture``
    returns graphs that add the wrappers' counts at their capture back at
    each replay, and takes those counts off, so that ``launches()`` (keyed
    as ``parallel/mesh.py:kernel_launches``) is each wrapper's count with
    every capture counted as nothing and every replay as its kernels.
    Relies on ``capture`` calling its ``fn`` twice: eagerly, then into the
    graph. Not reentrant: one installed at a time."""

    def __init__(self):
        self.graphed = collections.Counter()  # key -> launches to add to the wrappers'
        self.lock = threading.Lock()
        self._original = None

    def __enter__(self) -> "LaunchCounts":
        original = self._original = GraphCapture.capture
        owner = self

        def counted(capturer, fn):
            marks = []

            def marked():
                marks.append(kernel_launches())
                fn()
                marks.append(kernel_launches())

            graph = original(capturer, marked)
            if len(marks) != 4:
                raise RuntimeError(f"a capture ran its function {len(marks) // 2} times, not twice")
            counts = {k: n - marks[2][k] for k, n in marks[3].items() if n != marks[2][k]}
            with owner.lock:
                owner.graphed.subtract(counts)
            return _CountedGraph(graph, counts, owner)

        GraphCapture.capture = counted
        return self

    def __exit__(self, *exc) -> None:
        GraphCapture.capture = self._original

    def reset(self) -> None:
        """Forget the graphs' adjustments (with the wrappers' counts set to 0
        by the caller, every count starts again from 0; graphs captured
        before still add their kernels at each replay)."""
        with self.lock:
            self.graphed.clear()

    def launches(self) -> dict:
        with self.lock:
            return {k: n + self.graphed[k] for k, n in kernel_launches().items()}
