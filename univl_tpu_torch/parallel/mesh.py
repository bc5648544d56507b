"""The port's ranks, the counterpart of ``univl_tpu/parallel/mesh.py``, of
``univl_tpu/parallel/tp.py:make_mesh_2d`` and of
``univl_tpu/parallel/pp.py:make_mesh_pp``.

JAX runs data parallelism as one program over a 1-D device mesh whose axis
is ``DP_AXIS``, and tensor parallelism over a second axis ``TP_AXIS``; the
port runs one process per rank in a ``torch.distributed`` process group, as
the reference's NCCL DDP does. ``Mesh`` is one rank's view of it: its rank,
the world size, its local rank and device, the data group (the default
group: NCCL on the card, gloo on the CPU) and a second gloo group for
host-side control (the preemption flag, the eval metric, the barriers around
rank 0's writes), whose reads never synchronise the card.

With ``tp`` above 1 the ranks form a (dp, tp) grid with tp the inner axis,
``rank = dp_index * tp + tp_index`` (``make_mesh_2d``'s layout: a tp group's
ranks sit on neighbouring cards), and each rank joins one group of each
axis. ``mesh.axis(DP_AXIS)`` and ``mesh.axis(TP_AXIS)`` are views of the
rank in those groups (their rank, size and group), which the collectives of
``parallel/comm.py`` take; with tp 1 the dp view is the mesh itself and the
tp view a group of one rank, whose collectives are the identity. With ``pp``
above 1 (``parallel/pp.py``'s GPipe) the ranks form a (dp, pp) grid the same
way, pp the inner axis, ``rank = dp_index * pp + pp_index``, so a stage's
neighbour is the next rank; ``mesh.axis(PP_AXIS)`` is the rank's view in its
pipeline. As in JAX, no grid has both tp and pp.

Ranks come from one of two places:
  - torchrun (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``): the process joins
    that group (``env://``), across machines as well, as
    ``initialize_multihost`` does;
  - ``spawn``: one command with ``--n_gpu N`` starts N local ranks itself
    (``torch.multiprocessing``), which meet through a ``FileStore`` in a
    fresh temporary directory, so the JAX command line still works.

Rank r takes ``cuda:r`` (modulo the visible cards: with an explicit
``--dist_backend gloo`` every rank may share one card, a rig NCCL refuses).
A spawned rank's entry point, ``_rank_main``, lives here so that the child
imports the port and the entry's module, nothing else.
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import pickle
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
PP_AXIS = "pp"
INIT_METHOD_ENV = "UNIVL_TORCH_INIT_METHOD"  # set by spawn for its children
TIMEOUT = datetime.timedelta(minutes=30)  # a collective that waits longer raises
CPU_THREADS = 1  # torch threads of a CPU rank; several ranks share the host's cores


@dataclass
class Mesh:
    """One rank of the data-parallel group; the default is one process with
    no group (``distributed`` False), whose collectives are the identity."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    control: Any = None  # the gloo group for host-side control
    store_dir: Optional[str] = None  # a one-rank group's FileStore directory
    staging: dict = field(default_factory=dict)  # comm.py's pinned host buffers
    group: Any = None  # the data collectives' group: None is the world's
    tp: int = 1  # ranks in a tensor-parallel group, the inner axis
    pp: int = 1  # stages of a pipeline, the inner axis (tp and pp are never both above 1)
    sequence_parallel: bool = False  # with tp above 1: parallel/sp.py's row shards
    views: dict = field(default_factory=dict)  # axis name -> this rank's view in its group

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def dp(self) -> int:
        return self.size // (self.tp * self.pp)

    def axis(self, name: str) -> "Mesh":
        """This rank's view in its ``DP_AXIS``, ``TP_AXIS`` or ``PP_AXIS``
        group."""
        if name in self.views:
            return self.views[name]
        if name == DP_AXIS and self.tp == 1 and self.pp == 1:
            return self
        if (name == TP_AXIS and self.tp == 1) or (name == PP_AXIS and self.pp == 1):
            return Mesh(device=self.device)
        raise KeyError(f"no {name!r} axis in this mesh")

    @property
    def primary(self) -> bool:
        """Rank 0: the one that writes files, as JAX's ``process_index() == 0``."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.control)

    def any(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is true on any (a host-side max)."""
        if self.size == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())

    def broadcast(self, value: Optional[float]) -> float:
        """Rank 0's ``value`` on every rank (the others pass None)."""
        if self.size == 1:
            return value
        t = torch.tensor([float("nan") if value is None else value], dtype=torch.float64)
        dist.broadcast(t, src=0, group=self.control)
        return float(t.item())

    def close(self) -> None:
        """Destroy the groups (a rank that raised leaves none open)."""
        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()
        if self.store_dir:
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None


def visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def launched() -> bool:
    """True inside a rank that a launcher (torchrun, or ``spawn``) started."""
    return "WORLD_SIZE" in os.environ


def resolve_size(n_gpu: int, device_type: str) -> int:
    """``--n_gpu``: 0 is every visible card (JAX's every local device), one
    rank on the CPU; under a launcher, its world size."""
    if launched():
        return int(os.environ["WORLD_SIZE"])
    if n_gpu < 0:
        raise ValueError(f"--n_gpu {n_gpu}: give 0 (every visible card) or a count")
    if n_gpu == 0:
        return max(visible_cards(), 1) if device_type == "cuda" else 1
    return n_gpu


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_error(n_gpu: int, device_type: str, backend: Optional[str]) -> Optional[str]:
    """Why ``--n_gpu`` cannot run here, or None. More ranks than cards is an
    error unless ``--dist_backend gloo`` was given, which puts several ranks
    on a card (NCCL refuses two ranks on one device); a launcher's world size
    must match a ``--n_gpu`` that names one."""
    if launched():
        world = int(os.environ["WORLD_SIZE"])
        if n_gpu not in (0, world):
            return f"--n_gpu {n_gpu}: the launcher started {world} ranks"
        return None
    if device_type != "cuda" or n_gpu <= 1:
        return None
    cards = visible_cards()
    if n_gpu > cards and backend != "gloo":
        return (f"--n_gpu {n_gpu}: {cards} CUDA card(s) visible and NCCL takes one rank a card; "
                f"give --dist_backend gloo to share the cards")
    return None


def init(device: str, backend: Optional[str] = None, tp: int = 1,
         sequence_parallel: bool = False, pp: int = 1,
         timeout: datetime.timedelta = TIMEOUT) -> Mesh:
    """Join the process group: a launcher's ranks, or a one-rank group of
    this process alone (``--zero1`` on one card, whose collectives are real
    calls of the backend over one rank). ``device`` is ``--device``; a
    rank's device is ``cuda:local_rank`` modulo the visible cards. With
    ``tp`` (or ``pp``) above 1, which must divide the world size, every rank
    also creates the dp and tp (or pp) groups, in one order on every rank.
    ``timeout`` bounds every wait of a collective or a point-to-point call."""
    device_type = torch.device(device).type
    backend = backend or default_backend(device_type)
    store_dir = None
    if launched():
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = os.environ.get(INIT_METHOD_ENV, "env://")
    else:
        rank, size, local_rank = 0, 1, 0
    check_grid(size, tp, pp)
    if not launched():
        store_dir = tempfile.mkdtemp(prefix="univl_group_")
        init_method = "file://" + os.path.join(store_dir, "store")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device_type)
        if size > 1:
            torch.set_num_threads(CPU_THREADS)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=timeout)
    mesh = Mesh(rank=rank, size=size, local_rank=local_rank, device=dev, backend=backend,
                control=control, store_dir=store_dir, tp=tp, pp=pp,
                sequence_parallel=sequence_parallel and tp > 1)
    inner_name, inner = (TP_AXIS, tp) if tp > 1 else (PP_AXIS, pp)
    if inner > 1:
        dp = size // inner
        grids = {inner_name: [[d * inner + t for t in range(inner)] for d in range(dp)],
                 DP_AXIS: [[d * inner + t for d in range(dp)] for t in range(inner)]}
        for name in (inner_name, DP_AXIS):
            for ranks in grids[name]:
                group = dist.new_group(ranks, backend=backend, timeout=timeout)
                if rank in ranks:
                    mesh.views[name] = Mesh(rank=ranks.index(rank), size=len(ranks),
                                            local_rank=local_rank, device=dev, backend=backend,
                                            control=control, group=group)
    return mesh


def check_grid(size: int, tp: int, pp: int) -> None:
    """The (dp, tp) or (dp, pp) grids ``init`` builds, or an error."""
    if tp > 1 and pp > 1:
        raise ValueError(f"tensor parallelism ({tp}) and pipeline parallelism ({pp}) in one "
                         f"mesh: the JAX package has no such mesh; choose one")
    if size % tp:
        raise ValueError(f"--tensor_parallel {tp} must divide the {size} ranks")
    if size % pp:
        raise ValueError(f"pipeline parallelism {pp} must divide the {size} ranks")


def kernel_launches() -> dict:
    """Every kernel wrapper's launch counters in this process, as
    ``{"<module>.<wrapper>.<counter>": n}``."""
    from univl_tpu_torch.kernels import (
        attention,
        decode_attention,
        ffn,
        layernorm,
        reorder,
        train_attention,
        vocab_topk,
    )

    out = {}
    for module in (attention, decode_attention, ffn, layernorm, reorder, train_attention,
                   vocab_topk):
        short = module.__name__.rsplit(".", 1)[1]
        for name, fn in vars(module).items():
            if callable(fn) and getattr(fn, "__module__", None) == module.__name__:
                for attr, n in vars(fn).items():
                    if attr.endswith("launches") and isinstance(n, int):
                        out[f"{short}.{name}.{attr}"] = n
    return out


def spawn(entry: str, argv: Sequence[str], size: int) -> Any:
    """Run ``entry`` (``"module:function"``, called with ``argv``) in
    ``size`` local ranks and return rank 0's return value. A rank that
    raises ends the others and raises here. Each rank runs under this
    process's ``torch.use_deterministic_algorithms`` setting (and inherits
    its environment, ``CUBLAS_WORKSPACE_CONFIG`` included). ``spawn.ranks``
    then holds each rank's report: its kernel launches, the top-level
    packages it imported and its peak device memory (None on the CPU)."""
    rdzv = tempfile.mkdtemp(prefix="univl_ranks_")
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        torch.multiprocessing.spawn(_rank_main,
                                    args=(entry, list(argv), size, rdzv, deterministic),
                                    nprocs=size, join=True)
        reports = []
        for r in range(size):
            with open(os.path.join(rdzv, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        spawn.ranks = reports
        with open(os.path.join(rdzv, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(rdzv, ignore_errors=True)


spawn.ranks = []


def _rank_main(local_rank: int, entry: str, argv, size: int, rdzv: str,
               deterministic: bool = False) -> None:
    """A spawned rank: the launcher's environment and the parent's
    deterministic mode, then ``entry(argv)``."""
    torch.use_deterministic_algorithms(deterministic)
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(size), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(size))
    os.environ[INIT_METHOD_ENV] = "file://" + os.path.join(rdzv, "store")
    module, fn = entry.split(":")
    result = getattr(importlib.import_module(module), fn)(argv)
    report = {"rank": local_rank, "launches": kernel_launches(),
              "modules": sorted({m.split(".")[0] for m in sys.modules}),
              "peak_bytes": (torch.cuda.max_memory_allocated() if torch.cuda.is_initialized()
                             else None)}
    with open(os.path.join(rdzv, f"rank{local_rank}.json"), "w") as f:
        json.dump(report, f)
    if local_rank == 0:
        with open(os.path.join(rdzv, "result.pkl"), "wb") as f:
            pickle.dump(result, f)
