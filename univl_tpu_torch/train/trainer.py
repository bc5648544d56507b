"""The trainer, with the semantics of ``univl_tpu/train/trainer.py``.

One optimizer step takes a batch with a leading micro-batch axis,
``[accum, B, ...]``: each micro-batch's loss is computed over its own rows
(the reference's per-device negatives), its gradients are summed into
``.grad``, and the sum is divided by ``accum`` before the optimizer steps;
the returned metrics are the micro-batches' mean. Step ``global_step`` draws
all its dropout from one CPU generator seeded from ``(seed, global_step)``
(the counterpart of ``fold_in(base_key, global_step)``), one key a
micro-batch, so a step is reproducible on its own and a run can later
resume at any step.

Data parallelism (``mesh``, ``parallel/mesh.py``) runs one trainer a rank,
each on its rows of every global micro-batch (JAX's ``P(None, 'dp')``):
rank r's micro-batch i draws the key that micro-batch ``r * accum + i``
draws in one process with ``size * accum`` micro-batches, so two ranks
compute what one process computes with two accumulated micro-batches. The
gradients land in one flat f32 buffer (each parameter's ``.grad`` a view of
it, zeros where a parameter got none, as in ``BertAdam.step``; each view
starts where its own allocation would, 512-byte aligned, so the
multi-tensor kernels take the same vectorized route and sum a gradient's
norm in the same order as for a gradient of its own); after the
micro-batch loop the buffer takes one ``all_reduce_mean`` (JAX's ``pmean``
after its scan) and the optimizer steps, or with ``zero1`` the ZeRO-1
optimizer (``train/zero1.py``, a ``Zero1BertAdam``) takes the buffer unreduced and
reduce-scatters it itself. The metrics are averaged over the ranks, as
``pmean`` does. The model is not wrapped in ``DistributedDataParallel``:
FT-Joint never runs the cross tower or the decoder, which DDP would need to
be told about, and the one reduction after the loop is JAX's.

Tensor parallelism (a mesh with ``tp`` above 1, the model cut by
``parallel/tp.py:parallelize``): the ranks of a tp group read the same rows
and draw the same keys, so the data-parallel rules above run over the dp
group (``mesh.axis(DP_AXIS)``): rank r skips the keys of the dp ranks before
its dp index, the gradients and metrics are averaged over the dp group, and
ZeRO-1 is ``train/zero1_tp.py``'s. Under sequence parallelism the gradients
of the row-sharded regions' replicated parameters (``parallel/sp.py``) are
first summed over the tp group.

``train_steps`` is JAX's K optimizer steps in one dispatch: step i of the
``[K, accum, B, ...]`` stack is ``train_step`` at ``first_step + i``, and
afterwards the parameters, moments and step count are what K ``train_step``
calls leave. On the CPU it is that loop. On the card the steps replay one
step captured as a CUDA graph (``torch.cuda.CUDAGraph``), so the host issues
one replay a step in place of the step's thousands of launches. What a graph
would bake in reaches the device through memory: the kernels' Philox keys
from a key table (``nn/layers.py:StepKeys``, the step's keys derived on the
host from ``(seed, global_step)`` as the eager step folds them), the hidden
dropout from device generators registered with the graph and seeded before
each replay, and BertAdam's learning rate from device scalars
(``BertAdam.lr_factors``). The first call for a set of shapes runs its first
step eagerly (it builds the kernels, creates the moments and settles the
allocator), records the step's keys and captures the step (the capture runs
nothing), so every later step for those shapes, in that call or the next,
is a replay: a loop of K = 1 calls (``cli/common.py:run_train_epochs``)
replays from its second step. Graphs are kept by (shapes, dtypes, accum,
route), in one memory pool (``utils/graphs.py:GraphCapture``); where a load
replaced the parameters or moments they are all dropped. A layer recomputed under ``--remat`` (full or "dots") folds
its keys again inside the captured backward: those entries of the layout
take table slots and generators of their own, written with the first
pass's keys. ZeRO-1 on a one-rank NCCL group captures its reduce-scatter
and all-gather (the eager step has made the communicator). One process on
one card only: tensor and sequence parallelism, meshes of several ranks,
gloo groups and optimizers other than BertAdam are refused
(``graph_refusal``), and a capture or replay that fails raises. ``graph``
(default: on a CUDA model) turns the graphs off: ``train_steps`` is then
the loop of ``train_step`` on the card too, the eager route a check compares
with.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from univl_tpu_torch.nn.layers import (
    GENERATOR,
    KERNEL,
    LayerNormTF,
    StepKeys,
    draw_key,
    layout_keys,
)
from univl_tpu_torch.parallel import comm
from univl_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, Mesh
from univl_tpu_torch.parallel.sp import sp_params
from univl_tpu_torch.train.optimization import BertAdam
from univl_tpu_torch.train.zero1 import Zero1BertAdam, flat_offsets
from univl_tpu_torch.train.zero1_tp import Zero1TpBertAdam
from univl_tpu_torch.utils.graphs import GraphCapture


def step_generator(seed: int, global_step: int) -> torch.Generator:
    """The CPU generator of one step, seeded from (seed, global_step)."""
    state = np.random.SeedSequence([seed, global_step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) | int(state[1]) << 32)


class StepGraph(NamedTuple):
    """One training step captured as a CUDA graph, and what it reads and
    writes: the batch buffers it reads, its key table (int64 [kernel keys])
    and device generators (one a generator key of ``layout``), BertAdam's
    learning-rate factors, the metrics it writes, the step's key layout and
    number of roots, the layout's indices of the table's keys and of the
    generators' seeds, and the pinned host buffers that the table and the
    factors are copied from before each replay, with the event after those
    copies."""

    graph: "torch.cuda.CUDAGraph"
    batch: Dict[str, torch.Tensor]
    table: torch.Tensor
    pool: list
    factors: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    layout: list
    roots: int
    kernel: list
    gens: list
    staging: tuple
    copied: "torch.cuda.Event"


class Trainer:
    """Trains any module whose ``forward(batch, generator)`` returns a dict
    of scalar losses with key ``"loss"``."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 grad_accum_steps: int = 1, seed: int = 0, mesh: Optional[Mesh] = None,
                 graph: Optional[bool] = None):
        """``graph``: ``train_steps`` replays CUDA graphs on a CUDA model
        (None, the default, or True; True on another device raises); False
        is the eager route, ``train_step`` a step."""
        if grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        device = next(model.parameters()).device
        if graph and device.type != "cuda":
            raise ValueError(f"CUDA graphs run on a CUDA model, not on {device}")
        self.graph = graph
        self.model = model
        self.optimizer = optimizer
        self.grad_accum_steps = grad_accum_steps
        self.seed = seed
        self.mesh = mesh or Mesh()
        self.dp = self.mesh.axis(DP_AXIS)
        # ZeRO-1 takes the flat gradient
        self.zero1 = isinstance(optimizer, (Zero1BertAdam, Zero1TpBertAdam))
        self.sp_params = sp_params(model)
        self._flat = None  # the gradient buffer of a data-parallel or ZeRO-1 step
        self._graphs: Dict[tuple, StepGraph] = {}  # train_steps' captured steps
        self.capturer = GraphCapture()  # their pool, side stream and capture count
        self._captured_at = None  # the state's addresses when they were captured
        self._layer_norms = None  # the model's LayerNorms, whose routes key a graph

    def _grad_buffer(self) -> torch.Tensor:
        """The flat f32 gradient buffer, zeroed, each parameter's ``.grad`` a
        view of it (in the optimizer groups' order; ZeRO-1's padded size)."""
        if self.zero1:  # the optimizer's layout
            params, offsets = self.optimizer.flat_params, self.optimizer.offsets
        else:
            params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self._flat is None:
            if self.zero1:
                size = self.optimizer.padded
            else:
                offsets, size = flat_offsets(params)
            self._flat = torch.zeros(size, dtype=torch.float32, device=params[0].device)
            self._views = [self._flat[o:o + p.numel()].view_as(p)
                           for p, o in zip(params, offsets)]
        else:
            self._flat.zero_()
        for p, view in zip(params, self._views):
            p.grad = view
        return self._flat

    def train_step(self, batch: Dict[str, torch.Tensor],
                   global_step: int) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (arrays ``[accum, B, ...]`` on the
        model's device; the rank's rows under data parallelism); returns the
        mean metrics as device tensors (no sync)."""
        return self._step(batch, self._generator(global_step))

    def _generator(self, global_step: int) -> torch.Generator:
        """The step's CPU generator, past the keys of the dp ranks before this one."""
        generator = step_generator(self.seed, global_step)
        for _ in range(self.dp.rank * self.grad_accum_steps):
            draw_key(generator)
        return generator

    def _step(self, batch: Dict[str, torch.Tensor], generator) -> Dict[str, torch.Tensor]:
        """``train_step`` drawing from ``generator`` (the step's CPU
        generator, or a ``StepKeys`` over it)."""
        accum = self.grad_accum_steps
        if any(v.shape[0] != accum for v in batch.values()):
            raise ValueError(f"batch arrays must lead with the {accum} micro-batches")
        self.model.train()
        flat = self._grad_buffer() if (self.dp.size > 1 or self.zero1) else None
        sums: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            out = self.model({k: v[i] for k, v in batch.items()}, generator)
            out["loss"].backward()
            for k, v in out.items():
                sums[k] = v.detach() if k not in sums else sums[k] + v.detach()
        if self.sp_params:
            self._sum_sp_grads()
        if flat is None:
            if accum > 1:
                grads = [p.grad for p in self.model.parameters() if p.grad is not None]
                torch._foreach_div_(grads, accum)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        else:
            if accum > 1:
                flat.div_(accum)
            if self.zero1:
                self.optimizer.step(flat)
            else:
                comm.all_reduce_mean(flat, self.dp)
                self.optimizer.step()
        metrics = {k: v / accum for k, v in sums.items()}
        if self.dp.size > 1:
            keys = sorted(metrics)
            mean = comm.all_reduce_mean(torch.stack([metrics[k].float() for k in keys]),
                                        self.dp)
            metrics = dict(zip(keys, mean.unbind()))
        return metrics

    def train_steps(self, batches: Dict[str, torch.Tensor],
                    first_step: int) -> Dict[str, torch.Tensor]:
        """K optimizer steps (JAX's ``Trainer.train_steps``): ``batches``
        arrays ``[K, accum, B, ...]`` on the model's device, step i
        ``train_step({k: v[i]}, first_step + i)``. Returns the metrics stacked
        ``[K]``, device tensors (no sync). On the card the steps replay a
        captured CUDA graph (the module docstring); on the CPU they are the loop."""
        n = {v.shape[0] for v in batches.values()}
        if len(n) != 1:
            raise ValueError(f"batch arrays must share their leading K, got {sorted(n)}")
        k = n.pop()
        if self._on_card() and self.graph is not False:
            refusal = self.graph_refusal()
            if refusal is not None:
                raise NotImplementedError(f"train_steps on the card refuses {refusal}")
            metrics = self._graph_steps(batches, first_step, k)
        else:
            metrics = [self.train_step({name: v[i] for name, v in batches.items()},
                                       first_step + i) for i in range(k)]
        return {name: torch.stack([m[name] for m in metrics]) for name in metrics[0]}

    def _on_card(self) -> bool:
        return next(self.model.parameters()).device.type == "cuda"

    def step_route(self) -> str:
        """How a training loop steps this trainer: ``graph`` (``train_steps``
        replays), ``eager: <the reason>`` (``graph_refusal``'s, or
        ``graph=False``) or ``cpu`` (``train_steps`` is the loop)."""
        refusal = self.graph_refusal()
        if refusal is not None:
            return f"eager: {refusal}"
        if not self._on_card():
            return "cpu"
        return "eager: graph=False" if self.graph is False else "graph"

    def graph_refusal(self) -> Optional[str]:
        """What keeps ``train_steps`` from replaying this trainer's step as a
        CUDA graph on the card, or None."""
        if (self.mesh.tp > 1 or self.sp_params
                or getattr(self.optimizer, "tp", None) is not None):
            return ("tensor and sequence parallelism (--tensor_parallel, "
                    "--sequence_parallel), which need two or more ranks")
        if self.mesh.size > 1:
            return (f"a mesh of {self.mesh.size} ranks: a graph is one process on one card, "
                    f"NCCL takes one rank a card and gloo cannot be captured")
        if self.mesh.backend == "gloo":
            return ("a gloo process group: gloo stages CUDA tensors through pinned host "
                    "memory, which a graph cannot hold (NCCL can be captured)")
        if not isinstance(self.optimizer, BertAdam):
            return (f"{type(self.optimizer).__name__}: the graph reads BertAdam's "
                    f"learning-rate scalars, and the CLIs build only BertAdam and "
                    f"Zero1BertAdam")
        return None

    def _addresses(self) -> tuple:
        """The device addresses a captured step updates in place: the
        parameters, and BertAdam's moments or ZeRO-1's (its shard's moments,
        f32 master and gradient, and the flat gradient buffer). BertAdam's
        learning-rate scalars are made once and never replaced."""
        opt, ptrs = self.optimizer, []
        if self.zero1:
            ptrs += [t.data_ptr() for t in (opt.m, opt.v, opt.master, opt.g, self._flat)]
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                ptrs += [p.data_ptr()] + [st[k].data_ptr() for k in ("m", "v") if k in st]
        return tuple(ptrs)

    def _graph_key(self, batches: Dict[str, torch.Tensor]) -> tuple:
        """A captured step's key: each array's name, per-step shape and
        dtype, the accumulation and the route (which LayerNorms take #6)."""
        shapes = tuple(sorted((name, tuple(v.shape[1:]), v.dtype) for name, v in batches.items()))
        if self._layer_norms is None:
            self._layer_norms = [m for m in self.model.modules() if isinstance(m, LayerNormTF)]
        return shapes, self.grad_accum_steps, tuple(m.fused for m in self._layer_norms)

    def _graph_steps(self, batches: Dict[str, torch.Tensor], first_step: int, k: int) -> list:
        """The steps of ``train_steps`` on the card: where no graph is kept
        for these shapes, the first eagerly on the capturer's side stream
        and then the step captured; every other one a replay. Returns each
        step's metrics."""
        opt, key = self.optimizer, self._graph_key(batches)
        if self._graphs and self._addresses() != self._captured_at:
            self._graphs.clear()  # a load replaced the parameters or moments
            self.capturer.reset()
        entry = self._graphs.get(key)
        metrics, start = [], 0
        if entry is None:
            keys = StepKeys(self._generator(first_step))
            metrics.append(self.capturer.run(
                lambda: self._step({name: v[0] for name, v in batches.items()}, keys)))
            entry = self._graphs[key] = self._capture(batches, first_step + 1, keys)
            start = 1
        table, factors = (t.numpy() for t in entry.staging)
        for i in range(start, k):
            generator = self._generator(first_step + i)
            values = layout_keys(entry.layout, [draw_key(generator)
                                                for _ in range(entry.roots)])
            for name, buf in entry.batch.items():
                buf.copy_(batches[name][i])
            entry.copied.synchronize()  # the last replay's copies out of the staging are done
            table[:] = [values[j] for j in entry.kernel]
            factors[:] = opt.factors_at(opt.steps)
            entry.table.copy_(entry.staging[0], non_blocking=True)
            entry.factors.copy_(entry.staging[1], non_blocking=True)
            entry.copied.record()
            for gen, j in zip(entry.pool, entry.gens):
                gen.manual_seed(values[j])
            entry.graph.replay()
            opt.steps += 1
            metrics.append({name: v.clone() for name, v in entry.metrics.items()})
        return metrics

    def _capture(self, batches: Dict[str, torch.Tensor], global_step: int,
                 recorded: StepKeys) -> StepGraph:
        """One step captured as a CUDA graph (its state untouched: nothing
        runs until a replay), drawing the keys of ``recorded``'s layout from
        a key table and generators of its own."""
        device = next(self.model.parameters()).device
        layout = recorded.layout
        batch = {name: torch.empty_like(v[0]) for name, v in batches.items()}
        kernel = [i for i, (kind, _, _) in enumerate(layout) if kind == KERNEL]
        gens = [i for i, (kind, _, _) in enumerate(layout) if kind == GENERATOR]
        table = torch.zeros(len(kernel), dtype=torch.int64, device=device)
        pool = [torch.Generator(device=device) for _ in gens]
        factors = self.optimizer.lr_factors()  # made by the eager step: the same tensor
        staging = (torch.empty(table.shape, dtype=table.dtype, pin_memory=True),
                   torch.empty(factors.shape, dtype=factors.dtype, pin_memory=True))
        keys = StepKeys(self._generator(global_step), table, pool)
        steps, metrics = self.optimizer.steps, {}
        torch.cuda.empty_cache()  # the eager step's cached blocks, free for the graph's pool
        graph = self.capturer.record(lambda: metrics.update(self._step(batch, keys)), pool)
        self.optimizer.steps = steps  # the capture took no step
        if keys.layout != layout:
            raise RuntimeError("the captured step drew other keys than its eager step: "
                               f"{len(keys.layout)} against {len(layout)} entries")
        self._captured_at = self._addresses()
        return StepGraph(graph, batch, table, pool, factors, metrics, layout,
                         len(recorded.roots), kernel, gens, staging, torch.cuda.Event())

    def _sum_sp_grads(self) -> None:
        """The row-sharded regions' replicated gradients summed over the tp group."""
        grads = [p.grad for p in self.sp_params]
        both = comm.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                   self.mesh.axis(TP_AXIS))
        torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(
            both.split([g.numel() for g in grads]), grads)])
