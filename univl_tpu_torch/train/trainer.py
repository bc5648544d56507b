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
allocator), records the step's keys, captures the next step and replays
it; later calls replay every step. Graphs are kept by (shapes, dtypes,
accum, route). A layer recomputed under ``--remat`` (full or "dots") folds
its keys again inside the captured backward: those entries of the layout
take table slots and generators of their own, written with the first
pass's keys. ZeRO-1 on a one-rank NCCL group captures its reduce-scatter
and all-gather (the eager step has made the communicator). One process on
one card only: tensor and sequence parallelism, meshes of several ranks,
gloo groups and optimizers other than BertAdam are refused
(``graph_refusal``), and a capture or replay that fails raises.
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
from univl_tpu_torch.train.optimization import BertAdam, copy_from_host
from univl_tpu_torch.train.zero1 import Zero1BertAdam, flat_offsets
from univl_tpu_torch.train.zero1_tp import Zero1TpBertAdam


def step_generator(seed: int, global_step: int) -> torch.Generator:
    """The CPU generator of one step, seeded from (seed, global_step)."""
    state = np.random.SeedSequence([seed, global_step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) | int(state[1]) << 32)


class StepGraph(NamedTuple):
    """One training step captured as a CUDA graph, and what it reads and
    writes: the batch buffers it reads, its key table (int64 [kernel keys])
    and device generators (one a generator key of ``layout``), the metrics
    it writes, the step's key layout and number of roots, and the addresses
    of the state it updates in place (``Trainer._addresses``)."""

    graph: "torch.cuda.CUDAGraph"
    batch: Dict[str, torch.Tensor]
    table: torch.Tensor
    pool: list
    metrics: Dict[str, torch.Tensor]
    layout: list
    roots: int
    addresses: tuple


class Trainer:
    """Trains any module whose ``forward(batch, generator)`` returns a dict
    of scalar losses with key ``"loss"``."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 grad_accum_steps: int = 1, seed: int = 0, mesh: Optional[Mesh] = None):
        if grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
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
        if self._on_card():
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
        learning-rate scalars, the parameters, and BertAdam's moments or
        ZeRO-1's (its shard's moments, f32 master and gradient, and the flat
        gradient buffer)."""
        opt = self.optimizer
        ptrs = [opt.lr_factors().data_ptr()]
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
        fused = tuple(m.fused for m in self.model.modules() if isinstance(m, LayerNormTF))
        return shapes, self.grad_accum_steps, fused

    def _graph_steps(self, batches: Dict[str, torch.Tensor], first_step: int, k: int) -> list:
        """The steps of ``train_steps`` on the card: the first eagerly on a
        side stream where no graph is kept for these shapes (then one step
        captured), every other one a replay. Returns each step's metrics."""
        opt, key = self.optimizer, self._graph_key(batches)
        entry = self._graphs.get(key)
        if entry is not None and entry.addresses != self._addresses():
            entry = None  # the parameters or moments were replaced (a load)
        metrics, start = [], 0
        if entry is None:
            keys = StepKeys(self._generator(first_step))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                metrics.append(self._step({name: v[0] for name, v in batches.items()}, keys))
            torch.cuda.current_stream().wait_stream(side)
            start = 1
            if k == 1:
                return metrics
            entry = self._capture(batches, first_step + 1, keys)
            self._graphs[key] = entry
        kernel = [i for i, (kind, _, _) in enumerate(entry.layout) if kind == KERNEL]
        gens = [i for i, (kind, _, _) in enumerate(entry.layout) if kind == GENERATOR]
        tables, seeds, factors = [], [], []
        for i in range(start, k):  # every replay's keys and learning rates, on the host
            generator = self._generator(first_step + i)
            values = layout_keys(entry.layout, [draw_key(generator)
                                                for _ in range(entry.roots)])
            tables.append([values[j] for j in kernel])
            seeds.append([values[j] for j in gens])
            factors.append(opt.factors_at(opt.steps + i - start))
        device = entry.table.device
        tables = copy_from_host(torch.empty(len(tables), len(kernel), dtype=torch.int64,
                                            device=device), np.array(tables, np.int64))
        factors = copy_from_host(torch.empty(len(factors), len(opt.param_groups),
                                             dtype=torch.float32, device=device),
                                 np.array(factors, np.float32))
        lr = opt.lr_factors()
        for i in range(start, k):
            for name, buf in entry.batch.items():
                buf.copy_(batches[name][i])
            entry.table.copy_(tables[i - start])
            lr.copy_(factors[i - start])
            for gen, seed in zip(entry.pool, seeds[i - start]):
                gen.manual_seed(seed)
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
        batch = {name: torch.empty_like(v[0]) for name, v in batches.items()}
        n_kernel = sum(kind == KERNEL for kind, _, _ in recorded.layout)
        table = torch.zeros(n_kernel, dtype=torch.int64, device=device)
        pool = [torch.Generator(device=device)
                for kind, _, _ in recorded.layout if kind == GENERATOR]
        graph = torch.cuda.CUDAGraph()
        for gen in pool:
            graph.register_generator_state(gen)
        keys = StepKeys(self._generator(global_step), table, pool)
        steps = self.optimizer.steps
        with torch.cuda.graph(graph):
            metrics = self._step(batch, keys)
        self.optimizer.steps = steps  # the capture took no step
        if keys.layout != recorded.layout:
            raise RuntimeError("the captured step drew other keys than its eager step: "
                               f"{len(keys.layout)} against {len(recorded.layout)} entries")
        return StepGraph(graph, batch, table, pool, metrics, recorded.layout,
                         len(recorded.roots), self._addresses())

    def _sum_sp_grads(self) -> None:
        """The row-sharded regions' replicated gradients summed over the tp group."""
        grads = [p.grad for p in self.sp_params]
        both = comm.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                   self.mesh.axis(TP_AXIS))
        torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(
            both.split([g.numel() for g in grads]), grads)])
