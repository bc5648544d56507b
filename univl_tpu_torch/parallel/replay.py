"""Replay global update-batches through the trainer on any number of ranks.

    python -m univl_tpu_torch.parallel.replay --spec spec.pt --output out.pt \\
        [--n_gpu N] [--tensor_parallel T [--sequence_parallel]] \\
        [--dist_backend gloo] [--device cpu]

``spec.pt`` (``torch.save``) holds a list of runs. A run is a dict:
``config`` (a ``UniVLConfig``, whose ``batch_size_per_device`` is the rank's
micro-batch), ``state_dict`` (the initial weights under the reference
names), ``batches`` (the global update-batches, dicts of numpy arrays
``[accum, B, ...]``), ``optimizer`` (``make_univl_optimizer``'s keywords),
``zero1``, ``seed`` and, optionally, ``switch_at``: after that many steps
the train state is taken in the replicated layout and loaded into a trainer
of the other layout (replicated or ZeRO-1), which takes the remaining
steps, as a resume across layouts does. Every rank runs every run on the
rows of each micro-batch of its dp index (``P(None, 'dp')``; the ranks of a
tp group read the same rows, each holding its share of the model); rank 0
writes to ``--output`` and returns a list with, for each run, the metrics of
every step, the final weights and the optimizer's state (the replicated tp=1
layout), on the CPU. The same work in two layouts (one rank accumulating
micro-batches against several ranks; replicated against ZeRO-1; dp against
dp x tp; the port against the JAX package's mesh) can so be compared step
for step.
"""

from __future__ import annotations

import argparse

import torch

from univl_tpu_torch.cli import common
from univl_tpu_torch.data.batching import to_device
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.parallel import tp as tensor_parallel
from univl_tpu_torch.parallel.mesh import DP_AXIS
from univl_tpu_torch.train.trainer import Trainer

ENTRY = "univl_tpu_torch.parallel.replay:main"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Replay global batches on N ranks")
    p.add_argument("--spec", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_gpu", type=int, default=1)
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"])
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--sequence_parallel", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.spec_runs = torch.load(args.spec, weights_only=False)
    args.zero1 = any(r.get("zero1") for r in args.spec_runs)  # a group even on one rank
    return common.run_on_ranks(ENTRY, argv, args, run)


def _trainer(run_spec, model, mesh, zero1: bool) -> Trainer:
    accum = next(iter(run_spec["batches"][0].values())).shape[0]
    opt = common.make_optimizer(model, mesh, zero1, **run_spec["optimizer"])
    return Trainer(model, opt, grad_accum_steps=accum, seed=run_spec.get("seed", 0), mesh=mesh)


def _cpu(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    if isinstance(state, dict):
        return {k: _cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_cpu(v) for v in state)
    return state


def run(args, mesh):
    results = []
    for spec in args.spec_runs:
        model = UniVL(spec["config"], device=mesh.device)
        model.load_state_dict(spec["state_dict"], strict=True)
        tensor_parallel.parallelize(model, mesh)
        zero1 = bool(spec.get("zero1"))
        trainer = _trainer(spec, model, mesh, zero1)
        metrics = []
        for step, batch in enumerate(spec["batches"]):
            if step == spec.get("switch_at"):
                state = common.train_state(trainer)
                model.zero_grad(set_to_none=True)  # the old layout's gradient views
                zero1 = not zero1
                trainer = _trainer(spec, model, mesh, zero1)
                common.load_train_state(trainer, state)
            dp = mesh.axis(DP_AXIS)
            rows = next(iter(batch.values())).shape[1] // dp.size
            local = {k: v[:, dp.rank * rows:(dp.rank + 1) * rows] for k, v in batch.items()}
            out = trainer.train_step(to_device(local, mesh.device), step)
            metrics.append({k: float(v) for k, v in out.items()})
        state = common.train_state(trainer)  # the tp=1 layout
        results.append({"metrics": metrics, "state_dict": _cpu(state["model"]),
                        "optimizer": _cpu(state["optimizer"])})
    if mesh.primary and args.output:
        torch.save(results, args.output)
    return results


if __name__ == "__main__":
    main()
