"""ZeRO-1 BertAdam (``train/zero1.py``) against the replicated BertAdam on
the same parameters and gradients, on N ranks; the port's counterpart of
``tools/bench_zero1.py``.

    python -m univl_tpu_torch.probes.zero1_ab [--device cuda] [--n_gpu N]
        [--dist_backend nccl|gloo] [--tiny] [--train_sim_after_cross] [--steps 3]
        [--adam_state_dtype float32 [bfloat16]] [--global_clip_norm 5] [--profile 2]

The parameters are the model's (``UniVLConfig.base``, or ``--tiny``), the
parameter groups ``univl_param_groups``'. Each rank draws its own gradients
from a seed (``--seed``, the step and the rank); the replicated optimizer
takes their mean (one ``all_reduce_mean`` of the flat gradient, as the
trainer does), ZeRO-1 the rank's unreduced gradient. With the global clip at
``--global_clip_norm`` (above the per-tensor clip's 1.0) both clips act on
gradients of unit entries: the report says how many tensors the per-tensor
clip scaled. After each step: the largest difference of a parameter between
the two, relative to that tensor's largest magnitude and absolute, and each update's
device ms (CUDA events around the step, collectives included; host seconds
on the CPU); at the end each optimizer's state bytes on a rank. With
``--profile N`` on the card, N more updates of each under torch.profiler:
the device ms an update (the sum of its kernels', copies' and memsets'
durations). For each moment dtype rank 0 prints one JSON line; it returns
them as a list of dicts.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from univl_tpu_torch.cli import common
from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.parallel import comm
from univl_tpu_torch.train.optimization import BertAdam, univl_param_groups
from univl_tpu_torch.train.zero1 import Zero1BertAdam

ENTRY = "univl_tpu_torch.probes.zero1_ab:main"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ZeRO-1 against the replicated BertAdam")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_gpu", type=int, default=1)
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--train_sim_after_cross", action="store_true")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--adam_state_dtype", nargs="+", default=["float32"],
                   choices=["float32", "bfloat16"])
    p.add_argument("--global_clip_norm", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", type=int, default=0)
    args = p.parse_args(argv)
    args.zero1 = True  # a process group even on one rank
    return args


def main(argv=None):
    return common.run_on_ranks(ENTRY, argv, parse_args(argv), run)


def _timer(device):
    if device.type != "cuda":
        t0 = time.perf_counter()
        return lambda: 1e3 * (time.perf_counter() - t0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()

    def stop():
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return stop


def profiled_ms(fn, steps: int) -> float:
    """The device time of one call of ``fn``: its device events' durations
    summed, over ``steps`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA)
    return ns / 1e6 / steps


def run(args, mesh):
    return [compare(args, mesh, dtype) for dtype in args.adam_state_dtype]


def compare(args, mesh, state_dtype: str) -> dict:
    device = mesh.device
    cfg = (UniVLConfig.tiny if args.tiny else UniVLConfig.base)(
        train_sim_after_cross=args.train_sim_after_cross)
    torch.manual_seed(args.seed)
    models = [UniVL(cfg, device=device) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    kw = dict(lr=1e-3, warmup=0.1, t_total=max(args.steps, 1), max_grad_norm=1.0,
              global_clip_norm=args.global_clip_norm,
              state_dtype=None if state_dtype == "float32" else state_dtype)
    replicated = BertAdam(univl_param_groups(models[0], 0.1), **kw)
    zero1 = Zero1BertAdam(univl_param_groups(models[1], 0.1), mesh=mesh, **kw)
    params = [[p for g in opt.param_groups for p in g["params"]] for opt in (replicated, zero1)]
    names = {id(p): n for n, p in models[0].named_parameters()}
    flat = torch.zeros(zero1.padded, dtype=torch.float32, device=device)
    report = {"ranks": mesh.size, "backend": mesh.backend, "state_dtype": state_dtype,
              "params": sum(p.numel() for p in params[1]), "steps": []}
    for step in range(args.steps):
        g = torch.Generator(device=device).manual_seed(args.seed * 1000 + step * 64 + mesh.rank)
        grads = torch.randn(zero1.total, generator=g, device=device)
        mean = comm.all_reduce_mean(grads.clone(), mesh)
        norm = float(mean.norm())
        scaled = 0
        for p, v in zip(params[0], zero1.flat_views(mean)):
            p.grad = v
            n = float(v.norm()) * min(1.0, args.global_clip_norm / norm)
            scaled += n > 1.0
        stop = _timer(device)
        replicated.step()
        replicated_ms = stop()
        flat.zero_()
        flat[:zero1.total].copy_(grads)
        stop = _timer(device)
        zero1.step(flat)
        zero1_ms = stop()
        worst, where, largest = 0.0, None, 0.0
        for a, b in zip(*params):
            d = float((a - b).detach().abs().max())
            largest = max(largest, d)
            rel = d / max(float(a.detach().abs().max()), 1e-30)
            if rel > worst:
                worst, where = rel, names[id(a)]
        report["steps"].append({"max_rel_diff": worst, "at": where, "max_abs_diff": largest,
                                "global_norm": norm,
                                "global_clip_acted": norm > args.global_clip_norm,
                                "tensors_clipped": scaled, "replicated_ms": replicated_ms,
                                "zero1_ms": zero1_ms})
    if args.profile and device.type == "cuda":
        def refill():  # the update gathers the new master into the flat gradient
            flat[:zero1.total].copy_(grads)

        def update():
            refill()
            zero1.step(flat)

        report["replicated_device_ms"] = profiled_ms(replicated.step, args.profile)
        report["zero1_device_ms"] = (profiled_ms(update, args.profile)
                                     - profiled_ms(refill, args.profile))
    report["replicated_state_bytes"] = sum(
        t.numel() * t.element_size() for st in replicated.state.values() for t in st.values())
    report["zero1_state_bytes"] = sum(t.numel() * t.element_size()
                                      for t in (zero1.m, zero1.v, zero1.master, zero1.g))
    if mesh.primary:
        print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
