"""Device times of the dense block (#5) and the vocab top-k (#10, #10t) in
bf16, as the model calls them, for the checkout at ``--root`` (default: this
one), run on one CUDA card from the root of this checkout:

    python3 univl_tpu_torch/probes/dense_vocab_times.py [--root DIR] [--label NAME]
        [--split | --stages]

#5 forward and backward at FT-Align's cross tower (98,304 rows) and a
tower's 1,536, dropout 0.1, with W handed over as ``nn/layers.py`` does
(the transposed view of an ``nn.Linear`` weight); #10 at the caption
server's 80 rows and the MSRVTT eval's 160 against BERT's 30,522 x 768
classifier, k = 5; #10t at 80 rows. Each call is first held against its
plain version (max abs error printed), then timed: device ms per call, the
median of 5 runs of 20 calls queued back to back behind a sleep kernel (3
runs of 3 at 98,304 rows). Two checkouts compared in one call on one card
(the parent as ``--root``, then this one, then this one, then the parent)
give the old kernels' times beside the new ones. With ``--split``, each
call's device time by kernel from torch.profiler (10 calls, profiler on).
With ``--stages``, #10 alone at 35, 80 and 160 rows, first as built (the
ring's stages chosen by ``tc_stages`` in ``csrc/vocab_topk.cu``), then from
copies of the package under ``build/probe_stages/`` whose ``tc_stages``
returns 2 or 3, one process each. One JSON line a run, after the card's
name and power limit. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
H, V, K, SEED, RATE = 768, 30522, 5, 4321, 0.1


def device_ms(fn, runs: int = 20, repeats: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # holds the stream while the calls are queued
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return float(np.median(times))


def kernel_split(fn, calls: int = 10) -> dict:
    """Device microseconds a call by kernel name (torch.profiler's trace)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            name = e["name"].replace("(anonymous namespace)::", "")[:48]
            out[name] = out.get(name, 0.0) + e["dur"] / calls
    return {k: round(v, 3) for k, v in out.items()}


def dense_rows(ffn, N: int, split: bool) -> dict:
    g = torch.Generator(device="cuda").manual_seed(N)

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=g, device="cuda")

    x, r, dout = (rn(N, H).bfloat16() for _ in range(3))
    weight = rn(H, H, s=0.02).bfloat16()  # nn.Linear's [out, in]
    w = weight.t()  # the JAX layout, as nn/layers.py hands it over
    b = rn(H, s=0.1).bfloat16()
    scale, bias = 1.0 + rn(H, s=0.1), rn(H, s=0.1)
    out, s = ffn.dense_block_fwd(x, r, w, b, scale, bias, SEED, RATE, save=True)
    want_out, want_s = ffn.dense_block_reference_fwd(x, r, w, b, scale, bias, SEED, RATE)
    got_b = ffn.dense_block_bwd(s, dout, w, scale, SEED, RATE)
    want_b = ffn.dense_block_reference_bwd(s, dout, w, scale, SEED, RATE)
    err = max(float((a.float() - c.float()).abs().max())
              for a, c in zip((out, s, *got_b), (want_out, want_s, *want_b)))
    timing = dict(runs=3, repeats=3) if N > 10000 else {}

    def fwd():
        return ffn.dense_block_fwd(x, r, w, b, scale, bias, SEED, RATE, save=True)

    def bwd():
        return ffn.dense_block_bwd(s, dout, w, scale, SEED, RATE)

    row = {"max_abs_err": err, "fwd_ms": device_ms(fwd, **timing),
           "bwd_ms": device_ms(bwd, **timing)}
    if split:
        row["fwd_split_us"], row["bwd_split_us"] = kernel_split(fwd), kernel_split(bwd)
    return row


def vocab_rows(vt, R: int, split: bool, transform: bool = False) -> dict:
    g = torch.Generator(device="cuda").manual_seed(R)
    h = torch.randn(R, H, generator=g, device="cuda").bfloat16()
    w = (0.02 * torch.randn(V, H, generator=g, device="cuda")).bfloat16()
    b = 0.02 * torch.randn(V, generator=g, device="cuda")
    tr = None
    if transform:
        tr = (0.03 * torch.randn(H, H, generator=g, device="cuda"),
              0.02 * torch.randn(H, generator=g, device="cuda"),
              1.0 + 0.1 * torch.randn(H, generator=g, device="cuda"),
              0.1 * torch.randn(H, generator=g, device="cuda"), 1e-12)
    wp, bp = vt.pad_vocab_inputs(w, b)
    logp, _ = vt.classify_topk(h, wp, bp, K, transform=tr)
    want, _ = vt.classify_topk_reference(h, w, b, K, transform=tr)

    def call():
        return vt.classify_topk(h, wp, bp, K, transform=tr)

    row = {"max_abs_err": float((logp - want).abs().max()), "ms": device_ms(call)}
    if split:
        row["split_us"] = kernel_split(call)
    return row


def stage_variants(root: str) -> int:
    """Run #10 alone from this checkout and from two copies of it whose
    tile kernel's ring has a fixed 2 or 3 stages (the two it is built for);
    returns the first nonzero exit code."""
    runs = [(root, "stages as chosen")]
    for n in (2, 3):
        dst = os.path.join(HERE_ROOT, "build", "probe_stages", f"s{n}")
        shutil.rmtree(dst, ignore_errors=True)
        pkg = os.path.join(dst, "univl_tpu_torch")
        shutil.copytree(os.path.join(root, "univl_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = os.path.join(pkg, "csrc", "vocab_topk.cu")
        with open(cu) as f:
            src = f.read()
        src, hits = re.subn(r"int tc_stages\(int rows\) \{.*?\n\}",
                            f"int tc_stages(int) {{ return {n}; }}", src, flags=re.S)
        if hits != 1:
            raise RuntimeError("tc_stages not found in csrc/vocab_topk.cu")
        with open(cu, "w") as f:
            f.write(src)
        runs.append((dst, f"{n} stages"))
    for at, label in runs:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", at, "--label",
                             label, "--vocab_only"]).returncode
        if rc:
            return rc
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE_ROOT, help="the checkout whose kernels are timed")
    p.add_argument("--label", default="this checkout")
    p.add_argument("--split", action="store_true", help="each call's kernels from the profiler")
    p.add_argument("--stages", action="store_true",
                   help="#10 alone, as built and with its ring fixed at 2 and 3 stages")
    p.add_argument("--vocab_only", action="store_true", help="#10 alone, at 35, 80 and 160 rows")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("dense_vocab_times: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    if args.stages:
        return stage_variants(os.path.abspath(args.root))
    sys.path.insert(0, os.path.abspath(args.root))
    from univl_tpu_torch.kernels import ffn, vocab_topk  # noqa: E402

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    row = {"label": args.label, "package": os.path.dirname(ffn.__file__)}
    if args.vocab_only:
        for R in (35, 80, 160):
            row[f"vocab_topk_{R}"] = vocab_rows(vocab_topk, R, args.split)
        print(json.dumps(row), flush=True)
        return 0
    for N in (98304, 1536):
        row[f"dense_block_{N}"] = dense_rows(ffn, N, args.split)
    for R in (80, 160):
        row[f"vocab_topk_{R}"] = vocab_rows(vocab_topk, R, args.split)
    row["vocab_topk_transform_80"] = vocab_rows(vocab_topk, 80, args.split, transform=True)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
