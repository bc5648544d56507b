"""Probes behind the design of #3's and #4's bf16 kernels (csrc/ffn.cu), run
on one CUDA card from the root of the checkout:

    python3 univl_tpu_torch/probes/ffn_design.py

It prints, with the card's name and power limit:
1. ptxas's registers and spills for the GEMM kernels of csrc/ffn.cu;
2. design A, one fused kernel a call (``ffn_design_a.cu``), against the
   kept design B (two GEMMs through device memory) on #3's forward at
   98,304 and 1,536 rows: agreement with the plain version and device ms,
   the two timed in turns;
3. variants of csrc/ffn.cu, each built into a library of its own under
   build/probes/: as committed; without epilogues; without the GELU
   arithmetic; without the epilogues' TMA stores; and with x W1's epilogue
   by halves through one set of staging buffers (not by quarters through
   two). Device ms of #3 and #4, forward and backward, at 98,304 and 1,536
   rows, and the kernels' split of one call from torch.profiler.
The variants compute wrong numbers on purpose: they only attribute time.
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from univl_tpu_torch.kernels import _build, ffn  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "probes")
H, F, SEED, RATE = 768, 3072, 4321, 0.1
ROWS = (98304, 1536)
EPILOGUE = "    if (row0 < M) gemm_epilogue<kEpi>("
VARIANTS = {  # name -> edits of csrc/ffn.cu
    "as committed": [],
    "no epilogues": [(EPILOGUE, "    if (M < 0) gemm_epilogue<kEpi>(")],
    "no GELU arithmetic": [("  const float a = fabsf(x) * kInvSqrt2;",
                            "  return make_float2(0.5f, 0.5f);\n  const float a = fabsf(x) * kInvSqrt2;")],
    "no epilogue stores": [("          if (first) univl::tma_store_2d(", "          if (M < 0) univl::tma_store_2d("),
                           ("          if (second) univl::tma_store_2d(", "          if (M < 0) univl::tma_store_2d(")],
    "x W1's epilogue by halves": [("constexpr int kParts = kEpi == kBias ? 4 : 2,",
                                   "constexpr int kParts = 2,")],
}


def ptxas_report(src: str) -> None:
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                        os.path.join(OUT, "ffn_ptxas.o"), src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr[-4000:])
    lines = r.stderr.splitlines()
    for i, line in enumerate(lines):
        hit = re.search(r"ffn_(fwd|bwd)_gemm_kernelILi(\d)", line)
        if "Compiling entry function" in line and hit:
            info = " ".join(x.strip() for x in lines[i + 1:i + 4] if "Compiling" not in x)
            used = re.search(r"Used \d+ registers", info).group(0)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
            print(f"ptxas: ffn_{hit.group(1)}_gemm_kernel<{hit.group(2)}>: {used}; spill stores "
                  f"{spills.group(1)} B, loads {spills.group(2)} B", flush=True)


def load_variant(name: str, edits):
    """Build csrc with ffn.cu edited into its own library; make it the one
    the wrappers launch."""
    tag = re.sub(r"\W+", "_", name)
    src = os.path.join(OUT, f"csrc_{tag}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    path = os.path.join(src, "ffn.cu")
    text = open(path).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in csrc/ffn.cu")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR, _build._lib = src, os.path.join(OUT, f"lib_{tag}"), None
    try:
        _build.load_library()
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir


def inputs(N: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(N)

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=g, device="cuda")

    t = {"x": rn(N, H), "g": rn(N, H), "w1": rn(H, F, s=0.02), "b1": rn(F, s=0.1),
         "w2": rn(F, H, s=0.02), "b2": rn(H, s=0.1)}
    t = {k: v.bfloat16() for k, v in t.items()}
    t["scale"], t["bias"] = 1.0 + rn(H, s=0.1), rn(H, s=0.1)
    return t


def device_ms(fn, runs: int = 5) -> float:
    """Median of 3 of `runs` back-to-back calls' device ms, held behind a sleep kernel."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / runs)
    return sorted(out)[1]


def calls(t: dict) -> dict:
    a = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    _, pre, s = ffn.ffn_block_fwd(*a, t["scale"], t["bias"], SEED, RATE, save=True)
    return {
        "#3 fwd": lambda: ffn.ffn_fwd(*a, save=True),
        "#3 bwd": lambda: ffn.ffn_bwd(pre, t["g"], t["w1"], t["w2"]),
        "#4 fwd": lambda: ffn.ffn_block_fwd(*a, t["scale"], t["bias"], SEED, RATE, save=True),
        "#4 bwd": lambda: ffn.ffn_block_bwd(s, t["g"], pre, t["w1"], t["w2"], t["scale"], SEED,
                                            RATE),
    }


def kernel_split(fn) -> str:
    """Device ms of one call by kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.sub(r"\(.*", "", e.key.replace("(anonymous namespace)::", ""))
            parts.append(f"{name.split()[-1][:40]} {e.device_time_total / 1e3:.5f}")
    return "; ".join(parts)


def design_a() -> None:
    lib_path = os.path.join(OUT, "libffn_design_a.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                        lib_path, os.path.join(HERE, "ffn_design_a.cu")], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(r.stderr[-4000:])
    info = " ".join(x.strip() for x in r.stderr.splitlines() if "spill" in x or "Used" in x)
    print(f"design A: ptxas {info}", flush=True)
    lib = ctypes.CDLL(lib_path)
    lib.design_a_ffn_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for N in ROWS:
        t = inputs(N)
        w1t, w2t = t["w1"].t().contiguous(), t["w2"].t().contiguous()
        y = torch.empty(N, H, dtype=torch.bfloat16, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run_a():
            err = lib.design_a_ffn_fwd(t["x"].data_ptr(), w1t.data_ptr(), t["b1"].data_ptr(),
                                       w2t.data_ptr(), t["b2"].data_ptr(), y.data_ptr(), N, F,
                                       sms, stream)
            if err:
                raise RuntimeError(f"design A launch: error {err}")

        def run_b():  # the weights in nn.Linear's layout, as the model passes them
            ffn.ffn_fwd(t["x"], w1t.t(), t["b1"], w2t.t(), t["b2"], save=True)

        run_a()
        torch.cuda.synchronize()
        want = ffn.ffn_reference_fwd(t["x"], t["w1"], t["b1"], t["w2"], t["b2"])[0]
        err = float((y.float() - want.float()).abs().max())
        times = {"A": [], "B": []}
        for name in ("A", "B", "B", "A"):
            times[name].append(device_ms(run_a if name == "A" else run_b))
        print(f"design A vs B, #3 forward at {N} rows (bf16): A's max abs err against the plain "
              f"version {err:.3e}; device ms A {times['A']} (y only), B {times['B']} (y and pre)",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ffn_design: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    ptxas_report(os.path.join(_build.CSRC, "ffn.cu"))
    load_variant("as committed", [])
    design_a()
    for name, edits in VARIANTS.items():
        t0 = time.perf_counter()
        load_variant(name, edits)
        print(f"variant {name!r}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        for N in ROWS:
            cs = calls(inputs(N))
            ms = {k: round(device_ms(fn), 5) for k, fn in cs.items()}
            print(f"variant {name!r}, {N} rows: device ms {ms}", flush=True)
            if name == "as committed":
                for k in ("#4 fwd", "#4 bwd"):
                    print(f"  {k} at {N} rows by kernel (one call, torch.profiler): "
                          f"{kernel_split(cs[k])}", flush=True)
            del cs
    return 0


if __name__ == "__main__":
    sys.exit(main())
