"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``univl_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one compiler process per source, all started together, and the
objects are linked into one shared library with a plain C interface, placed
under ``build/univl_tpu_torch/`` at the root of the checkout and named by a
hash of the sources, so an edited source builds anew and an unchanged one is
reused. The build writes to per-process temporary names and renames the
library into place, so concurrent first uses never load a half-written one.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "univl_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libunivl_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists; return its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{path}.tmp{os.getpid()}"
    cu = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for s, o in zip(cu, objs)]
    try:
        failed = []
        for s, p in zip(cu, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                failed.append(f"{os.path.basename(s)} ({p.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, path)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.univl_eval_attention.argtypes = (
        [p, p, p, p, p, i, i, i, i, i, i] + [ll] * 12 + [ctypes.c_float, i, p]
    )
    lib.univl_eval_attention.restype = i
    lib.univl_eval_attention_mma.argtypes = (
        [p, p, p, p, p, i, i, i, i, i] + [ll] * 12 + [ctypes.c_float, i, i, p]
    )
    lib.univl_eval_attention_mma.restype = i
    lib.univl_eval_attention_smem_bytes.argtypes = [i, i, i]
    lib.univl_eval_attention_smem_bytes.restype = ll
    lib.univl_reorder_groups.argtypes = [p, p, i, p, i, i, p]
    lib.univl_reorder_groups.restype = i
    lib.univl_gather_rows.argtypes = [p, p, p, i, p, i, p]
    lib.univl_gather_rows.restype = i
    lib.univl_decode_attention.argtypes = (
        [p, p, p, ll, ll, ll, p, p, p, p, p, p] + [i] * 7 + [ctypes.c_float, p]
    )
    lib.univl_decode_attention.restype = i
    lib.univl_vocab_topk.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.univl_vocab_topk.restype = i
    lib.univl_vocab_topk_transform.argtypes = (
        [p] * 5 + [ctypes.c_float] + [p] * 4 + [i] * 5 + [p] * 7)
    lib.univl_vocab_topk_transform.restype = i
    lib.univl_train_attention_smem_bytes.argtypes = [i, i, i, i]
    lib.univl_train_attention_smem_bytes.restype = ll
    shared = [i] * 6 + [ctypes.c_float, ctypes.c_uint, ctypes.c_float, i, ctypes.c_ulonglong, p]
    lib.univl_train_attention_fwd.argtypes = [p] * 7 + shared
    lib.univl_train_attention_fwd.restype = i
    lib.univl_train_attention_bwd.argtypes = [p] * 10 + shared
    lib.univl_train_attention_bwd.restype = i
    lib.univl_train_attention_bwd_tiled.argtypes = [p] * 11 + shared
    lib.univl_train_attention_bwd_tiled.restype = i
    lib.univl_train_attention_fwd_mma.argtypes = [p] * 7 + shared
    lib.univl_train_attention_fwd_mma.restype = i
    lib.univl_train_attention_bwd_mma.argtypes = [p] * 11 + shared
    lib.univl_train_attention_bwd_mma.restype = i
    lib.univl_layernorm_max_width.argtypes = []
    lib.univl_layernorm_max_width.restype = i
    lib.univl_layernorm_fwd.argtypes = [p] * 4 + [i, i, i, ctypes.c_float, p]
    lib.univl_layernorm_fwd.restype = i
    lib.univl_layernorm_bwd.argtypes = [p] * 7 + [i, i, i, ctypes.c_float, i, p]
    lib.univl_layernorm_bwd.restype = i
    drop = [ctypes.c_float, ctypes.c_uint, ctypes.c_float, i, ctypes.c_ulonglong, p]
    lib.univl_ffn_block_rows.argtypes = []
    lib.univl_ffn_block_rows.restype = i
    lib.univl_ffn_fwd.argtypes = [p] * 10 + [i] * 4 + drop
    lib.univl_ffn_fwd.restype = i
    lib.univl_ffn_bwd.argtypes = [p] * 12 + [i] * 4 + drop
    lib.univl_ffn_bwd.restype = i
    lib.univl_ffn_fwd_tc.argtypes = [p] * 12 + [i] * 5 + drop
    lib.univl_ffn_fwd_tc.restype = i
    lib.univl_ffn_bwd_tc.argtypes = [p] * 14 + [i] * 6 + drop
    lib.univl_ffn_bwd_tc.restype = i
    lib.univl_dense_block_fwd.argtypes = [p] * 8 + [i] * 2 + drop
    lib.univl_dense_block_fwd.restype = i
    lib.univl_dense_block_bwd.argtypes = [p] * 9 + [i] * 2 + drop
    lib.univl_dense_block_bwd.restype = i
    lib.univl_dense_block_fwd_tc.argtypes = [p] * 8 + [i] * 2 + drop
    lib.univl_dense_block_fwd_tc.restype = i
    lib.univl_dense_block_bwd_tc.argtypes = [p] * 9 + [i] * 3 + drop
    lib.univl_dense_block_bwd_tc.restype = i
    lib.univl_cuda_error_string.argtypes = [i]
    lib.univl_cuda_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call and cached for the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.univl_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
