"""Eval attention: the hand-written CUDA kernels and their plain PyTorch version.

``fused_attention_masked`` replaces the Pallas TPU kernel
``univl_tpu/kernels/attention.py:fused_attention_masked`` and keeps its
signature and ``[B, H, L, D]`` layout. On a CPU tensor it computes
``attention_reference``; on a CUDA tensor it launches a kernel in
``univl_tpu_torch/csrc/attention.cu`` (built at first use) or raises.

``cuda_route`` picks the kernel. bf16 at head dim 64 with at most 256 keys
(every bf16 call of the model) takes the tensor-core kernel (``mma.sync``,
f32 accumulators, one block per (batch row, head, query tile)); its launches
are counted in ``fused_attention_masked.launches``. f32, and any other bf16
head, takes the CUDA-core kernel: the tensor cores would multiply f32 as
TF32, which would break the card's f32 agreement with the plain version. Its
launches are counted in ``fused_attention_masked.cuda_core_launches``.

``causal=True`` is the TPU kernel's causal branch (``attention.py:47-51``):
after the key bias, every score whose key column is past its query row is
-1e9, with row and column compared directly (no offset when Lq != Lk). No
path of the port sets it, as none of the JAX package does
(``fused_attention`` passes ``causal=False``). It takes the same route; its
launches are counted apart, in ``causal_launches`` and
``cuda_core_causal_launches``.

Attention at UniVL's lengths (L <= 224, D = 64) does ~24-48 flop per byte
read, so the kernels are bound by memory and latency, not by the tensor
cores: both read q, k and v once, keep the scores on chip, and read strided
head-split views so the projections are never transposed in memory; the
source file's header says how.
"""

from __future__ import annotations

import math

import torch

from univl_tpu_torch.kernels import _build

MASK_BIAS = -1e9  # in-kernel key bias (univl_tpu/kernels/attention.py:45)
MAX_HEAD_DIM = 128
SMEM_LIMIT = 227 * 1024  # Hopper's opt-in shared memory per block
TENSOR_CORES, CUDA_CORES = "tensor cores", "CUDA cores"
MMA_HEAD_DIM = 64  # the tensor-core kernel's head dim
MMA_MAX_KEYS = 256  # it holds a query row's scores in registers
MMA_MAX_WARPS = 4  # 16-row query tiles a block of it takes, at most


def cuda_route(dtype, head_dim: int, Lq: int, Lk: int) -> str:
    """The kernel a CUDA call takes: TENSOR_CORES for bf16 at head dim 64
    with Lk <= 256 (every bf16 call of the model; any Lq), else CUDA_CORES
    (f32, which the tensor cores would multiply as TF32, and other bf16
    heads)."""
    del Lq  # one block per query tile: every length
    if dtype == torch.bfloat16 and head_dim == MMA_HEAD_DIM and Lk <= MMA_MAX_KEYS:
        return TENSOR_CORES
    return CUDA_CORES


def query_tile_warps(Lq: int) -> int:
    """16-row query tiles (one warp each) a block of the tensor-core kernel
    takes: 3 where Lq is a multiple of 48 (the towers' 48 and the cross
    tower's 96: no ragged tile), else 4 (a block stages the head's k and v
    once for 64 rows; at 224 that beats tiles that divide evenly)."""
    return 3 if Lq % 48 == 0 else MMA_MAX_WARPS


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """The kernel's math in torch ops: f32 scores and softmax, probs rounded
    to ``v.dtype`` before PV, PV summed in f32, output in ``q.dtype``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    scores = scores + ((1.0 - key_mask.float()) * MASK_BIAS)[:, None, None, :]
    if causal:
        Lq, Lk = scores.shape[-2:]
        future = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(future, MASK_BIAS)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(q.dtype)


def _check(q, k, v, key_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, D]")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if tuple(key_mask.shape) != (B, Lk):
        raise ValueError(f"key_mask must be [B, Lk] = {(B, Lk)}, got {tuple(key_mask.shape)}")
    if min(Lq, Lk, D) < 1 or D > MAX_HEAD_DIM:
        raise ValueError(f"need L >= 1 and 1 <= D <= {MAX_HEAD_DIM}, got Lq={Lq} Lk={Lk} D={D}")
    if len({q.device, k.device, v.device, key_mask.device}) != 1:
        raise ValueError("q, k, v and key_mask must be on one device")


def _check_layout(t: torch.Tensor, name: str) -> None:
    vec = 16 // t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16 or t.shape[3] % vec
            or any(t.stride(i) % vec for i in range(3))):
        raise ValueError(
            f"{name}: the kernel reads 16-byte rows; it needs a contiguous last dim, a "
            f"16-byte aligned start, and D and the other strides multiples of {vec}")


def _launch(q, k, v, key_mask, causal: bool, tensor_cores: bool) -> torch.Tensor:
    """The tensor-core or the CUDA-core kernel on CUDA tensors, uncounted."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_layout(t, name)
    lib = _build.load_library()
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    warps = query_tile_warps(Lq) if tensor_cores else 0
    smem = lib.univl_eval_attention_smem_bytes(Lk, D, warps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"Lk={Lk}, D={D} needs {smem} bytes of shared memory per block; "
                         f"the limit is {SMEM_LIMIT}")
    mask = key_mask.to(torch.float32).contiguous()
    # [B, Lq, H, D] memory seen as [B, H, Lq, D]: merging heads afterwards is free
    out = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tensor_cores:
            err = lib.univl_eval_attention_mma(*ptrs, B, H, Lq, Lk, D, *strides,
                                               1.0 / math.sqrt(D), int(causal), warps, stream)
        else:
            err = lib.univl_eval_attention(*ptrs, int(q.dtype == torch.bfloat16), B, H, Lq, Lk,
                                           D, *strides, 1.0 / math.sqrt(D), int(causal), stream)
    _build.check(lib, err, "eval attention kernel launch")
    return out


def fused_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_mask: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, L, D] (strided views allowed); key_mask: [B, Lk], 1 keep
    and 0 drop; ``causal``: also drop keys past the query's row. Returns
    [B, H, Lq, D] in q's dtype. No dropout (inference)."""
    _check(q, k, v, key_mask)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no eval-attention kernel for device {q.device}")
    tensor_cores = cuda_route(q.dtype, q.shape[3], q.shape[2], k.shape[2]) == TENSOR_CORES
    out = _launch(q, k, v, key_mask, causal, tensor_cores)
    counter = ("" if tensor_cores else "cuda_core_") + ("causal_launches" if causal else "launches")
    setattr(fused_attention_masked, counter, getattr(fused_attention_masked, counter) + 1)
    return out


# kernel launches by route (tensor cores, CUDA cores), without and with the
# causal mask; the CPU path adds nothing
fused_attention_masked.launches = 0
fused_attention_masked.cuda_core_launches = 0
fused_attention_masked.causal_launches = 0
fused_attention_masked.cuda_core_causal_launches = 0
