"""Eval attention: the hand-written CUDA kernel and its plain PyTorch version.

``fused_attention_masked`` replaces the Pallas TPU kernel
``univl_tpu/kernels/attention.py:fused_attention_masked`` and keeps its
signature and ``[B, H, L, D]`` layout. On a CPU tensor it computes
``attention_reference``; on a CUDA tensor it launches the kernel in
``univl_tpu_torch/csrc/attention.cu`` (built at first use) or raises.

The kernel is bound by memory and latency, not by the tensor cores: at
UniVL's lengths (L <= 96, D = 64) attention does ~24 flop per byte read. The
kernel reads q, k and v once, keeps the scores on chip, and reads strided
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


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor) -> torch.Tensor:
    """The kernel's math in torch ops: f32 scores and softmax, probs rounded
    to ``v.dtype`` before PV, PV summed in f32, output in ``q.dtype``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    scores = scores + ((1.0 - key_mask.float()) * MASK_BIAS)[:, None, None, :]
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


def fused_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_mask: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, H, L, D] (strided views allowed); key_mask: [B, Lk], 1 keep
    and 0 drop. Returns [B, H, Lq, D] in q's dtype. No dropout (inference)."""
    _check(q, k, v, key_mask)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no eval-attention kernel for device {q.device}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_layout(t, name)
    lib = _build.load_library()
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    smem = lib.univl_eval_attention_smem_bytes(Lk, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"Lk={Lk}, D={D} needs {smem} bytes of shared memory per block; "
                         f"the limit is {SMEM_LIMIT}")
    mask = key_mask.to(torch.float32).contiguous()
    # [B, Lq, H, D] memory seen as [B, H, Lq, D]: merging heads afterwards is free
    out = torch.empty(B, Lq, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.univl_eval_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, H, Lq, Lk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            1.0 / math.sqrt(D), stream,
        )
    _build.check(lib, err, "eval attention kernel launch")
    fused_attention_masked.launches += 1
    return out


fused_attention_masked.launches = 0  # kernel launches; the CPU path adds nothing
