"""Fused beam-decode self-attention: the hand-written CUDA kernel and its
plain PyTorch version.

``beam_decode_self_attention`` replaces the Pallas TPU kernel
``univl_tpu/kernels/decode_attention.py:beam_decode_self_attention`` and
keeps its signature: for one decoder layer and one beam step it applies the
pending beam permutation to the KV cache, writes position ``t``, and attends
over positions ``0..t``, in one pass over the cache. On CPU tensors it
computes ``decode_attention_reference``; on CUDA tensors it launches the
kernel in ``univl_tpu_torch/csrc/decode_attention.cu`` or raises.

The position ``t`` is a 0-d int32 tensor on the inputs' device, which the
kernel reads from device memory (the TPU kernel's scalar-prefetch operand),
so a captured CUDA graph replays one launch for every position; an int is
made such a tensor and checked against the cache length first. A tensor's
range is the caller's to keep (the beam search checks its host count of
the position before each step): the kernel writes nothing for a position
outside the cache.

The returned caches are new tensors (the TPU kernel's ``donate=False``
form), or the caller's ``out=(k_out, v_out)``, which must not be the input
caches: the in-place form would race between the rows of a group.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from univl_tpu_torch.kernels import _build
from univl_tpu_torch.kernels.reorder import source_rows

MASK_BIAS = -1e9  # univl_tpu/kernels/decode_attention.py:159


def as_position(t: Union[int, torch.Tensor], device, length: Optional[int] = None
                ) -> torch.Tensor:
    """``t`` as a 0-d int32 tensor on ``device``: a tensor is checked for its
    form only (its value stays on the device), an int is checked against
    ``length`` (a cache length) where given and made one."""
    if torch.is_tensor(t):
        if t.dim() != 0 or t.dtype != torch.int32 or t.device != torch.device(device):
            raise ValueError(f"position t must be a 0-d int32 tensor on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        return t
    if length is not None and not 0 <= t < length:
        raise ValueError(f"position t={t} outside the cache length {length}")
    return torch.full((), t, dtype=torch.int32, device=device)


def decode_attention_reference(q, k_new, v_new, k_cache, v_cache, prev_k, t, group: int,
                               scale: float, out=None):
    """The kernel's math in torch ops: permuted caches with position t
    written and positions > t zero; f32 scores and softmax over 0..t; probs
    rounded to the cache dtype before PV, PV summed in f32. ``t`` is an int
    or a 0-d tensor, read on the device only; ``out`` as the kernel's."""
    src = source_rows(prev_k, group)
    pos = torch.arange(k_cache.shape[2], device=k_cache.device)[:, None]  # [L, 1]
    caches = []
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        c = c.index_select(0, src)
        c = torch.where(pos == t, new[:, :, None], c)
        caches.append(c.masked_fill(pos > t, 0))
    kc, vc = caches
    scores = torch.einsum("nhd,nhld->nhl", q.float(), kc.float()) * scale
    scores = scores.masked_fill(pos[:, 0] > t, MASK_BIAS)
    probs = torch.softmax(scores, dim=-1).to(kc.dtype)
    ctx = torch.einsum("nhl,nhld->nhd", probs.float(), vc.float()).to(kc.dtype)
    if out is not None:
        kc, vc = out[0].copy_(kc), out[1].copy_(vc)
    return ctx, kc, vc


def _check(q, k_new, v_new, k_cache, v_cache, prev_k, group, out) -> None:
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"caches must be [N, H, L, D] alike, got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    N, H, L, D = k_cache.shape
    for x, name in ((q, "q"), (k_new, "k_new"), (v_new, "v_new")):
        if tuple(x.shape) != (N, H, D):
            raise ValueError(f"{name} must be [N, H, D] = {(N, H, D)}, got {tuple(x.shape)}")
    dtypes = {x.dtype for x in (q, k_new, v_new, k_cache, v_cache)}
    if len(dtypes) != 1 or k_cache.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k_new, v_new and the caches must share one dtype, float32 or "
                        f"bfloat16; got {sorted(map(str, dtypes))}")
    if tuple(prev_k.shape) != (N,) or group < 1 or N % group:
        raise ValueError(f"prev_k must be [N] = [{N}] with N a multiple of group={group}")
    if len({x.device for x in (q, k_new, v_new, k_cache, v_cache, prev_k)}) != 1:
        raise ValueError("all inputs must be on one device")
    if out is not None:
        if len(out) != 2 or any(o.shape != k_cache.shape or o.dtype != k_cache.dtype
                                or o.device != k_cache.device or not o.is_contiguous()
                                for o in out):
            raise ValueError(f"out must be two contiguous caches like the inputs, "
                             f"{tuple(k_cache.shape)} {k_cache.dtype}")
        if any(o.data_ptr() == c.data_ptr() for o in out for c in (k_cache, v_cache)):
            raise ValueError("out must not be the input caches: rows of a group would race")


def _check_layout(q, k_new, v_new, k_cache, v_cache) -> None:
    N, H, L, D = k_cache.shape
    vec = 16 // k_cache.element_size()
    lpr = D // vec
    if D % vec or lpr > 32 or lpr & (lpr - 1):
        raise ValueError(f"D={D}: the kernel needs D * itemsize to be 16 bytes times a power "
                         f"of two no larger than 32")
    for x, name in ((q, "q"), (k_new, "k_new"), (v_new, "v_new")):
        if x.stride(2) != 1 or x.stride(1) != D or x.stride(0) % vec or x.data_ptr() % 16:
            raise ValueError(f"{name}: rows of contiguous [H, D], 16-byte aligned")
    for x, name in ((k_cache, "k_cache"), (v_cache, "v_cache")):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: contiguous and 16-byte aligned")


def beam_decode_self_attention(
    q: torch.Tensor,        # [N, H, D] step queries (new beam order)
    k_new: torch.Tensor,    # [N, H, D] step keys
    v_new: torch.Tensor,    # [N, H, D] step values
    k_cache: torch.Tensor,  # [N, H, L, D] rows in the PREVIOUS beam order
    v_cache: torch.Tensor,  # [N, H, L, D]
    prev_k: torch.Tensor,   # [N] LOCAL source row within each group
    t: Union[int, torch.Tensor],  # position being decoded: an int or a 0-d int32 tensor
    group: int,             # beam width K
    *,
    scale: float,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (k_out, v_out)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (ctx [N, H, D], new_k_cache, new_v_cache), the caches in the
    NEW beam order with position t written (``out`` when given). The kernel
    reads only positions < t of the input caches and writes zeros past t."""
    _check(q, k_new, v_new, k_cache, v_cache, prev_k, group, out)
    t = as_position(t, q.device, k_cache.shape[2])
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_new, v_new, k_cache, v_cache, prev_k, t,
                                          group, scale, out)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for device {q.device}")
    _check_layout(q, k_new, v_new, k_cache, v_cache)
    lib = _build.load_library()
    N, H, L, D = k_cache.shape
    idx = prev_k.to(torch.int32).contiguous()
    ctx = torch.empty(N, H, D, dtype=k_cache.dtype, device=q.device)
    k_out, v_out = out if out is not None else (torch.empty_like(k_cache),
                                                torch.empty_like(v_cache))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.univl_decode_attention(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0), k_new.stride(0),
            v_new.stride(0), k_cache.data_ptr(), v_cache.data_ptr(), idx.data_ptr(),
            ctx.data_ptr(), k_out.data_ptr(), v_out.data_ptr(),
            int(k_cache.dtype == torch.bfloat16), N, H, L, D, t.data_ptr(), group,
            float(scale), stream)
    _build.check(lib, err, "decode attention kernel launch")
    beam_decode_self_attention.launches += 1
    return ctx, k_out, v_out


beam_decode_self_attention.launches = 0  # kernel launches; the CPU path adds nothing
