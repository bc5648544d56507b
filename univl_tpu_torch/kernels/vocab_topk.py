"""Tied-classifier top-k: the hand-written CUDA kernel and its plain PyTorch
version.

``classify_topk`` replaces the Pallas TPU kernel
``univl_tpu/kernels/vocab_topk.py:vocab_topk_partials`` with its epilogue
in ``classify_topk``: the top-k log-probabilities of the tied classifier,
``top_k(log_softmax(h @ w.T + bias), k)``, without the [R, V] f32 logits
ever reaching device memory. On CPU tensors it computes
``classify_topk_reference``; on CUDA tensors it launches the kernels in
``univl_tpu_torch/csrc/vocab_topk.cu`` or raises: in bf16 the tensor-core
tile kernel (every row of h against a vocab tile in one block, up to 160
rows a row group), in f32 the CUDA-core one (the tensor cores
would multiply f32 as TF32), then the merge. Among equal values the
lower index comes first, as ``lax.top_k`` orders them; ``stable_topk`` is
that order for plain tensors (``torch.topk`` promises none among ties).

The kernel takes the classifier padded to its vocab tile: ``pad_vocab_inputs``
pads once, outside the decode loop, with bias -1e30 on the padding rows, so
they give exp() = 0 and never reach the top-k.

``transform=(wt, bt, g, b, eps)`` ports the TPU kernel's ``transform=``
branch (``vocab_topk.py:70, 106-133``): ``h`` is then the decoder's raw
hidden, and the classifier transform (dense, erf-GELU, TF LayerNorm) runs
first, in f32, rounded once to h's dtype (``classifier_transform_reference``).
``wt`` is the dense's weight as ``nn.Linear`` stores it, [H_out, H_in] (JAX's
kernel takes Flax's [H_in, H_out]); all four tensors are f32, the
parameters themselves. On the card one C entry point launches the transform's
two kernels and then the vocab kernels.

Each call on the card is counted once, by route: ``classify_topk.launches``
(bf16, the tensor cores), ``.cuda_core_launches`` (f32), and with the
transform ``.transform_launches`` and ``.cuda_core_transform_launches``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from univl_tpu_torch.kernels import _build

VOCAB_TILE = 128  # kTileV in csrc/vocab_topk.cu: a block's vocab rows, on either route
HIDDEN_CHUNK = 32  # kChunkH: the f32 kernel's depth a stage
TC_DEPTH = 64  # kTcDepth: the bf16 kernel's depth a stage
MAX_K = 32  # kMaxK
TRANSFORM_CHUNK = 128  # kTfChunk: the transform's H is a multiple of it
PAD_BIAS = -1e30  # univl_tpu/kernels/vocab_topk.py:38


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim, descending, lower index first among equal
    values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pad_vocab_inputs(w: torch.Tensor, bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w [V, H], bias [V]) -> both padded to a multiple of the kernel's vocab
    tile, w with zero rows, bias (as f32) with -1e30."""
    pad = -w.shape[0] % VOCAB_TILE
    return (F.pad(w, (0, 0, 0, pad)).contiguous(),
            F.pad(bias.float(), (0, pad), value=PAD_BIAS).contiguous())


Transform = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float]


def classifier_transform_reference(h: torch.Tensor, wt: torch.Tensor, bt: torch.Tensor,
                                   g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """The transform's math in torch ops, all f32, rounded once to h's dtype:
    dense (``h @ wt.T + bt``), erf-GELU, TF LayerNorm (eps inside the rsqrt)."""
    t = h.float() @ wt.float().t() + bt.float()
    t = t * 0.5 * (1.0 + torch.erf(t / math.sqrt(2.0)))
    u = t.mean(dim=-1, keepdim=True)
    s = (t - u).square().mean(dim=-1, keepdim=True)
    t = (t - u) * torch.rsqrt(s + eps)
    return (t * g.float() + b.float()).to(h.dtype)


def classify_topk_reference(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                            k: int, transform: Optional[Transform] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in torch ops: the transform when given, f32 logits
    from the operands as given, the log-softmax normalizer, and ``stable_topk``."""
    if transform is not None:
        h = classifier_transform_reference(h, *transform)
    logits = h.float() @ w.float().t() + bias.float()
    return stable_topk(logits - torch.logsumexp(logits, dim=-1, keepdim=True), k)


def _check(h, w, bias, k) -> None:
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"h must be [R, H] and w [V, H]; got {tuple(h.shape)}, {tuple(w.shape)}")
    if tuple(bias.shape) != (w.shape[0],):
        raise ValueError(f"bias must be [V] = [{w.shape[0]}], got {tuple(bias.shape)}")
    if h.dtype not in (torch.float32, torch.bfloat16) or w.dtype != h.dtype:
        raise TypeError(f"h and w must share one dtype, float32 or bfloat16; got {h.dtype}, "
                        f"{w.dtype}")
    if not 1 <= k <= min(MAX_K, w.shape[0]):
        raise ValueError(f"k={k} outside [1, {min(MAX_K, w.shape[0])}]")
    if len({h.device, w.device, bias.device}) != 1:
        raise ValueError("h, w and bias must be on one device")


def _check_transform(h, transform) -> None:
    wt, bt, g, b, _ = transform
    H = h.shape[1]
    if tuple(wt.shape) != (H, H) or any(tuple(t.shape) != (H,) for t in (bt, g, b)):
        raise ValueError(f"transform must be wt [{H}, {H}] and bt, g, b [{H}]; got "
                         f"{[tuple(t.shape) for t in (wt, bt, g, b)]}")
    if any(t.dtype != torch.float32 for t in (wt, bt, g, b)):
        raise TypeError("the transform's parameters must be float32")
    if any(t.device != h.device for t in (wt, bt, g, b)):
        raise ValueError("the transform's parameters must be on h's device")


def classify_topk(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, k: int,
                  transform: Optional[Transform] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [R, H]; w [V, H] of h's dtype; bias [V]. Returns (logp [R, k] f32
    descending, idx [R, k] int64). On the card, w and bias must come from
    ``pad_vocab_inputs``, once, outside the decode loop. With ``transform``
    (wt [H, H] as nn.Linear stores it, bt, g, b [H], all f32; eps), h is the
    raw hidden and the classifier transform runs first (module docstring)."""
    _check(h, w, bias, k)
    if transform is not None:
        _check_transform(h, transform)
    if h.device.type == "cpu":
        return classify_topk_reference(h, w, bias, k, transform)
    R, H = h.shape
    depth = TC_DEPTH if h.dtype == torch.bfloat16 else HIDDEN_CHUNK
    if w.shape[0] % VOCAB_TILE or H % depth:
        raise ValueError(f"the kernel takes w padded to a multiple of {VOCAB_TILE} rows "
                         f"(pad_vocab_inputs) and H a multiple of {depth}; got "
                         f"{tuple(w.shape)}")
    if transform is not None and H % TRANSFORM_CHUNK:
        raise ValueError(f"the transform kernel takes H a multiple of {TRANSFORM_CHUNK}, got {H}")
    if h.device.type != "cuda":
        raise ValueError(f"no vocab top-k kernel for device {h.device}")
    h, w, bias = h.contiguous(), w.contiguous(), bias.float().contiguous()
    if h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("h and w must be 16-byte aligned")
    lib = _build.load_library()
    n_tiles = w.shape[0] // VOCAB_TILE
    dev = h.device
    part_val = torch.empty(n_tiles, R, k, dtype=torch.float32, device=dev)
    part_idx = torch.empty(n_tiles, R, k, dtype=torch.int32, device=dev)
    part_max = torch.empty(n_tiles, R, dtype=torch.float32, device=dev)
    part_sum = torch.empty(n_tiles, R, dtype=torch.float32, device=dev)
    logp = torch.empty(R, k, dtype=torch.float32, device=dev)
    idx = torch.empty(R, k, dtype=torch.int64, device=dev)
    tail = (int(h.dtype == torch.bfloat16), R, H, w.shape[0], k, part_val.data_ptr(),
            part_idx.data_ptr(), part_max.data_ptr(), part_sum.data_ptr(), logp.data_ptr(),
            idx.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if transform is None:
            err = lib.univl_vocab_topk(h.data_ptr(), w.data_ptr(), bias.data_ptr(), *tail,
                                       stream)
        else:
            wt, bt, g, b, eps = (t.contiguous() if torch.is_tensor(t) else t for t in transform)
            if wt.data_ptr() % 16:
                raise ValueError("the transform's wt must be 16-byte aligned")
            u = torch.empty(R, H, dtype=torch.float32, device=dev)
            ht = torch.empty_like(h)
            err = lib.univl_vocab_topk_transform(
                h.data_ptr(), wt.data_ptr(), bt.data_ptr(), g.data_ptr(), b.data_ptr(),
                float(eps), u.data_ptr(), ht.data_ptr(), w.data_ptr(), bias.data_ptr(), *tail,
                stream)
    _build.check(lib, err, "vocab top-k kernel launch")
    counter = (("" if h.dtype == torch.bfloat16 else "cuda_core_")
               + ("launches" if transform is None else "transform_launches"))
    setattr(classify_topk, counter, getattr(classify_topk, counter) + 1)
    return logp, idx


# calls on the card by route (bf16: the tensor cores; f32: the CUDA cores),
# without and with the transform; the CPU path adds nothing
classify_topk.launches = 0
classify_topk.cuda_core_launches = 0
classify_topk.transform_launches = 0
classify_topk.cuda_core_transform_launches = 0
