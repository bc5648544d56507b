"""Tied-classifier top-k: the hand-written CUDA kernel and its plain PyTorch
version.

``classify_topk`` replaces the Pallas TPU kernel
``univl_tpu/kernels/vocab_topk.py:vocab_topk_partials`` with its epilogue
in ``classify_topk``: the top-k log-probabilities of the tied classifier,
``top_k(log_softmax(h @ w.T + bias), k)``, without the [R, V] f32 logits
ever reaching device memory. On CPU tensors it computes
``classify_topk_reference``; on CUDA tensors it launches the kernels in
``univl_tpu_torch/csrc/vocab_topk.cu`` or raises. Among equal values the
lower index comes first, as ``lax.top_k`` orders them; ``stable_topk`` is
that order for plain tensors (``torch.topk`` promises none among ties).

The kernel takes the classifier padded to its vocab tile: ``pad_vocab_inputs``
pads once, outside the decode loop, with bias -1e30 on the padding rows, so
they give exp() = 0 and never reach the top-k.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from univl_tpu_torch.kernels import _build

VOCAB_TILE = 128  # kTileV in csrc/vocab_topk.cu
HIDDEN_CHUNK = 32  # kChunkH
MAX_K = 32  # kMaxK
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


def classify_topk_reference(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in torch ops: f32 logits from the operands as given,
    the log-softmax normalizer, and ``stable_topk``."""
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


def classify_topk(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [R, H]; w [V, H] of h's dtype; bias [V]. Returns (logp [R, k] f32
    descending, idx [R, k] int64). On the card, w and bias must come from
    ``pad_vocab_inputs``, once, outside the decode loop."""
    _check(h, w, bias, k)
    if h.device.type == "cpu":
        return classify_topk_reference(h, w, bias, k)
    if h.device.type != "cuda":
        raise ValueError(f"no vocab top-k kernel for device {h.device}")
    R, H = h.shape
    if w.shape[0] % VOCAB_TILE or H % HIDDEN_CHUNK:
        raise ValueError(f"the kernel takes w padded to a multiple of {VOCAB_TILE} rows "
                         f"(pad_vocab_inputs) and H a multiple of {HIDDEN_CHUNK}; got "
                         f"{tuple(w.shape)}")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.univl_vocab_topk(
            h.data_ptr(), w.data_ptr(), bias.data_ptr(), int(h.dtype == torch.bfloat16), R, H,
            w.shape[0], k, part_val.data_ptr(), part_idx.data_ptr(), part_max.data_ptr(),
            part_sum.data_ptr(), logp.data_ptr(), idx.data_ptr(), stream)
    _build.check(lib, err, "vocab top-k kernel launch")
    classify_topk.launches += 1
    return logp, idx


classify_topk.launches = 0  # kernel launches; the CPU path adds nothing
