"""Grouped in-place beam reorder: the hand-written CUDA kernel and its plain
PyTorch version.

``beam_reorder_groups_inplace`` replaces the Pallas TPU kernel
``univl_tpu/kernels/reorder.py:beam_reorder_groups_inplace`` (the unfused
beam decode's KV-cache permutation): rows permute within consecutive groups
of ``group`` rows, ``out[g*K + k] = in[g*K + prev_k[g*K + k]]``, for every
array at once, in place. On CPU tensors it computes ``reorder_reference``;
on CUDA tensors it launches the kernel in
``univl_tpu_torch/csrc/reorder.cu`` (one launch for all arrays) or raises.
Both are copies, so the two agree bit for bit.

``beam_reorder_rows`` replaces the gather variant,
``univl_tpu/kernels/reorder.py:beam_reorder_rows``: ``out[j][i] =
arrays[j][src[i]]`` into new buffers, duplicates allowed; its plain version
is ``reorder_rows_reference``. The beam decoder keeps the grouped in-place
kernel, as the JAX package's does; no path of the port calls the gather.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from univl_tpu_torch.kernels import _build


MAX_ARRAYS = 16  # kMaxArrays in csrc/reorder.cu
MAX_GROUP = 16  # kMaxGroup
MAX_ROWS = 65535  # the gather's grid.y


def source_rows(prev_k: torch.Tensor, group: int) -> torch.Tensor:
    n = prev_k.shape[0]
    base = torch.arange(0, n, group, device=prev_k.device).repeat_interleave(group)
    return base + prev_k.long()


def reorder_reference(arrays: Sequence[torch.Tensor], prev_k: torch.Tensor,
                      group: int) -> List[torch.Tensor]:
    """The permutation as a row gather, written back into each array."""
    src = source_rows(prev_k, group)
    for a in arrays:
        a.copy_(a.index_select(0, src))
    return list(arrays)


def _check(arrays, prev_k, group) -> None:
    if not arrays:
        raise ValueError("no arrays to reorder")
    n = prev_k.shape[0]
    if prev_k.dim() != 1 or group < 1 or n % group:
        raise ValueError(f"prev_k must be [N] with N a multiple of group={group}, "
                         f"got {tuple(prev_k.shape)}")
    for a in arrays:
        if a.shape[0] != n:
            raise ValueError(f"array rows {a.shape[0]} != prev_k rows {n}")
        if a.device != prev_k.device:
            raise ValueError("arrays and prev_k must be on one device")


def beam_reorder_groups_inplace(arrays: Sequence[torch.Tensor], prev_k: torch.Tensor,
                                group: int) -> List[torch.Tensor]:
    """arrays: tensors with leading dim N (any trailing shape); prev_k: [N]
    LOCAL source index within each row's group. Permutes every array in
    place and returns them."""
    _check(arrays, prev_k, group)
    if prev_k.device.type == "cpu":
        return reorder_reference(arrays, prev_k, group)
    if prev_k.device.type != "cuda":
        raise ValueError(f"no reorder kernel for device {prev_k.device}")
    if len(arrays) > MAX_ARRAYS or group > MAX_GROUP:
        raise ValueError(f"{len(arrays)} arrays in groups of {group}: the kernel takes at most "
                         f"{MAX_ARRAYS} arrays and groups of {MAX_GROUP}")
    for a in arrays:
        row_bytes = a[0].numel() * a.element_size()
        if not a.is_contiguous() or a.data_ptr() % 16 or row_bytes % 16:
            raise ValueError("the reorder kernel moves 16-byte words: each array must be "
                             "contiguous, 16-byte aligned, with rows a multiple of 16 bytes")
    lib = _build.load_library()
    idx = prev_k.to(torch.int32).contiguous()
    ptrs = (ctypes.c_void_p * len(arrays))(*(a.data_ptr() for a in arrays))
    row_bytes = (ctypes.c_longlong * len(arrays))(
        *(a[0].numel() * a.element_size() for a in arrays))
    with torch.cuda.device(prev_k.device):
        stream = torch.cuda.current_stream(prev_k.device).cuda_stream
        err = lib.univl_reorder_groups(ptrs, row_bytes, len(arrays), idx.data_ptr(),
                                       idx.shape[0], group, stream)
    _build.check(lib, err, "reorder kernel launch")
    beam_reorder_groups_inplace.launches += 1
    return list(arrays)


beam_reorder_groups_inplace.launches = 0  # kernel launches; the CPU path adds nothing


def reorder_rows_reference(arrays: Sequence[torch.Tensor], src: torch.Tensor) -> List[torch.Tensor]:
    """The gather in torch ops: one ``index_select`` per array."""
    idx = src.long()
    return [a.index_select(0, idx) for a in arrays]


def beam_reorder_rows(arrays: Sequence[torch.Tensor], src: torch.Tensor) -> List[torch.Tensor]:
    """arrays: tensors sharing a leading dim N (any trailing shape and dtype);
    src: [N] source-row indices, duplicates allowed. Returns new tensors with
    ``out[j][i] = arrays[j][src[i]]``.

    On the card the kernel reads ``src`` without a synchronizing check: an
    index outside [0, N) is not followed and its output row is all zeros (the
    plain version, on the CPU, raises instead)."""
    if not arrays:
        raise ValueError("no arrays to gather")
    n = src.shape[0]
    if src.dim() != 1 or src.dtype.is_floating_point:
        raise ValueError(f"src must be [N] integer indices, got {tuple(src.shape)} {src.dtype}")
    for a in arrays:
        if a.dim() < 1 or a.shape[0] != n:
            raise ValueError(f"array rows {a.shape[0] if a.dim() else None} != src rows {n}")
        if a.device != src.device:
            raise ValueError("arrays and src must be on one device")
    if src.device.type == "cpu":
        return reorder_rows_reference(arrays, src)
    if src.device.type != "cuda":
        raise ValueError(f"no reorder kernel for device {src.device}")
    if len(arrays) > MAX_ARRAYS or n > MAX_ROWS:
        raise ValueError(f"{len(arrays)} arrays of {n} rows: the kernel takes at most "
                         f"{MAX_ARRAYS} arrays of {MAX_ROWS} rows")
    for a in arrays:
        if not a.is_contiguous() or a.data_ptr() % 16 or (a[0].numel() * a.element_size()) % 16:
            raise ValueError("the gather kernel moves 16-byte words: each array must be "
                             "contiguous, 16-byte aligned, with rows a multiple of 16 bytes")
    lib = _build.load_library()
    idx = src.to(torch.int32).contiguous()
    outs = [torch.empty_like(a) for a in arrays]
    k = len(arrays)
    src_ptrs = (ctypes.c_void_p * k)(*(a.data_ptr() for a in arrays))
    dst_ptrs = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
    row_bytes = (ctypes.c_longlong * k)(*(a[0].numel() * a.element_size() for a in arrays))
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.univl_gather_rows(src_ptrs, dst_ptrs, row_bytes, k, idx.data_ptr(), n, stream)
    _build.check(lib, err, "row gather kernel launch")
    beam_reorder_rows.launches += 1
    return outs


beam_reorder_rows.launches = 0  # kernel launches; the CPU path adds nothing
