"""Counter-based Philox4x32-10 in PyTorch: the dropout bits that the port's
kernels draw, for their plain versions.

The TPU kernels draw their dropout bits from the TPU's own generator
(``pltpu.prng_random_bits`` seeded with seed + program id), which cannot be
reproduced off the TPU. The port's kernels (``csrc/philox.cuh``) and their
plain versions draw them from Philox4x32-10 instead: a keep bit is a pure
function of (seed, counter), so a forward kernel, a backward kernel and a
plain version see the same mask whatever their block shapes. The
distribution is the TPU's; the bits are not.

Counters, one Philox call per four neighbouring elements of a row:
- training attention (#2): element (b, h, i, j) is word ``j % 4`` of
  Philox(counter = (j // 4, i, h, b)); a tensor-parallel rank's call on
  heads [head0, head0 + H) counts h from head0;
- fused FFN block (#4) and fused dense block (#5): element (row, col) is
  word ``col % 4`` of Philox(counter = (col // 4, row, tag, 0)), ``tag``
  ``FFN_BLOCK_TAG`` or ``DENSE_BLOCK_TAG``; a sequence-parallel rank's rows
  are rows [row0, row0 + N) of the whole call (``row_dropout_keep``'s row0);
each under the call's 64-bit seed as the key. An element is kept where its
word is at least ``keep_threshold(rate)``.

The kernels read the key from device memory (``key_pointer``): a host int is
copied there for the call, and a ``DeviceKey`` names a slot that already
holds it, a training step's key table under a CUDA graph
(``train/trainer.py:Trainer.train_steps``), whose replays write each step's
keys there first. The plain versions take the host int (``key_value``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

# Philox4x32-10 constants (Salmon et al., SC'11; the Random123 values)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF

FFN_BLOCK_TAG = 4  # the third counter word of #4's draws
DENSE_BLOCK_TAG = 5  # and of #5's


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of a * b, for a 32-bit constant a and an
    int64 tensor b holding 32-bit values. Products of 16-bit halves keep
    every intermediate below 2**49, so no int64 product overflows."""
    p_lo = a * (b & 0xFFFF)
    mid = a * (b >> 16) + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(c0, c1, c2, c3, seed: int, rounds: int = 10):
    """Philox4x32 over int64 counter tensors (32-bit values, broadcast
    together) with the 64-bit key ``seed``; returns the four output words."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """Keep where the 32-bit word is >= this (univl_tpu/kernels/train_attention.py:61)."""
    return min(int(rate * 2**32), 2**32 - 1)


def row_dropout_keep(seed: int, rows: int, cols: int, tag: int, rate: float,
                     device=None, row0: int = 0) -> torch.Tensor:
    """The keep mask of #4 and #5 over rows [row0, row0 + rows), bool
    [rows, cols]: word ``col % 4`` of Philox(counter = (col // 4, row, tag, 0))."""
    quads = -(-cols // 4)
    c0 = torch.arange(quads, dtype=torch.int64, device=device)[None, :]
    c1 = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)[:, None]
    c0, c1 = torch.broadcast_tensors(c0, c1)
    const = torch.zeros((), dtype=torch.int64, device=device)
    words = torch.stack(philox4x32(c0, c1, const + tag, const, seed), dim=-1)
    return words.reshape(rows, 4 * quads)[:, :cols] >= keep_threshold(rate)


class DeviceKey(NamedTuple):
    """A Philox key in device memory: ``value``, the host int (the plain
    versions' key), and ``ref``, a one-element int64 tensor on the card, the
    slot a kernel reads it from (a captured step's slot holds the key that
    step's replay wrote, ``value`` the key of the step captured)."""

    value: int
    ref: torch.Tensor


Key = Union[int, DeviceKey]


def key_value(seed: Key) -> int:
    """The host int of a key."""
    return seed.value if isinstance(seed, DeviceKey) else int(seed)


def key_pointer(seed: Key, rate: float, device) -> Tuple[Optional[int], Optional[torch.Tensor]]:
    """(address, tensor) of the one-element int64 tensor on ``device`` that a
    dropping kernel reads its key from, to hold through the launch: a
    ``DeviceKey``'s slot, or a host int copied there (from pinned memory,
    without a sync). (None, None) at rate 0, where no kernel reads it. A host
    int under CUDA graph capture is refused: the copy would replay the
    captured step's key."""
    if rate <= 0.0:
        return None, None
    if isinstance(seed, DeviceKey):
        t = seed.ref
        if t.dtype != torch.int64 or t.numel() != 1 or t.device != torch.device(device):
            raise ValueError(f"a key slot is one int64 on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    else:
        if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a host-int Philox key under CUDA graph capture would be baked "
                               "into the graph: pass a DeviceKey")
        v = int(seed) & 0xFFFFFFFFFFFFFFFF
        host = torch.tensor([v - (1 << 64) if v >> 63 else v], dtype=torch.int64).pin_memory()
        t = host.to(device, non_blocking=True)
    return t.data_ptr(), t
