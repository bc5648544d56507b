"""Fused FFN kernels #3, #4 and #5: the hand-written CUDA kernels (forward
and backward) and their plain PyTorch versions.

Counterpart of ``univl_tpu/kernels/ffn.py``, with its signatures, layouts
and return values:
- ``fused_ffn(x, w1, b1, w2, b2)`` (#3): ``gelu(x @ w1 + b1) @ w2 + b2``;
- ``fused_ffn_block(x, w1, b1, w2, b2, scale, bias, seed, rate, eps)`` (#4):
  ``LayerNormTF(dropout(FFN(x)) + x)``, the BertOutput epilogue folded in;
- ``fused_dense_block(x, r, w, b, scale, bias, seed, rate, eps)`` (#5):
  ``LayerNormTF(dropout(x @ w + b) + r)``, the BertSelfOutput epilogue.
x, r: ``[N, H]``; w1 ``[H, F]``, w2 ``[F, H]``, w ``[H, H]`` (``x @ w``, the
JAX layout, not ``nn.Linear``'s); weights and biases in the compute dtype,
the LayerNorm ``scale`` and ``bias`` f32; ``seed`` a host int (the Philox
key) and ``rate`` the dropout rate. Each is a ``torch.autograd.Function``.

Each kernel computes at the TPU kernel's rounding points: products summed in
f32 and rounded to the compute dtype before the bias, GELU in f32 on the
rounded pre-activation, the dropout scale in f32, the LayerNorm statistics
in f32. The backward kernels give the activations' gradients (and h, dpre,
and the dropped gradients the weight gradients need); the weight and bias
gradients, and the sums of the kernels' per-block dscale/dbias partials, are
plain ``torch.matmul``/``sum`` outside them, as the TPU kernels leave them
to XLA (ffn.py:238-250, 486-498, 705-712), and come back in the compute
dtype.

On a CPU tensor each wrapper below computes its plain version; on a CUDA
tensor it launches its kernels in ``univl_tpu_torch/csrc/ffn.cu`` (built at
first use) or raises. The kernels take H = 768 and F a multiple of 256. In
bf16, #3 and #4 are two wgmma GEMMs fed by TMA with fused epilogues and row
kernels (``ffn_plan`` says how N rows are cut), #5 one such GEMM a
direction, after its LayerNorm head in the backward and before its row
kernel in the forward, over the whole depth H; in f32 all three run on CUDA
cores.
Each wrapper counts its calls by route:
``launches`` on the tensor cores (bf16), ``cuda_core_launches`` in f32. The
forward kernels read the weights as ``nn.Linear`` stores them (``w1.t()``,
free when ``w1`` is the transposed view of such a weight, as in
``nn/layers.py``), the backward kernels in the JAX layout: either way every
product reads its B operand along its depth.

Dropout (``kernels/philox.py``): element (row, col) of #4's or #5's output is
kept where word ``col % 4`` of Philox(counter = (col // 4, row, tag, 0), key
= seed) is at least ``rate * 2**32``, so the forward kernel, the backward
kernel and the plain version drop the same entries. The TPU kernels' bits
(its generator re-seeded with seed + row tile) cannot be reproduced.
"""

from __future__ import annotations

import math

import torch

from univl_tpu_torch.kernels import _build
from univl_tpu_torch.kernels.philox import (
    DENSE_BLOCK_TAG,
    FFN_BLOCK_TAG,
    keep_threshold,
    row_dropout_keep,
)

KERNEL_HIDDEN = 768  # the hidden width the CUDA kernels take
F_CHUNK = 256  # F must be a multiple of this on the card
# csrc/ffn.cu's bf16 GEMM tile (kBM, kBN, kBK), the least depth of an F
# split in stages (kMinSteps) and the rows of the backward's LayerNorm block
GEMM_ROWS, GEMM_COLS, GEMM_DEPTH, MIN_SPLIT_STEPS, LN_BLOCK_ROWS = 128, 256, 64, 4, 32
CARD_SMS = 132  # the H100 SXM's SMs: the GEMM tiles a plan aims to give at least
LN_EPS = 1e-12
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


# ------------------------------------------------------------ plain versions


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-GELU in f32 (univl_tpu/kernels/ffn.py:70-72)."""
    return x * 0.5 * (1.0 + torch.erf(x * _INV_SQRT2))


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    cdf = 0.5 * (1.0 + torch.erf(x * _INV_SQRT2))
    return cdf + x * (torch.exp(-0.5 * x * x) * _INV_SQRT_2PI)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in f32 (the compute-dtype operands are exact in f32)."""
    return torch.matmul(a.float(), b.float())


def _dropped(y: torch.Tensor, keep, rate: float) -> torch.Tensor:
    """keep ? y / (1 - rate) : 0, scaled in f32; returns f32."""
    return torch.where(keep, y.float() * (1.0 / (1.0 - rate)), 0.0)


def _layer_norm(s: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNormTF on the rounded sum: f32 statistics, eps inside the rsqrt."""
    sf = s.float()
    u = sf.mean(dim=-1, keepdim=True)
    var = (sf - u).square().mean(dim=-1, keepdim=True)
    return (((sf - u) * torch.rsqrt(var + eps)) * scale.float() + bias.float()).to(s.dtype)


def _layer_norm_backward(s, g, scale, eps: float):
    """(ds f32, dscale, dbias) of LayerNormTF at input s (ffn.py:335-354)."""
    sf, g = s.float(), g.to(s.dtype).float()
    u = sf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((sf - u).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (sf - u) * rstd
    gs = g * scale.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    return rstd * (gs - m1 - xhat * m2), (g * xhat).sum(dim=0), g.sum(dim=0)


def _keep(seed: int, shape, tag: int, rate: float, device):
    return row_dropout_keep(seed, shape[0], shape[1], tag, rate, device=device)


def ffn_reference_fwd(x, w1, b1, w2, b2):
    """#3 forward in torch ops: (y, pre)."""
    dt = x.dtype
    pre = _mm(x, w1).to(dt) + b1
    h = _gelu(pre.float()).to(dt)
    return _mm(h, w2).to(dt) + b2, pre


def _ffn_backward_core(pre, g, w1, w2):
    """(dx f32, dpre, h) of the FFN from the output gradient g (ffn.py:111-124)."""
    dt = g.dtype
    p = pre.float()
    h = _gelu(p).to(dt)
    dpre = (_mm(g, w2.t()) * _gelu_grad(p)).to(dt)
    return _mm(dpre, w1.t()), dpre, h


def ffn_reference_bwd(pre, g, w1, w2):
    """#3 backward in torch ops: (dx, dpre, h)."""
    dx, dpre, h = _ffn_backward_core(pre, g.to(pre.dtype), w1, w2)
    return dx.to(pre.dtype), dpre, h


def ffn_block_reference_fwd(x, w1, b1, w2, b2, scale, bias, seed: int, rate: float,
                            eps: float = LN_EPS):
    """#4 forward in torch ops: (out, pre, s)."""
    y, pre = ffn_reference_fwd(x, w1, b1, w2, b2)
    if rate > 0.0:
        y = _dropped(y, _keep(seed, y.shape, FFN_BLOCK_TAG, rate, y.device), rate).to(x.dtype)
    s = y + x
    return _layer_norm(s, scale, bias, eps), pre, s


def ffn_block_reference_bwd(s, g, pre, w1, w2, scale, seed: int, rate: float,
                            eps: float = LN_EPS):
    """#4 backward in torch ops: (dx, dpre, h, dffn, dscale, dbias)."""
    dt = s.dtype
    ds, dscale, dbias = _layer_norm_backward(s, g, scale, eps)
    dffn = ds
    if rate > 0.0:
        dffn = _dropped(ds, _keep(seed, ds.shape, FFN_BLOCK_TAG, rate, ds.device), rate)
    dffn = dffn.to(dt)
    dx_ffn, dpre, h = _ffn_backward_core(pre, dffn, w1, w2)
    return (ds + dx_ffn).to(dt), dpre, h, dffn, dscale, dbias


def dense_block_reference_fwd(x, r, w, b, scale, bias, seed: int, rate: float,
                              eps: float = LN_EPS):
    """#5 forward in torch ops: (out, s)."""
    y = _mm(x, w).to(x.dtype) + b
    if rate > 0.0:
        y = _dropped(y, _keep(seed, y.shape, DENSE_BLOCK_TAG, rate, y.device), rate).to(x.dtype)
    s = y + r
    return _layer_norm(s, scale, bias, eps), s


def dense_block_reference_bwd(s, g, w, scale, seed: int, rate: float, eps: float = LN_EPS):
    """#5 backward in torch ops: (dx, dy, dr, dscale, dbias)."""
    dt = s.dtype
    ds, dscale, dbias = _layer_norm_backward(s, g, scale, eps)
    dy = ds
    if rate > 0.0:
        dy = _dropped(ds, _keep(seed, ds.shape, DENSE_BLOCK_TAG, rate, ds.device), rate)
    dy = dy.to(dt)
    return _mm(dy, w.t()).to(dt), dy, ds.to(dt), dscale, dbias


# ------------------------------------------------------------ the kernels


def _check(x, *weights, ln=()):
    if x.dim() != 2:
        raise ValueError(f"x must be [N, H], got {tuple(x.shape)}")
    if x.shape[0] < 1:
        raise ValueError("need at least one row")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for t in weights:
        if t.dtype != x.dtype:
            raise TypeError(f"weights and biases must be in x's dtype {x.dtype}, got {t.dtype}")
    for t in ln:
        if t.dtype != torch.float32 or t.shape != (x.shape[1],):
            raise TypeError(f"LayerNorm scale and bias must be f32 [{x.shape[1]}], got "
                            f"{t.dtype} {tuple(t.shape)}")
    if len({t.device for t in (x, *weights, *ln)}) != 1:
        raise ValueError("all inputs must be on one device")


def _check_dropout(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")


def _cuda(x: torch.Tensor, F: int = F_CHUNK):
    """The library, for a CUDA tensor whose shapes the kernels take."""
    if x.shape[1] != KERNEL_HIDDEN or F < F_CHUNK or F % F_CHUNK:
        raise ValueError(f"the kernels take H = {KERNEL_HIDDEN} and F a multiple of {F_CHUNK}; "
                         f"got H = {x.shape[1]}, F = {F}")
    if x.device.type != "cuda":
        raise ValueError(f"no fused-FFN kernel for device {x.device}")
    return _build.load_library()


def _ptrs(*ts):
    """Data pointers, None for an absent tensor; the kernels read 16-byte words."""
    out = []
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the kernels' tensors must start on 16-byte boundaries")
        out.append(None if t is None else t.data_ptr())
    return out


def _dropout_args(seed: int, rate: float):
    return (keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0), seed & 0xFFFFFFFFFFFFFFFF)


def _launch(x: torch.Tensor, fn, what: str, *args) -> None:
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, what)


def ln_block_rows(N: int) -> int:
    """Rows a block of the bf16 backwards' LayerNorm head (#4, #5) takes:
    LN_BLOCK_ROWS (4 a warp) where that gives every SM two blocks, else 8
    (one a warp), so a tower's 1,536 rows make 192 blocks, not 48. The
    dscale/dbias partials are [ceil(N / rows), H]."""
    return LN_BLOCK_ROWS if -(-N // LN_BLOCK_ROWS) >= 2 * CARD_SMS else LN_BLOCK_ROWS // 4


def ffn_plan(N: int, F: int, H: int = KERNEL_HIDDEN, block: bool = True) -> dict:
    """How the bf16 kernels of #3 (``block=False``) and #4 cut N rows.

    x W1 and (dffn or g) W2^T run one GEMM tile of GEMM_ROWS x GEMM_COLS
    for each of ``wide_tiles``; h W2 and dpre W1^T have H / GEMM_COLS
    column tiles, so their depth F is split ``splits`` ways, the fewest that
    give CARD_SMS tiles, each split at least MIN_SPLIT_STEPS stages of
    GEMM_DEPTH deep. A split writes its f32 sums to scratch, and a row
    kernel adds them in split order, so every output is the same from call
    to call. Scratch bytes: the forward's h ([N, F] bf16) and partials
    (where split), the backward's partials (where split) and #4's row
    statistics; #4's LayerNorm head takes ``ln_block_rows`` rows a block."""
    row_tiles = -(-N // GEMM_ROWS)
    steps = F // GEMM_DEPTH
    options = [s for s in (1, 2, 4, 8) if steps % s == 0 and steps // s >= MIN_SPLIT_STEPS]
    narrow = row_tiles * (H // GEMM_COLS)
    splits = next((s for s in options if narrow * s >= CARD_SMS), options[-1])
    part = splits * N * H * 4
    stats = -(-N // LN_BLOCK_ROWS) * LN_BLOCK_ROWS * 4 * 4 if block else 0
    return {"row_tile": GEMM_ROWS, "col_tile": GEMM_COLS, "splits": splits,
            "wide_tiles": row_tiles * (F // GEMM_COLS), "narrow_tiles": narrow * splits,
            "ln_block_rows": ln_block_rows(N),
            "scratch_bytes": {"fwd": N * F * 2 + (part if splits > 1 else 0),
                              "bwd": (part if splits > 1 else 0) + stats}}


def _partials(x: torch.Tensor, lib) -> torch.Tensor:
    """The backwards' dscale/dbias partials, [2, blocks, H] f32: a block of
    the LayerNorm head takes ln_block_rows(N) rows in bf16, and the CUDA-core
    kernels' univl_ffn_block_rows() in f32."""
    rows = lib.univl_ffn_block_rows() if x.dtype == torch.float32 else ln_block_rows(x.shape[0])
    return torch.empty(2, -(-x.shape[0] // rows), x.shape[1], dtype=torch.float32,
                       device=x.device)


def _forward(lib, x, w1t, b1, w2t, b2, scale, bias, out, pre, s, block: bool, eps: float,
             seed: int, rate: float, what: str, wrapper) -> None:
    """Launch #3's or #4's forward on its dtype's route and count the call."""
    N, H = x.shape
    F = w1t.shape[0]
    if x.dtype == torch.float32:
        _launch(x, lib.univl_ffn_fwd, what, *_ptrs(x, w1t, b1, w2t, b2, scale, bias, out, pre, s),
                int(block), N, H, F, eps, *_dropout_args(seed, rate))
        wrapper.cuda_core_launches += 1
        return
    plan = ffn_plan(N, F, H, block)
    h = torch.empty(N, F, dtype=x.dtype, device=x.device)
    part = (torch.empty(plan["splits"], N, H, dtype=torch.float32, device=x.device)
            if plan["splits"] > 1 else None)
    _launch(x, lib.univl_ffn_fwd_tc, what,
            *_ptrs(x, w1t, b1, w2t, b2, scale, bias, out, pre, s, h, part), int(block), N, H, F,
            plan["splits"], eps, *_dropout_args(seed, rate))
    wrapper.launches += 1


def _backward(lib, pre, g, w1, w2, s, scale, dx, dpre, h, dffn, part, block: bool, eps: float,
              seed: int, rate: float, what: str, wrapper) -> None:
    """Launch #3's or #4's backward on its dtype's route and count the call;
    ``part``: #4's dscale/dbias partials [2, blocks, H]."""
    N, H = g.shape
    F = w1.shape[1]
    parts = (None, None) if part is None else (part[0], part[1])
    if g.dtype == torch.float32:
        _launch(g, lib.univl_ffn_bwd, what,
                *_ptrs(pre, g, w1, w2, s, scale, dx, dpre, h, dffn, *parts), int(block), N, H, F,
                eps, *_dropout_args(seed, rate))
        wrapper.cuda_core_launches += 1
        return
    plan = ffn_plan(N, F, H, block)
    split = (torch.empty(plan["splits"], N, H, dtype=torch.float32, device=g.device)
             if plan["splits"] > 1 else None)
    stats = (torch.empty(-(-N // lib.univl_ffn_block_rows()) * lib.univl_ffn_block_rows(), 4,
                         dtype=torch.float32, device=g.device) if block else None)
    _launch(g, lib.univl_ffn_bwd_tc, what,
            *_ptrs(pre, g, w1, w2, s, scale, dx, dpre, h, dffn, *parts, stats, split), int(block),
            N, H, F, plan["splits"], plan["ln_block_rows"], eps, *_dropout_args(seed, rate))
    wrapper.launches += 1


def ffn_fwd(x, w1, b1, w2, b2, save: bool = False):
    """#3 forward: (y, pre or None): the kernel on a CUDA tensor, its plain
    version on a CPU one. ``save`` also returns the pre-activation."""
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        y, pre = ffn_reference_fwd(x, w1, b1, w2, b2)
        return y, (pre if save else None)
    lib = _cuda(x, w1.shape[1])
    N, H = x.shape
    F = w1.shape[1]
    # the forward reads its weights as nn.Linear stores them: [F, H] and [H, F]
    x, w1t, b1, w2t, b2 = (t.contiguous() for t in (x, w1.t(), b1, w2.t(), b2))
    y = torch.empty_like(x)
    pre = torch.empty(N, F, dtype=x.dtype, device=x.device) if save else None
    _forward(lib, x, w1t, b1, w2t, b2, None, None, y, pre, None, False, LN_EPS, 0, 0.0,
             "FFN forward kernel launch", ffn_fwd)
    return y, pre


def ffn_bwd(pre, g, w1, w2):
    """#3 backward: (dx, dpre, h)."""
    g = g.to(pre.dtype)
    _check(g, w1, w2)
    if g.device.type == "cpu":
        return ffn_reference_bwd(pre, g, w1, w2)
    lib = _cuda(g, w1.shape[1])
    pre, g, w1, w2 = (t.contiguous() for t in (pre, g, w1, w2))
    dx, dpre, h = torch.empty_like(g), torch.empty_like(pre), torch.empty_like(pre)
    _backward(lib, pre, g, w1, w2, None, None, dx, dpre, h, None, None, False, LN_EPS, 0, 0.0,
              "FFN backward kernel launch", ffn_bwd)
    return dx, dpre, h


def ffn_block_fwd(x, w1, b1, w2, b2, scale, bias, seed: int, rate: float,
                  eps: float = LN_EPS, save: bool = False):
    """#4 forward: (out, pre, s); pre and s are None unless ``save``."""
    _check(x, w1, b1, w2, b2, ln=(scale, bias))
    _check_dropout(rate)
    if x.device.type == "cpu":
        out, pre, s = ffn_block_reference_fwd(x, w1, b1, w2, b2, scale, bias, seed, rate, eps)
        return (out, pre, s) if save else (out, None, None)
    lib = _cuda(x, w1.shape[1])
    N, H = x.shape
    F = w1.shape[1]
    x, w1t, b1, w2t, b2, scale, bias = (t.contiguous() for t in (x, w1.t(), b1, w2.t(), b2,
                                                                  scale, bias))
    out = torch.empty_like(x)
    pre = torch.empty(N, F, dtype=x.dtype, device=x.device) if save else None
    s = torch.empty_like(x) if save else None
    _forward(lib, x, w1t, b1, w2t, b2, scale, bias, out, pre, s, True, eps, seed, rate,
             "FFN block forward kernel launch", ffn_block_fwd)
    return out, pre, s


def ffn_block_bwd(s, g, pre, w1, w2, scale, seed: int, rate: float, eps: float = LN_EPS):
    """#4 backward: (dx, dpre, h, dffn, dscale, dbias)."""
    g = g.to(s.dtype)
    _check(s, g, pre, w1, w2, ln=(scale,))
    _check_dropout(rate)
    if s.device.type == "cpu":
        return ffn_block_reference_bwd(s, g, pre, w1, w2, scale, seed, rate, eps)
    lib = _cuda(s, w1.shape[1])
    s, g, pre, w1, w2, scale = (t.contiguous() for t in (s, g, pre, w1, w2, scale))
    dx, dffn = torch.empty_like(s), torch.empty_like(s)
    dpre, h = torch.empty_like(pre), torch.empty_like(pre)
    part = _partials(s, lib)
    _backward(lib, pre, g, w1, w2, s, scale, dx, dpre, h, dffn, part, True, eps, seed, rate,
              "FFN block backward kernel launch", ffn_block_bwd)
    dscale, dbias = part.sum(dim=1)
    return dx, dpre, h, dffn, dscale, dbias


def dense_block_fwd(x, r, w, b, scale, bias, seed: int, rate: float, eps: float = LN_EPS,
                    save: bool = False):
    """#5 forward: (out, s); s is None unless ``save``."""
    _check(x, r, w, b, ln=(scale, bias))
    _check_dropout(rate)
    if r.shape != x.shape or w.shape != (x.shape[1], x.shape[1]):
        raise ValueError(f"r must be like x and w [H, H]: x {tuple(x.shape)}, r "
                         f"{tuple(r.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        out, s = dense_block_reference_fwd(x, r, w, b, scale, bias, seed, rate, eps)
        return out, (s if save else None)
    lib = _cuda(x)
    N, H = x.shape
    # the forward reads W as nn.Linear stores it: [H_out, H_in]
    x, r, wt, b, scale, bias = (t.contiguous() for t in (x, r, w.t(), b, scale, bias))
    out = torch.empty_like(x)
    s = torch.empty_like(x) if save else None
    what = "dense block forward kernel launch"
    if x.dtype == torch.float32:
        _launch(x, lib.univl_dense_block_fwd, what, *_ptrs(x, r, wt, b, scale, bias, out, s), N,
                H, eps, *_dropout_args(seed, rate))
        dense_block_fwd.cuda_core_launches += 1
        return out, s
    _launch(x, lib.univl_dense_block_fwd_tc, what, *_ptrs(x, r, wt, b, scale, bias, out, s), N,
            H, eps, *_dropout_args(seed, rate))
    dense_block_fwd.launches += 1
    return out, s


def dense_block_bwd(s, g, w, scale, seed: int, rate: float, eps: float = LN_EPS):
    """#5 backward: (dx, dy, dr, dscale, dbias)."""
    g = g.to(s.dtype)
    _check(s, g, w, ln=(scale,))
    _check_dropout(rate)
    if s.device.type == "cpu":
        return dense_block_reference_bwd(s, g, w, scale, seed, rate, eps)
    lib = _cuda(s)
    N, H = s.shape
    s, g, w, scale = (t.contiguous() for t in (s, g, w, scale))
    dx, dy, dr = torch.empty_like(s), torch.empty_like(s), torch.empty_like(s)
    part = _partials(s, lib)
    what = "dense block backward kernel launch"
    if s.dtype == torch.float32:
        _launch(s, lib.univl_dense_block_bwd, what,
                *_ptrs(s, g, w, scale, dx, dy, dr, part[0], part[1]), N, H, eps,
                *_dropout_args(seed, rate))
        dense_block_bwd.cuda_core_launches += 1
    else:
        # dy W^T over the whole depth: a 3-way split at a tower's 1,536 rows
        # (108 tiles, not 36) measured 0.0470 ms a call against 0.0415 (PERF.md)
        _launch(s, lib.univl_dense_block_bwd_tc, what,
                *_ptrs(s, g, w, scale, dx, dy, dr, part[0], part[1]), N, H,
                ln_block_rows(N), eps, *_dropout_args(seed, rate))
        dense_block_bwd.launches += 1
    dscale, dbias = part.sum(dim=1)
    return dx, dy, dr, dscale, dbias


for _wrapper in (ffn_fwd, ffn_bwd, ffn_block_fwd, ffn_block_bwd, dense_block_fwd,
                 dense_block_bwd):
    _wrapper.launches = 0  # calls in bf16, on the wgmma kernels; the CPU path adds nothing
    _wrapper.cuda_core_launches = 0  # calls in f32, on the CUDA-core kernels


# ------------------------------------------------------------ differentiable


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _weight_grads(a, d, dt):
    """(a^T @ d, column sums of d), summed in f32 and returned in dt (ffn.py:242-249)."""
    return torch.matmul(a.t(), d).to(dt), d.sum(dim=0, dtype=torch.float32).to(dt)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y, pre = ffn_fwd(x, w1, b1, w2, b2, save=True)
        ctx.save_for_backward(x, w1, w2, pre)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, pre = ctx.saved_tensors
        g = g.to(x.dtype)
        dx, dpre, h = ffn_bwd(pre, g, w1, w2)
        dw1, db1 = _weight_grads(x, dpre, w1.dtype)
        dw2, db2 = _weight_grads(h, g, w2.dtype)
        return dx, dw1, db1, dw2, db2


class _FusedFFNBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, scale, bias, seed, rate, eps):
        out, pre, s = ffn_block_fwd(x, w1, b1, w2, b2, scale, bias, seed, rate, eps, save=True)
        ctx.save_for_backward(x, w1, w2, scale, pre, s)
        ctx.seed, ctx.rate, ctx.eps = seed, rate, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, scale, pre, s = ctx.saved_tensors
        dx, dpre, h, dffn, dscale, dbias = ffn_block_bwd(s, g, pre, w1, w2, scale, ctx.seed,
                                                         ctx.rate, ctx.eps)
        dw1, db1 = _weight_grads(x, dpre, w1.dtype)
        dw2, db2 = _weight_grads(h, dffn, w2.dtype)
        return dx, dw1, db1, dw2, db2, dscale, dbias, None, None, None


class _FusedDenseBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, w, b, scale, bias, seed, rate, eps):
        out, s = dense_block_fwd(x, r, w, b, scale, bias, seed, rate, eps, save=True)
        ctx.save_for_backward(x, w, scale, s)
        ctx.seed, ctx.rate, ctx.eps = seed, rate, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, scale, s = ctx.saved_tensors
        dx, dy, dr, dscale, dbias = dense_block_bwd(s, g, w, scale, ctx.seed, ctx.rate, ctx.eps)
        dw, db = _weight_grads(x, dy, w.dtype)
        return dx, dr, dw, db, dscale, dbias, None, None, None


def fused_ffn(x, w1, b1, w2, b2) -> torch.Tensor:
    """y = gelu(x @ w1 + b1) @ w2 + b2, differentiable (#3). Outside autograd
    the forward does not save the pre-activation."""
    if _needs_grad(x, w1, b1, w2, b2):
        return _FusedFFN.apply(x, w1, b1, w2, b2)
    return ffn_fwd(x, w1, b1, w2, b2)[0]


def fused_ffn_block(x, w1, b1, w2, b2, scale, bias, seed: int, rate: float,
                    eps: float = LN_EPS) -> torch.Tensor:
    """LayerNormTF(dropout(FFN(x)) + x), differentiable (#4)."""
    if _needs_grad(x, w1, b1, w2, b2, scale, bias):
        return _FusedFFNBlock.apply(x, w1, b1, w2, b2, scale, bias, seed, rate, eps)
    return ffn_block_fwd(x, w1, b1, w2, b2, scale, bias, seed, rate, eps)[0]


def fused_dense_block(x, r, w, b, scale, bias, seed: int, rate: float,
                      eps: float = LN_EPS) -> torch.Tensor:
    """LayerNormTF(dropout(x @ w + b) + r), differentiable (#5)."""
    if _needs_grad(x, r, w, b, scale, bias):
        return _FusedDenseBlock.apply(x, r, w, b, scale, bias, seed, rate, eps)
    return dense_block_fwd(x, r, w, b, scale, bias, seed, rate, eps)[0]
