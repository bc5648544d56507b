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
the LayerNorm ``scale`` and ``bias`` f32; ``seed`` the Philox key (a host
int, or a ``DeviceKey``: a slot of a captured step's key table, which the
kernels read it from) and ``rate`` the dropout rate. Each is a
``torch.autograd.Function``.

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
    Key,
    keep_threshold,
    key_pointer,
    key_value,
    row_dropout_keep,
)
from univl_tpu_torch.parallel import comm

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


def _dropout_args(seed: Key, rate: float, device):
    """((threshold, 1/(1-rate), on, the key's address) of a launch, the
    key's tensor, to hold through the launch)."""
    key, held = key_pointer(seed, rate, device)
    return (keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0), key), held


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
             seed: Key, rate: float, what: str, wrapper) -> None:
    """Launch #3's or #4's forward on its dtype's route and count the call."""
    drop, _key = _dropout_args(seed, rate, x.device)
    N, H = x.shape
    F = w1t.shape[0]
    if x.dtype == torch.float32:
        _launch(x, lib.univl_ffn_fwd, what, *_ptrs(x, w1t, b1, w2t, b2, scale, bias, out, pre, s),
                int(block), N, H, F, eps, *drop)
        wrapper.cuda_core_launches += 1
        return
    plan = ffn_plan(N, F, H, block)
    h = torch.empty(N, F, dtype=x.dtype, device=x.device)
    part = (torch.empty(plan["splits"], N, H, dtype=torch.float32, device=x.device)
            if plan["splits"] > 1 else None)
    _launch(x, lib.univl_ffn_fwd_tc, what,
            *_ptrs(x, w1t, b1, w2t, b2, scale, bias, out, pre, s, h, part), int(block), N, H, F,
            plan["splits"], eps, *drop)
    wrapper.launches += 1


def _backward(lib, pre, g, w1, w2, s, scale, dx, dpre, h, dffn, part, block: bool, eps: float,
              seed: Key, rate: float, what: str, wrapper) -> None:
    """Launch #3's or #4's backward on its dtype's route and count the call;
    ``part``: #4's dscale/dbias partials [2, blocks, H]."""
    drop, _key = _dropout_args(seed, rate, g.device)
    N, H = g.shape
    F = w1.shape[1]
    parts = (None, None) if part is None else (part[0], part[1])
    if g.dtype == torch.float32:
        _launch(g, lib.univl_ffn_bwd, what,
                *_ptrs(pre, g, w1, w2, s, scale, dx, dpre, h, dffn, *parts), int(block), N, H, F,
                eps, *drop)
        wrapper.cuda_core_launches += 1
        return
    plan = ffn_plan(N, F, H, block)
    split = (torch.empty(plan["splits"], N, H, dtype=torch.float32, device=g.device)
             if plan["splits"] > 1 else None)
    stats = (torch.empty(-(-N // lib.univl_ffn_block_rows()) * lib.univl_ffn_block_rows(), 4,
                         dtype=torch.float32, device=g.device) if block else None)
    _launch(g, lib.univl_ffn_bwd_tc, what,
            *_ptrs(pre, g, w1, w2, s, scale, dx, dpre, h, dffn, *parts, stats, split), int(block),
            N, H, F, plan["splits"], plan["ln_block_rows"], eps, *drop)
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


def ffn_block_fwd(x, w1, b1, w2, b2, scale, bias, seed: Key, rate: float,
                  eps: float = LN_EPS, save: bool = False):
    """#4 forward: (out, pre, s); pre and s are None unless ``save``."""
    _check(x, w1, b1, w2, b2, ln=(scale, bias))
    _check_dropout(rate)
    if x.device.type == "cpu":
        out, pre, s = ffn_block_reference_fwd(x, w1, b1, w2, b2, scale, bias,
                                              key_value(seed), rate, eps)
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


def ffn_block_bwd(s, g, pre, w1, w2, scale, seed: Key, rate: float, eps: float = LN_EPS):
    """#4 backward: (dx, dpre, h, dffn, dscale, dbias)."""
    g = g.to(s.dtype)
    _check(s, g, pre, w1, w2, ln=(scale,))
    _check_dropout(rate)
    if s.device.type == "cpu":
        return ffn_block_reference_bwd(s, g, pre, w1, w2, scale, key_value(seed), rate, eps)
    lib = _cuda(s, w1.shape[1])
    s, g, pre, w1, w2, scale = (t.contiguous() for t in (s, g, pre, w1, w2, scale))
    dx, dffn = torch.empty_like(s), torch.empty_like(s)
    dpre, h = torch.empty_like(pre), torch.empty_like(pre)
    part = _partials(s, lib)
    _backward(lib, pre, g, w1, w2, s, scale, dx, dpre, h, dffn, part, True, eps, seed, rate,
              "FFN block backward kernel launch", ffn_block_bwd)
    dscale, dbias = part.sum(dim=1)
    return dx, dpre, h, dffn, dscale, dbias


def dense_block_fwd(x, r, w, b, scale, bias, seed: Key, rate: float, eps: float = LN_EPS,
                    save: bool = False):
    """#5 forward: (out, s); s is None unless ``save``."""
    _check(x, r, w, b, ln=(scale, bias))
    _check_dropout(rate)
    if r.shape != x.shape or w.shape != (x.shape[1], x.shape[1]):
        raise ValueError(f"r must be like x and w [H, H]: x {tuple(x.shape)}, r "
                         f"{tuple(r.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        out, s = dense_block_reference_fwd(x, r, w, b, scale, bias, key_value(seed), rate, eps)
        return out, (s if save else None)
    lib = _cuda(x)
    N, H = x.shape
    # the forward reads W as nn.Linear stores it: [H_out, H_in]
    x, r, wt, b, scale, bias = (t.contiguous() for t in (x, r, w.t(), b, scale, bias))
    out = torch.empty_like(x)
    s = torch.empty_like(x) if save else None
    what = "dense block forward kernel launch"
    drop, _key = _dropout_args(seed, rate, x.device)
    if x.dtype == torch.float32:
        _launch(x, lib.univl_dense_block_fwd, what, *_ptrs(x, r, wt, b, scale, bias, out, s), N,
                H, eps, *drop)
        dense_block_fwd.cuda_core_launches += 1
        return out, s
    _launch(x, lib.univl_dense_block_fwd_tc, what, *_ptrs(x, r, wt, b, scale, bias, out, s), N,
            H, eps, *drop)
    dense_block_fwd.launches += 1
    return out, s


def dense_block_bwd(s, g, w, scale, seed: Key, rate: float, eps: float = LN_EPS):
    """#5 backward: (dx, dy, dr, dscale, dbias)."""
    g = g.to(s.dtype)
    _check(s, g, w, ln=(scale,))
    _check_dropout(rate)
    if s.device.type == "cpu":
        return dense_block_reference_bwd(s, g, w, scale, key_value(seed), rate, eps)
    lib = _cuda(s)
    N, H = s.shape
    s, g, w, scale = (t.contiguous() for t in (s, g, w, scale))
    dx, dy, dr = torch.empty_like(s), torch.empty_like(s), torch.empty_like(s)
    part = _partials(s, lib)
    what = "dense block backward kernel launch"
    drop, _key = _dropout_args(seed, rate, s.device)
    if s.dtype == torch.float32:
        _launch(s, lib.univl_dense_block_bwd, what,
                *_ptrs(s, g, w, scale, dx, dy, dr, part[0], part[1]), N, H, eps,
                *drop)
        dense_block_bwd.cuda_core_launches += 1
    else:
        # dy W^T over the whole depth: a 3-way split at a tower's 1,536 rows
        # (108 tiles, not 36) measured 0.0470 ms a call against 0.0415 (PERF.md)
        _launch(s, lib.univl_dense_block_bwd_tc, what,
                *_ptrs(s, g, w, scale, dx, dy, dr, part[0], part[1]), N, H,
                ln_block_rows(N), eps, *drop)
        dense_block_bwd.launches += 1
    dscale, dbias = part.sum(dim=1)
    return dx, dy, dr, dscale, dbias


for _wrapper in (ffn_fwd, ffn_bwd, ffn_block_fwd, ffn_block_bwd, dense_block_fwd,
                 dense_block_bwd):
    _wrapper.launches = 0  # calls in bf16, on the wgmma kernels; the CPU path adds nothing
    _wrapper.cuda_core_launches = 0  # calls in f32, on the CUDA-core kernels


# ------------------------------------------------------------ the split halves
#
# Under tensor parallelism (parallel/tp.py) a rank holds F / tp columns of
# W1 and rows of W2 (#3, #4), or K / tp rows of W (#5: its input is the
# rank's heads). Each function is cut at the row-parallel product: the
# rank's GEMMs leave an f32 partial [N, H] of the product (``ffn_plan``'s
# split scratch, its F splits summed in split order), the ranks' partials are
# all-reduced, or reduce-scattered into the rank's rows under sequence
# parallelism, and a row kernel adds the bias once, drops at the rows' offset
# in the call (row0), adds the residual and normalizes. The backwards mirror
# it: the LayerNorm head on the rank's rows, the GEMMs over its depth, the
# reduce of dx's partial, then dx's rows. The pieces below are the kernels
# (CUDA tensors, bf16: the wgmma GEMMs and row kernels of csrc/ffn.cu) and
# their plain versions (CPU tensors), each counted in ``launches``; the
# ``*_tp`` autograd functions compose them with parallel/comm.py.

def _split_cuda(dtype, device, H: int, depth: int = F_CHUNK, granule: int = F_CHUNK):
    """The library, for a CUDA call of the split pieces: bf16, width H, a
    depth (#3's and #4's F / tp, #5's K / tp) that is a multiple of
    ``granule``."""
    if dtype != torch.bfloat16:
        raise NotImplementedError(
            "the split #3-#5 kernels are bf16 (the tensor-core route); f32 under tensor "
            "parallelism takes the unfused FFN (--fused_ffn xla) on the card")
    if H != KERNEL_HIDDEN or depth < granule or depth % granule:
        raise ValueError(f"the split kernels take H = {KERNEL_HIDDEN} and a rank's depth a "
                         f"multiple of {granule}; got H = {H}, depth {depth}")
    if device.type != "cuda":
        raise ValueError(f"no fused-FFN kernel for device {device}")
    return _build.load_library()


def ffn_part_reference(x, w1, b1, w2):
    """(part, pre): ``gelu(x @ w1 + b1) @ w2`` summed in f32, before b2."""
    pre = _mm(x, w1).to(x.dtype) + b1
    return _mm(_gelu(pre.float()).to(x.dtype), w2), pre


def split_rows_reference(part, b, res, scale, bias, seed: int, rate: float, eps: float,
                         kind: int, row0: int = 0):
    """(out, s) of the rows after the reduce: y = round(round(part) + b);
    #3 (kind 3) returns (y, None); #4 and #5 drop y at rows row0 + [0, N)
    with their tag, add res and normalize."""
    y = part.to(b.dtype) + b
    if kind == 3:
        return y, None
    if rate > 0.0:
        tag = FFN_BLOCK_TAG if kind == 4 else DENSE_BLOCK_TAG
        keep = row_dropout_keep(seed, y.shape[0], y.shape[1], tag, rate, y.device, row0)
        y = _dropped(y, keep, rate).to(b.dtype)
    s = y + res
    return _layer_norm(s, scale, bias, eps), s


def block_bwd_ln_reference(kind: int, s, g, scale, seed: int, rate: float, eps: float,
                           row0: int = 0):
    """(dropped, dr, ds, dscale, dbias) of the LayerNorm head over a rank's
    rows: #4's dffn or #5's dy, #5's dr (None for #4), and ds in f32 (what
    the kernels keep as row statistics)."""
    dt = s.dtype
    ds, dscale, dbias = _layer_norm_backward(s, g, scale, eps)
    dropped = ds
    if rate > 0.0:
        tag = FFN_BLOCK_TAG if kind == 4 else DENSE_BLOCK_TAG
        keep = row_dropout_keep(seed, ds.shape[0], ds.shape[1], tag, rate, ds.device, row0)
        dropped = _dropped(ds, keep, rate)
    return dropped.to(dt), (ds.to(dt) if kind == 5 else None), ds, dscale, dbias


def ffn_part(x, w1, b1, w2):
    """#3's and #4's forward GEMMs over a rank's depth: (part f32 [N, H], pre)."""
    _check(x, w1, b1, w2)
    if x.device.type == "cpu":
        return ffn_part_reference(x, w1, b1, w2)
    N, H = x.shape
    F = w1.shape[1]
    lib = _split_cuda(x.dtype, x.device, H, F)
    splits = ffn_plan(N, F, H, block=False)["splits"]
    x, w1t, b1, w2t = (t.contiguous() for t in (x, w1.t(), b1, w2.t()))
    pre, h = (torch.empty(N, F, dtype=x.dtype, device=x.device) for _ in range(2))
    part = torch.empty(splits, N, H, dtype=torch.float32, device=x.device)
    _launch(x, lib.univl_ffn_fwd_part_tc, "FFN split forward kernel launch",
            *_ptrs(x, w1t, b1, w2t, pre, h, part), N, H, F, splits)
    ffn_part.launches += 1
    return part[0], pre


def dense_part(x, w):
    """#5's forward GEMM over a rank's depth K: part = x @ w, f32 [N, H]
    (x [N, K], w [K, H])."""
    _check(x, w)
    if x.device.type == "cpu":
        return _mm(x, w)
    N, K = x.shape
    lib = _split_cuda(x.dtype, x.device, w.shape[1], K, GEMM_DEPTH)
    x, wt = x.contiguous(), w.t().contiguous()
    part = torch.empty(N, wt.shape[0], dtype=torch.float32, device=x.device)
    _launch(x, lib.univl_dense_fwd_part_tc, "dense split forward kernel launch",
            *_ptrs(x, wt, part), N, wt.shape[0], K)
    dense_part.launches += 1
    return part


def split_rows(part, b, res, scale, bias, seed: Key, rate: float, eps: float, kind: int,
               row0: int = 0):
    """The forward rows after the reduce (``split_rows_reference``) over a
    rank's rows: the row kernel on a CUDA tensor."""
    _check_dropout(rate)
    if part.device.type == "cpu":
        return split_rows_reference(part, b, res, scale, bias, key_value(seed), rate, eps, kind,
                                    row0)
    N, H = part.shape
    lib = _split_cuda(b.dtype, part.device, H)
    block = kind != 3
    part, b = part.contiguous(), b.contiguous()
    res = res.contiguous() if block else None
    out = torch.empty(N, H, dtype=b.dtype, device=b.device)
    s = torch.empty_like(out) if block else None
    drop, _key = _dropout_args(seed, rate, part.device)
    _launch(part, lib.univl_split_rows_tc, "split rows kernel launch",
            *_ptrs(part, b, res, scale if block else None, bias if block else None, out, s), N, H,
            kind, eps, *drop, row0)
    split_rows.launches += 1
    return out, s


def block_bwd_ln(kind: int, s, g, scale, seed: Key, rate: float, eps: float, row0: int = 0):
    """The LayerNorm head of #4's or #5's backward over a rank's rows
    (``block_bwd_ln_reference``; on a CUDA tensor the row statistics in
    place of ds)."""
    g = g.to(s.dtype)
    _check(s, g, ln=(scale,))
    _check_dropout(rate)
    if s.device.type == "cpu":
        return block_bwd_ln_reference(kind, s, g, scale, key_value(seed), rate, eps, row0)
    N, H = s.shape
    lib = _split_cuda(s.dtype, s.device, H)
    s, g = s.contiguous(), g.contiguous()
    dropped = torch.empty_like(s)
    dr = torch.empty_like(s) if kind == 5 else None
    rows = lib.univl_ffn_block_rows()
    stats = (torch.empty(-(-N // rows) * rows, 4, dtype=torch.float32, device=s.device)
             if kind == 4 else None)
    part = torch.empty(2, -(-N // ln_block_rows(N)), H, dtype=torch.float32, device=s.device)
    drop, _key = _dropout_args(seed, rate, s.device)
    _launch(s, lib.univl_block_bwd_ln_tc, "split LayerNorm head kernel launch", kind,
            *_ptrs(s, g, scale, dropped, dr, stats, part[0], part[1]), N, H, ln_block_rows(N),
            eps, *drop, row0)
    block_bwd_ln.launches += 1
    dscale, dbias = part.sum(dim=1)
    return dropped, dr, stats, dscale, dbias


def ffn_bwd_part(pre, g, w1, w2):
    """#3's and #4's backward GEMMs over a rank's depth: (part f32 [N, H] of
    dx, dpre, h); g is every row's (dffn for #4)."""
    g = g.to(pre.dtype)
    _check(g, w1, w2)
    if g.device.type == "cpu":
        return _ffn_backward_core(pre, g, w1, w2)
    N, H = g.shape
    F = w1.shape[1]
    lib = _split_cuda(g.dtype, g.device, H, F)
    splits = ffn_plan(N, F, H, block=False)["splits"]
    pre, g, w1, w2 = (t.contiguous() for t in (pre, g, w1, w2))
    dpre, h = torch.empty_like(pre), torch.empty_like(pre)
    part = torch.empty(splits, N, H, dtype=torch.float32, device=g.device)
    _launch(g, lib.univl_ffn_bwd_part_tc, "FFN split backward kernel launch",
            *_ptrs(pre, g, w1, w2, dpre, h, part), N, H, F, splits)
    ffn_bwd_part.launches += 1
    return part[0], dpre, h


def ffn_bwd_rows(part, s, g, scale, stats, dtype):
    """dx's rows after the reduce: round(part + ds) for #4 (``stats``: the
    head's row statistics, or ds on the CPU), round(part) for #3 (None)."""
    if part.device.type == "cpu":
        return (part if stats is None else part + stats).to(dtype)
    N, H = part.shape
    lib = _split_cuda(dtype, part.device, H)
    part = part.contiguous()
    dx = torch.empty(N, H, dtype=dtype, device=part.device)
    block = stats is not None
    _launch(part, lib.univl_ffn_bwd_rows_tc, "FFN split backward rows kernel launch",
            *_ptrs(part, s.contiguous() if block else None,
                   g.to(dtype).contiguous() if block else None, scale if block else None, stats,
                   dx), N, H)
    ffn_bwd_rows.launches += 1
    return dx


def dense_bwd_dx(dy, w):
    """#5's dx over a rank's depth K: round(dy @ w^T), [N, K] (w [K, H])."""
    _check(dy, w)
    if dy.device.type == "cpu":
        return _mm(dy, w.t()).to(dy.dtype)
    N, H = dy.shape
    K = w.shape[0]
    lib = _split_cuda(dy.dtype, dy.device, H, K, GEMM_DEPTH)
    dy, w = dy.contiguous(), w.contiguous()
    dx = torch.empty(N, K, dtype=dy.dtype, device=dy.device)
    _launch(dy, lib.univl_dense_bwd_dx_tc, "dense split dx kernel launch", *_ptrs(dy, w, dx), N,
            H, K)
    dense_bwd_dx.launches += 1
    return dx


for _wrapper in (ffn_part, dense_part, split_rows, block_bwd_ln, ffn_bwd_part, ffn_bwd_rows,
                 dense_bwd_dx):
    _wrapper.launches = 0  # calls on the card (bf16); the CPU path adds nothing


def _reduce(part: torch.Tensor, mesh, sp: bool) -> torch.Tensor:
    """The ranks' partials summed: the rank's rows of the sum under sequence
    parallelism, all of them otherwise."""
    return comm.scatter_rows(part, mesh) if sp else comm.all_reduce_sum(part, mesh)


def _gather(t: torch.Tensor, mesh, sp: bool) -> torch.Tensor:
    return comm.gather_rows(t, mesh) if sp else t


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


def fused_ffn_block(x, w1, b1, w2, b2, scale, bias, seed: Key, rate: float,
                    eps: float = LN_EPS) -> torch.Tensor:
    """LayerNormTF(dropout(FFN(x)) + x), differentiable (#4)."""
    if _needs_grad(x, w1, b1, w2, b2, scale, bias):
        return _FusedFFNBlock.apply(x, w1, b1, w2, b2, scale, bias, seed, rate, eps)
    return ffn_block_fwd(x, w1, b1, w2, b2, scale, bias, seed, rate, eps)[0]


def fused_dense_block(x, r, w, b, scale, bias, seed: Key, rate: float,
                      eps: float = LN_EPS) -> torch.Tensor:
    """LayerNormTF(dropout(x @ w + b) + r), differentiable (#5)."""
    if _needs_grad(x, r, w, b, scale, bias):
        return _FusedDenseBlock.apply(x, r, w, b, scale, bias, seed, rate, eps)
    return dense_block_fwd(x, r, w, b, scale, bias, seed, rate, eps)[0]


# ------------------------------------------------------------ differentiable, split


class _FusedFFNTp(torch.autograd.Function):
    """#3 over a rank's F: x and the result are the rank's rows under
    sequence parallelism, every row otherwise (then dx comes back whole)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mesh, sp):
        xf = _gather(x, mesh, sp)
        part, pre = ffn_part(xf, w1, b1, w2)
        y, _ = split_rows(_reduce(part, mesh, sp), b2, None, None, None, 0, 0.0, LN_EPS, 3)
        ctx.save_for_backward(xf, w1, w2, pre)
        ctx.mesh, ctx.sp = mesh, sp
        return y

    @staticmethod
    def backward(ctx, g):
        xf, w1, w2, pre = ctx.saved_tensors
        g = g.to(xf.dtype)
        gf = _gather(g, ctx.mesh, ctx.sp)
        part, dpre, h = ffn_bwd_part(pre, gf, w1, w2)
        dx = ffn_bwd_rows(_reduce(part, ctx.mesh, ctx.sp), None, None, None, None, xf.dtype)
        dw1, db1 = _weight_grads(xf, dpre, w1.dtype)
        dw2 = torch.matmul(h.t(), gf).to(w2.dtype)
        db2 = g.sum(dim=0, dtype=torch.float32).to(w2.dtype)  # the rank's rows under SP
        return dx, dw1, db1, dw2, db2, None, None


class _FusedFFNBlockTp(torch.autograd.Function):
    """#4 over a rank's F; x (the input and the residual) and the result
    are the rank's rows under sequence parallelism."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, scale, bias, seed, rate, eps, mesh, sp):
        xf = _gather(x, mesh, sp)
        part, pre = ffn_part(xf, w1, b1, w2)
        part = _reduce(part, mesh, sp)
        row0 = mesh.rank * part.shape[0] if sp else 0
        out, s = split_rows(part, b2, x, scale, bias, seed, rate, eps, 4, row0)
        ctx.save_for_backward(xf, w1, w2, scale, pre, s)
        ctx.seed, ctx.rate, ctx.eps, ctx.row0, ctx.mesh, ctx.sp = seed, rate, eps, row0, mesh, sp
        return out

    @staticmethod
    def backward(ctx, g):
        xf, w1, w2, scale, pre, s = ctx.saved_tensors
        g = g.to(s.dtype)
        dffn, _, stats, dscale, dbias = block_bwd_ln(4, s, g, scale, ctx.seed, ctx.rate,
                                                     ctx.eps, ctx.row0)
        dffn_all = _gather(dffn, ctx.mesh, ctx.sp)
        part, dpre, h = ffn_bwd_part(pre, dffn_all, w1, w2)
        dx = ffn_bwd_rows(_reduce(part, ctx.mesh, ctx.sp), s, g, scale, stats, s.dtype)
        dw1, db1 = _weight_grads(xf, dpre, w1.dtype)
        dw2 = torch.matmul(h.t(), dffn_all).to(w2.dtype)
        db2 = dffn.sum(dim=0, dtype=torch.float32).to(w2.dtype)
        return dx, dw1, db1, dw2, db2, dscale, dbias, None, None, None, None, None


class _FusedDenseBlockTp(torch.autograd.Function):
    """#5 over a rank's K (x: every row's context on the rank's heads); r and
    the result are the rank's rows under sequence parallelism."""

    @staticmethod
    def forward(ctx, x, r, w, b, scale, bias, seed, rate, eps, mesh, sp):
        part = _reduce(dense_part(x, w), mesh, sp)
        row0 = mesh.rank * part.shape[0] if sp else 0
        out, s = split_rows(part, b, r, scale, bias, seed, rate, eps, 5, row0)
        ctx.save_for_backward(x, w, scale, s)
        ctx.seed, ctx.rate, ctx.eps, ctx.row0, ctx.mesh, ctx.sp = seed, rate, eps, row0, mesh, sp
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, scale, s = ctx.saved_tensors
        dy, dr, _, dscale, dbias = block_bwd_ln(5, s, g, scale, ctx.seed, ctx.rate, ctx.eps,
                                                ctx.row0)
        dy_all = _gather(dy, ctx.mesh, ctx.sp)
        dx = dense_bwd_dx(dy_all, w)
        dw = torch.matmul(x.t(), dy_all).to(w.dtype)
        db = dy.sum(dim=0, dtype=torch.float32).to(w.dtype)
        return dx, dr, dw, db, dscale, dbias, None, None, None, None, None


def fused_ffn_tp(x, w1, b1, w2, b2, mesh, sp: bool = False) -> torch.Tensor:
    """#3 split over the tp ranks of ``mesh`` (its tp view): w1 [H, F/tp],
    b1 [F/tp], w2 [F/tp, H], b2 [H] whole; with ``sp`` x and the result are
    the rank's rows."""
    return _FusedFFNTp.apply(x, w1, b1, w2, b2, mesh, sp)


def fused_ffn_block_tp(x, w1, b1, w2, b2, scale, bias, seed: Key, rate: float, eps: float,
                       mesh, sp: bool = False) -> torch.Tensor:
    """#4 split over the tp ranks (``fused_ffn_tp``'s shares)."""
    return _FusedFFNBlockTp.apply(x, w1, b1, w2, b2, scale, bias, seed, rate, eps, mesh, sp)


def fused_dense_block_tp(x, r, w, b, scale, bias, seed: Key, rate: float, eps: float, mesh,
                         sp: bool = False) -> torch.Tensor:
    """#5 split over the tp ranks: x [N, K/tp] (the rank's heads), w [K/tp,
    H]; r and the result the rank's rows under ``sp``."""
    return _FusedDenseBlockTp.apply(x, r, w, b, scale, bias, seed, rate, eps, mesh, sp)
