"""TF-style LayerNorm (#6): the hand-written CUDA kernels (forward and
backward) and their plain PyTorch versions.

``fused_layer_norm(x, scale, bias, eps)`` replaces the Pallas TPU kernel
``univl_tpu/kernels/layernorm.py:fused_layer_norm`` (a custom VJP) and keeps
its semantics: statistics in f32, eps inside the sqrt, the output in x's
dtype (f32 or bf16), f32 ``scale`` and ``bias`` over the last dim. The
forward saves ``x`` and ``scale``, not the statistics; the backward
recomputes mu and rstd from ``x`` and gives ``dx`` in x's dtype and f32
``dscale``/``dbias``. It is a ``torch.autograd.Function``.

On a CPU tensor ``layer_norm_fwd`` and ``layer_norm_bwd`` compute the plain
versions below; on a CUDA tensor they launch the kernels in
``univl_tpu_torch/csrc/layernorm.cu`` (built at first use) or raise. The
kernels take every row count and widths that are multiples of 8 up to
4,096 (the JAX package's fallback to plain ``jnp`` for row counts its TPU
blocks do not tile has no counterpart here). The backward runs on one
block an SM (``bwd_blocks``); each block writes its dscale/dbias partials
and a second kernel sums them in block order, so two calls give bitwise
equal dscale and dbias.
"""

from __future__ import annotations

import torch

from univl_tpu_torch.kernels import _build

LN_EPS = 1e-12
BWD_WARPS = 8  # rows a backward block takes at once, one a warp (csrc/layernorm.cu)


def bwd_blocks(rows: int, sms: int) -> int:
    """The backward's grid on a card of ``sms`` SMs, and the count of partial
    rows its dscale/dbias sum adds: a block for every BWD_WARPS rows, at
    most one an SM (then each block takes a longer range)."""
    return max(1, min(-(-rows // BWD_WARPS), sms))


def _stats(xf: torch.Tensor, eps: float):
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def layer_norm_reference_fwd(x, scale, bias, eps: float = LN_EPS) -> torch.Tensor:
    """The forward kernel's math (``_fwd_kernel``): f32 statistics, the
    output rounded to x's dtype."""
    xf = x.float()
    mu, rstd = _stats(xf, eps)
    return ((xf - mu) * rstd * scale.float() + bias.float()).to(x.dtype)


def layer_norm_reference_bwd(x, scale, dy, eps: float = LN_EPS):
    """The backward's math (``_flf_bwd``): (dx in x's dtype, dscale, dbias in f32)."""
    d = x.shape[-1]
    xf, dyf = x.reshape(-1, d).float(), dy.reshape(-1, d).float()
    mu, rstd = _stats(xf, eps)
    xhat = (xf - mu) * rstd
    dyg = dyf * scale.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dyg - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    return dx, (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def _check(x, scale, *others) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be f32 [{d}], got {scale.dtype} {tuple(scale.shape)}")
    for t in others:
        if t.shape[-1] != d:
            raise ValueError(f"last dims differ: {tuple(x.shape)} and {tuple(t.shape)}")
    if len({t.device for t in (x, scale, *others)}) != 1:
        raise ValueError("all operands must be on one device")


def _cuda(x: torch.Tensor):
    """The library, after checking what the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"no LayerNorm kernel for device {x.device}")
    lib = _build.load_library()
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= lib.univl_layernorm_max_width():
        raise ValueError(f"the kernels read 16-byte row chunks: need a width that is a "
                         f"multiple of 8 up to {lib.univl_layernorm_max_width()}, got {d}")
    return lib


def _ptrs(*ts):
    """Data pointers of contiguous tensors the kernels read and write in 16-byte words."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the LayerNorm kernels need 16-byte aligned operands")
    return [t.data_ptr() for t in ts]


def _launch(x: torch.Tensor, fn, what: str, *args) -> None:
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, what)


def layer_norm_fwd(x, scale, bias, eps: float = LN_EPS) -> torch.Tensor:
    """y in x's dtype and shape: the forward kernel on a CUDA tensor, its
    plain version on a CPU one."""
    _check(x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_reference_fwd(x, scale, bias, eps)
    lib = _cuda(x)
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    scale, bias = scale.contiguous(), bias.float().contiguous()  # alive through the launch
    y = torch.empty_like(x2)
    if x2.shape[0]:
        _launch(x2, lib.univl_layernorm_fwd, "LayerNorm forward kernel launch",
                *_ptrs(x2, scale, bias, y),
                int(x.dtype == torch.bfloat16), x2.shape[0], d, eps)
        layer_norm_fwd.launches += 1
    return y.view(x.shape)


def layer_norm_bwd(x, scale, dy, eps: float = LN_EPS):
    """(dx in x's dtype, dscale, dbias in f32): the backward kernels on a
    CUDA tensor, the plain version on a CPU one."""
    dy = dy.to(x.dtype)
    _check(x, scale, dy)
    if x.device.type == "cpu":
        return layer_norm_reference_bwd(x, scale, dy, eps)
    lib = _cuda(x)
    d = x.shape[-1]
    x2, dy2 = x.reshape(-1, d).contiguous(), dy.reshape(-1, d).contiguous()
    scale = scale.contiguous()  # alive through the launch
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    dscale, dbias = torch.empty(2, d, dtype=torch.float32, device=x.device)
    if not rows:
        return dx.view(x.shape), dscale.zero_(), dbias.zero_()
    blocks = bwd_blocks(rows, torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty(blocks, 2, d, dtype=torch.float32, device=x.device)
    _launch(x2, lib.univl_layernorm_bwd, "LayerNorm backward kernel launch",
            *_ptrs(x2, scale, dy2, dx, part, dscale, dbias),
            int(x.dtype == torch.bfloat16), rows, d, eps, blocks)
    layer_norm_bwd.launches += 1
    return dx.view(x.shape), dscale, dbias


layer_norm_fwd.launches = 0  # kernel launches; the CPU path adds nothing
layer_norm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, dbias, None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = LN_EPS) -> torch.Tensor:
    """LayerNormTF over the last dim through the kernels, differentiable.

    x: [..., D] f32 or bf16; scale, bias: f32 [D]. Returns x's dtype and shape."""
    return _FusedLayerNorm.apply(x, scale, bias, eps)
