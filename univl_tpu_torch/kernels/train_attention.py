"""Training attention: the hand-written CUDA kernels (forward and backward)
and their plain PyTorch versions.

``fused_train_attention`` replaces the Pallas TPU kernel
``univl_tpu/kernels/train_attention.py:fused_train_attention`` and keeps its
signature and layout: q, k, v are the dense ``[B, L, heads*D]`` projections
(no head-split transposes), ``key_mask`` is ``[B, Lk]`` (1 keep, 0 drop), the
attention probabilities are dropped inside the kernel, and the forward saves
only the softmax row max and row sum (``[B, heads, Lq]`` f32). The backward
recomputes the probabilities and regenerates the same dropout mask, so no
``[B, H, Lq, Lk]`` tensor exists in device memory.

On a CPU tensor ``train_attention_fwd`` and ``train_attention_bwd`` compute
the plain versions below; on a CUDA tensor they launch the kernels in
``univl_tpu_torch/csrc/train_attention.cu`` (built at first use) or raise.
``cuda_route`` picks the kernels. bf16 at head dim 64 (every bf16 head of
UniVL) takes the tensor-core kernels: a forward, and a backward of two
launches (dq; dk and dv), each counted as one call. f32 takes the CUDA-core
kernels, since tensor cores would multiply it as TF32: the forward, and the
whole-head backward where a head fits the block's shared memory (Lq, Lk up
to ~100 at D = 64), else the tiled one, ``train_attention_bwd_tiled``, two
launches over 32-row tiles with the same arithmetic.

Dropout bits: the TPU kernels draw theirs from the TPU's own generator
(``pltpu.prng_random_bits`` seeded with seed + program id), which cannot be
reproduced here. Both the kernels and the plain version use the counter-based
Philox4x32-10 of ``kernels/philox.py`` instead: element (b, h, i, j) is kept
where word ``j % 4`` of Philox(counter = (j // 4, i, h, b), key = the 64-bit
seed) is at least ``rate * 2**32`` (the TPU kernel's threshold). The mask is a pure function of
(seed, b, h, i, j), independent of block size and thread layout, so the
forward kernel, the backward kernel and the plain version see the same mask
bit for bit. The distribution is the TPU's; the bits are not.
"""

from __future__ import annotations

import math

import torch

from univl_tpu_torch.kernels import _build
from univl_tpu_torch.kernels.philox import keep_threshold, philox4x32

MASK_BIAS = -1e9  # in-kernel key bias (univl_tpu/kernels/train_attention.py:93)
SMEM_LIMIT = 227 * 1024  # Hopper's opt-in shared memory per block
MAX_HEAD_DIM = 128


def dropout_keep(seed: int, B: int, H: int, Lq: int, Lk: int, rate: float,
                 device=None) -> torch.Tensor:
    """The kernels' keep mask, bool [B, H, Lq, Lk]."""
    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    quads = -(-Lk // 4)
    c = torch.broadcast_tensors(axis(quads, 3), axis(Lq, 2), axis(H, 1), axis(B, 0))
    words = torch.stack(philox4x32(*c, seed), dim=-1)  # [B, H, Lq, quads, 4]
    return words.reshape(B, H, Lq, 4 * quads)[..., :Lk] >= keep_threshold(rate)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, L, heads*D] -> f32 [B, heads, L, D]."""
    B, L, HD = x.shape
    return x.float().view(B, L, heads, HD // heads).transpose(1, 2)


def _merge(x: torch.Tensor, dtype) -> torch.Tensor:
    """[B, heads, L, D] -> [B, L, heads*D] in ``dtype``."""
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D).to(dtype)


def _probs(q, k, key_mask, heads, m=None, l=None):
    """Softmax of the f32 scores with the key bias: (p, m, l). Given the
    forward's row max and sum, the same ops recompute the same p."""
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    s = torch.matmul(_heads(q, heads), _heads(k, heads).transpose(-1, -2)) * scale
    s = s + ((1.0 - key_mask.float()) * MASK_BIAS)[:, None, None, :]
    if m is None:
        m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    if l is None:
        l = e.sum(dim=-1)
    return e / l[..., None], m, l


def train_attention_reference_fwd(q, k, v, key_mask, seed: int, rate: float, heads: int):
    """The forward kernel's math in torch ops: f32 scores and softmax, the
    kept probabilities scaled by 1/(1-rate), rounded to the compute dtype
    before PV, PV summed in f32. Returns (out [B, Lq, heads*D], m, l)."""
    p, m, l = _probs(q, k, key_mask, heads)
    if rate > 0.0:
        keep = dropout_keep(seed, *p.shape, rate, device=p.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    o = torch.matmul(p.to(v.dtype).float(), _heads(v, heads))
    return _merge(o, q.dtype), m, l


def train_attention_reference_bwd(q, k, v, key_mask, seed: int, rate: float, heads: int,
                                  m, l, g):
    """The backward kernel's math in torch ops (the TPU kernel's roundings,
    univl_tpu/kernels/train_attention.py:140-172): p recomputed from m and l,
    the same mask, dv from the dropped probs rounded to the compute dtype, ds
    rounded to it, dq and dk scaled after the f32 sums."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    p, _, _ = _probs(q, k, key_mask, heads, m, l)
    gh = _heads(g.to(dt), heads)
    dp = torch.matmul(gh, _heads(v, heads).transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = dropout_keep(seed, *p.shape, rate, device=p.device)
        inv = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), gh)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, _heads(k, heads)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, heads)) * scale
    return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


def _check(q, k, v, key_mask, heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, L, heads*D]")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != HD:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if heads < 1 or HD % heads:
        raise ValueError(f"heads={heads} does not divide the width {HD}")
    if tuple(key_mask.shape) != (B, Lk):
        raise ValueError(f"key_mask must be [B, Lk] = {(B, Lk)}, got {tuple(key_mask.shape)}")
    if min(Lq, Lk) < 1:
        raise ValueError(f"need Lq, Lk >= 1, got Lq={Lq} Lk={Lk}")
    if len({q.device, k.device, v.device, key_mask.device}) != 1:
        raise ValueError("q, k, v and key_mask must be on one device")


# the kernels, as univl_train_attention_smem_bytes names them: the CUDA-core
# forward, whole-head and tiled backwards; the tensor-core forward and backward
FWD, BWD_WHOLE, BWD_TILED, FWD_MMA, BWD_MMA = 0, 1, 2, 3, 4
TENSOR_CORES, CUDA_CORES = "tensor cores", "CUDA cores"
MMA_HEAD_DIM = 64  # the tensor-core kernels' head dim
MMA_MAX_KEYS = 256  # the forward holds a row's scores in registers
MMA_MAX_QUERIES = 512  # the dk/dv kernel stages a head's q and g in shared memory


def cuda_route(dtype, head_dim: int, Lq: int, Lk: int) -> str:
    """The kernels a CUDA call takes: TENSOR_CORES for bf16 at head dim 64,
    Lk <= 256 and Lq <= 512 (every bf16 head of UniVL), else CUDA_CORES (f32,
    which tensor cores would multiply as TF32, and other bf16 heads)."""
    if (dtype == torch.bfloat16 and head_dim == MMA_HEAD_DIM and Lk <= MMA_MAX_KEYS
            and Lq <= MMA_MAX_QUERIES):
        return TENSOR_CORES
    return CUDA_CORES


def _cuda_route_of(q, k, heads: int) -> str:
    """``cuda_route`` for the tensors of a call."""
    return cuda_route(q.dtype, q.shape[2] // heads, q.shape[1], k.shape[1])


def _cuda_args(q: torch.Tensor, k: torch.Tensor, heads: int, rate: float, kind: int):
    """Checks what the kernel takes; returns the library and the launch
    arguments shared by the forward and the backwards (types, shapes, scale,
    dropout threshold, 1/(1-rate), dropout on)."""
    if q.device.type != "cuda":
        raise ValueError(f"no training-attention kernel for device {q.device}")
    B, Lq, HD = q.shape
    Lk, D = k.shape[1], HD // heads
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"the kernels read 16-byte rows: need a head dim that is a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}, got {D}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    lib = _build.load_library()
    smem = lib.univl_train_attention_smem_bytes(Lq, Lk, D, kind)
    if smem > SMEM_LIMIT:
        what = ("forward", "whole-head backward", "tiled backward", "tensor-core forward",
                "tensor-core backward")[kind]
        raise ValueError(f"Lq={Lq}, Lk={Lk}, D={D} needs {smem} bytes of shared memory per "
                         f"block in the {what}; the limit is {SMEM_LIMIT}")
    return lib, (int(q.dtype == torch.bfloat16), B, heads, Lq, Lk, D, 1.0 / math.sqrt(D),
                 keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0))


def whole_head_backward_fits(Lq: int, Lk: int, D: int) -> bool:
    """Whether the CUDA-core whole-head backward can stage a head of this
    shape (otherwise the CUDA-core route takes the tiled one)."""
    return _build.load_library().univl_train_attention_smem_bytes(Lq, Lk, D, BWD_WHOLE) \
        <= SMEM_LIMIT


def _aligned(*ts):
    """Data pointers of the tensors the kernels read and write in 16-byte words."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("q, k, v and g must start on 16-byte boundaries")
    return [t.data_ptr() for t in ts]


def _launch_fwd(kind: int, q, k, v, key_mask, seed: int, rate: float, heads: int):
    """One of the forward kernels (FWD, FWD_MMA) on CUDA tensors, uncounted:
    (out, m, l)."""
    lib, args = _cuda_args(q, k, heads, rate, kind)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = key_mask.to(torch.float32).contiguous()
    B, H, Lq = q.shape[0], heads, q.shape[1]
    out = torch.empty_like(q)
    m = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = lib.univl_train_attention_fwd_mma if kind == FWD_MMA else lib.univl_train_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*_aligned(q, k, v), mask.data_ptr(), *_aligned(out), m.data_ptr(),
                 l.data_ptr(), *args, seed & 0xFFFFFFFFFFFFFFFF, stream)
    _build.check(lib, err, f"training attention forward kernel launch "
                           f"({TENSOR_CORES if kind == FWD_MMA else CUDA_CORES})")
    return out, m, l


def train_attention_fwd(q, k, v, key_mask, seed: int, rate: float, heads: int):
    """(out [B, Lq, heads*D] in q's dtype, m, l [B, heads, Lq] f32): on a
    CUDA tensor the forward kernel of ``cuda_route``, on a CPU one its plain
    version."""
    _check(q, k, v, key_mask, heads)
    if q.device.type == "cpu":
        return train_attention_reference_fwd(q, k, v, key_mask, seed, rate, heads)
    if _cuda_route_of(q, k, heads) == TENSOR_CORES:
        out = _launch_fwd(FWD_MMA, q, k, v, key_mask, seed, rate, heads)
        train_attention_fwd.launches += 1
    else:
        out = _launch_fwd(FWD, q, k, v, key_mask, seed, rate, heads)
        train_attention_fwd.cuda_core_launches += 1
    return out


def _launch_bwd(kind: int, q, k, v, key_mask, seed: int, rate: float, heads: int, m, l, g):
    """One of the backward kernels (BWD_WHOLE, BWD_TILED, BWD_MMA) on CUDA
    tensors, uncounted: (dq, dk, dv)."""
    lib, args = _cuda_args(q, k, heads, rate, kind)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    g = g.to(q.dtype).contiguous()
    mask = key_mask.to(torch.float32).contiguous()
    m, l = m.contiguous(), l.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [*_aligned(q, k, v), mask.data_ptr(), m.data_ptr(), l.data_ptr(),
            *_aligned(g, dq, dk, dv)]
    fn = {BWD_WHOLE: lib.univl_train_attention_bwd, BWD_TILED: lib.univl_train_attention_bwd_tiled,
          BWD_MMA: lib.univl_train_attention_bwd_mma}[kind]
    delta = torch.empty_like(m)  # rowsum(dp * p), between the two kernels of a two-launch backward
    if kind != BWD_WHOLE:
        ptrs.append(delta.data_ptr())
    with torch.cuda.device(q.device):
        err = fn(*ptrs, *args, seed & 0xFFFFFFFFFFFFFFFF,
                 torch.cuda.current_stream(q.device).cuda_stream)
    what = {BWD_WHOLE: "whole-head", BWD_TILED: "tiled", BWD_MMA: "tensor-core"}[kind]
    _build.check(lib, err, f"training attention {what} backward kernel launch")
    return dq, dk, dv


def train_attention_bwd(q, k, v, key_mask, seed: int, rate: float, heads: int, m, l, g):
    """(dq, dk, dv), each in q's dtype and layout: on a CUDA tensor the
    backward of ``cuda_route``: the tensor-core kernels, or
    the CUDA-core whole-head kernel where it can stage the head, else the
    tiled one (``train_attention_bwd_tiled``); on a CPU one the plain version."""
    _check(q, k, v, key_mask, heads)
    if q.device.type == "cpu":
        return train_attention_reference_bwd(q, k, v, key_mask, seed, rate, heads, m, l, g)
    if _cuda_route_of(q, k, heads) == TENSOR_CORES:
        out = _launch_bwd(BWD_MMA, q, k, v, key_mask, seed, rate, heads, m, l, g)
        train_attention_bwd.launches += 1
        return out
    if not whole_head_backward_fits(q.shape[1], k.shape[1], q.shape[2] // heads):
        return train_attention_bwd_tiled(q, k, v, key_mask, seed, rate, heads, m, l, g)
    out = _launch_bwd(BWD_WHOLE, q, k, v, key_mask, seed, rate, heads, m, l, g)
    train_attention_bwd.cuda_core_launches += 1
    return out


def train_attention_bwd_tiled(q, k, v, key_mask, seed: int, rate: float, heads: int, m, l, g):
    """(dq, dk, dv) through the CUDA-core tiled backward kernels on a CUDA
    tensor, any Lq and Lk (two launches, counted as one call); the plain
    version (the same function) on a CPU one."""
    _check(q, k, v, key_mask, heads)
    if q.device.type == "cpu":
        return train_attention_reference_bwd(q, k, v, key_mask, seed, rate, heads, m, l, g)
    out = _launch_bwd(BWD_TILED, q, k, v, key_mask, seed, rate, heads, m, l, g)
    train_attention_bwd_tiled.launches += 1
    return out


# calls that launched a kernel; the CPU path adds nothing
train_attention_fwd.launches = 0  # the tensor-core forward's
train_attention_fwd.cuda_core_launches = 0
train_attention_bwd.launches = 0  # the tensor-core backward's
train_attention_bwd.cuda_core_launches = 0  # the whole-head backward's
train_attention_bwd_tiled.launches = 0


class _FusedTrainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, seed, rate, heads):
        key_mask = key_mask.to(torch.float32)
        o, m, l = train_attention_fwd(q, k, v, key_mask, seed, rate, heads)
        ctx.save_for_backward(q, k, v, key_mask, m, l)
        ctx.seed, ctx.rate, ctx.heads = seed, rate, heads
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, m, l = ctx.saved_tensors
        dq, dk, dv = train_attention_bwd(q, k, v, key_mask, ctx.seed, ctx.rate, ctx.heads,
                                         m, l, g)
        return dq, dk, dv, None, None, None, None


def fused_train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: torch.Tensor, seed: int, rate: float,
                          heads: int) -> torch.Tensor:
    """Attention with in-kernel probability dropout, differentiable.

    q: [B, Lq, heads*D], k, v: [B, Lk, heads*D], one dtype (f32 or bf16);
    key_mask: [B, Lk], 1 keep and 0 drop; seed: a host int (the Philox key);
    rate: the probability dropout rate. Returns [B, Lq, heads*D]."""
    return _FusedTrainAttention.apply(q, k, v, key_mask, seed, rate, heads)
