"""The port's training attention (univl_tpu_torch/kernels/train_attention.py)
against the Pallas kernels it replaces, run in interpret mode on the CPU, and
its Philox dropout against an independent pure-Python Philox4x32-10.

On a CPU tensor the port's wrappers take the plain PyTorch versions; the CUDA
kernels themselves (tensor-core kernels for bf16, CUDA-core ones for f32) are
held against those versions on the card by chip_smoke.py, which also checks
that the forward kernel, the backward kernel and the plain version drop the
same probabilities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univl_tpu.kernels.train_attention import fused_train_attention as jax_train_attention
from univl_tpu_torch.kernels import train_attention as ta

B, L, H, D = 3, 16, 4, 16  # B is not a multiple of the JAX batch block (8)


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, L, H * D).astype(np.float32) for _ in range(4))
    lengths = np.array([[16], [7], [1]])
    mask = (np.arange(L) < lengths).astype(np.float32)  # ragged, one row with a single key
    return q, k, v, g, mask


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# f32 on both sides: the same math summed in another order (measured <= 1e-6)
def test_plain_version_matches_pallas_kernel_at_rate_0():
    q, k, v, g, mask = _inputs()
    mask[2] = 0.0  # no valid key: both give the uniform softmax (the -1e9 bias cancels)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    want, vjp = jax.vjp(jax.jit(lambda *a: jax_train_attention(*a, jnp.asarray(mask), 0, 0.0,
                                                                H)), *jargs)
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv, tg, tm = _t(q, k, v, g, mask)
    out, m, l = ta.train_attention_fwd(tq, tk, tv, tm, 0, 0.0, H)
    grads = ta.train_attention_bwd(tq, tk, tv, tm, 0, 0.0, H, m, l, tg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for got, w in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    # the masked row attends uniformly over all keys
    np.testing.assert_allclose(out[2].numpy(), np.broadcast_to(v[2].mean(0), (L, H * D)),
                               rtol=0, atol=1e-5)
    assert ta.train_attention_fwd.launches == ta.train_attention_bwd.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_runs_the_backward(dtype):
    """fused_train_attention's backward equals train_attention_bwd on the same
    saved statistics, and its forward the plain forward, at rate 0.1."""
    q, k, v, g, mask = (t.to(dtype) if t.dim() == 3 else t for t in _t(*_inputs(1)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ta.fused_train_attention(*leaves, mask, 7, 0.1, H)
    out.backward(g)
    want, m, l = ta.train_attention_reference_fwd(q, k, v, mask, 7, 0.1, H)
    want_grads = ta.train_attention_reference_bwd(q, k, v, mask, 7, 0.1, H, m, l, g)
    assert out.dtype == dtype
    assert torch.equal(out.detach(), want)
    for leaf, w in zip(leaves, want_grads):
        assert torch.equal(leaf.grad, w)


def test_plain_backward_matches_autograd_with_dropout():
    """The hand-derived backward against autograd through the plain forward,
    at rate 0.1 with the same mask, in f32."""
    q, k, v, g, mask = _t(*_inputs(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, m, l = ta.train_attention_reference_fwd(*leaves, mask, 11, 0.1, H)
    out.backward(g)
    got = ta.train_attention_reference_bwd(q, k, v, mask, 11, 0.1, H, m.detach(), l.detach(), g)
    for leaf, w in zip(leaves, got):
        np.testing.assert_allclose(w.numpy(), leaf.grad.numpy(), rtol=0, atol=1e-6)


def _philox_python(ctr, key, rounds=10):
    """Philox4x32 in Python integers, from the definition (Salmon et al.)."""
    M = 0xFFFFFFFF
    c, k = list(ctr), list(key)
    for r in range(rounds):
        if r:
            k = [(k[0] + 0x9E3779B9) & M, (k[1] + 0xBB67AE85) & M]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M, (p0 >> 32) ^ c[3] ^ k[1], p0 & M]
    return c


def test_philox_matches_python_and_known_answers():
    rng = np.random.RandomState(3)
    ctrs = [(0, 0, 0, 0), (0xFFFFFFFF,) * 4] + [tuple(rng.randint(0, 2**32, 4, dtype=np.uint64))
                                                  for _ in range(6)]
    keys = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF)] + [tuple(rng.randint(0, 2**32, 2, dtype=np.uint64))
                                                   for _ in range(6)]
    for ctr, key in zip(ctrs, keys):
        ctr, key = [int(x) for x in ctr], [int(x) for x in key]
        got = ta.philox4x32(*(torch.tensor([c]) for c in ctr), key[0] | key[1] << 32)
        assert [int(w) for w in got] == _philox_python(ctr, key)
    # Random123's known-answer vectors for philox4x32_10
    got = ta.philox4x32(*(torch.tensor([0]) for _ in range(4)), 0)
    assert [int(w) for w in got] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_dropout_mask_rate_and_determinism():
    shape = (8, 12, 48, 48)  # 221,184 draws
    keep = ta.dropout_keep(5, *shape, 0.1)
    n = keep.numel()
    dropped = 1.0 - keep.float().mean().item()
    assert abs(dropped - 0.1) <= 5 * np.sqrt(0.1 * 0.9 / n)
    assert torch.equal(keep, ta.dropout_keep(5, *shape, 0.1))
    assert not torch.equal(keep, ta.dropout_keep(6, *shape, 0.1))
    # a pure function of (seed, b, h, i, j): a sub-block is the same mask's corner
    assert torch.equal(ta.dropout_keep(5, 2, 3, 5, 7, 0.1), keep[:2, :3, :5, :7])
    assert bool(ta.dropout_keep(5, 2, 2, 4, 4, 0.0).all())


@pytest.mark.parametrize("case", ["dtype", "rank", "heads", "kv_shape", "mask_shape"])
def test_rejects_bad_inputs(case):
    q, k, v = (torch.zeros(2, 8, 32) for _ in range(3))
    mask, heads, err = torch.ones(2, 8), 4, ValueError
    if case == "dtype":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif case == "rank":
        q = q[0]
    elif case == "heads":
        heads = 5
    elif case == "kv_shape":
        v = torch.zeros(2, 9, 32)
    elif case == "mask_shape":
        mask = torch.ones(2, 9)
    with pytest.raises(err):
        ta.fused_train_attention(q, k, v, mask, 0, 0.1, heads)


@pytest.mark.parametrize("rate, Lq, Lk", [
    pytest.param(0.0, 12, 20, id="0.0"), pytest.param(0.1, 12, 20, id="0.1"),
    pytest.param(0.0, 20, 36, id="0.0-20x36"), pytest.param(0.1, 20, 36, id="0.1-20x36")])
def test_tiled_backward_cpu_route_is_the_gradient(rate, Lq, Lk):
    """train_attention_bwd_tiled's CPU route (the plain version the card holds
    every backward kernel to) at Lq != Lk, neither a multiple of 16 (the
    tensor-core kernels' rows a warp and keys a chunk) nor of 64 (their
    tiles), against autograd through the plain forward with the same mask,
    in f32; at rate 0 also the forward and the backward against the Pallas
    kernel and its vjp."""
    rng = np.random.RandomState(4)
    B, H, D = 2, 3, 8
    q, g = (rng.randn(B, Lq, H * D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, Lk, H * D).astype(np.float32) for _ in range(2))
    mask = (rng.rand(B, Lk) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    tq, tk, tv, tg, tm = _t(q, k, v, g, mask)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out, m, l = ta.train_attention_reference_fwd(*leaves, tm, 11, rate, H)
    out.backward(tg)
    got = ta.train_attention_bwd_tiled(tq, tk, tv, tm, 11, rate, H, m.detach(), l.detach(), tg)
    for leaf, w in zip(leaves, got):
        np.testing.assert_allclose(w.numpy(), leaf.grad.numpy(), rtol=0, atol=1e-6)
    assert ta.train_attention_bwd_tiled.launches == 0
    if rate == 0.0:
        want, vjp = jax.vjp(jax.jit(lambda *a: jax_train_attention(*a, jnp.asarray(mask), 0, 0.0,
                                                                    H)),
                            *map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
        for w, want in zip(got, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(w.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _launch_counts():
    return (ta.train_attention_fwd.launches, ta.train_attention_fwd.cuda_core_launches,
            ta.train_attention_bwd.launches, ta.train_attention_bwd.cuda_core_launches,
            ta.train_attention_bwd_tiled.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version_whatever_the_route(dtype):
    """On the CPU either dtype (tensor cores or CUDA cores on the card)
    computes the plain versions and launches nothing."""
    q, k, v, g, mask = (t.to(dtype) if t.dim() == 3 else t for t in _t(*_inputs(5)))
    before = _launch_counts()
    want, m, l = ta.train_attention_reference_fwd(q, k, v, mask, 3, 0.1, H)
    want_grads = ta.train_attention_reference_bwd(q, k, v, mask, 3, 0.1, H, m, l, g)
    out, _, _ = ta.train_attention_fwd(q, k, v, mask, 3, 0.1, H)
    grads = ta.train_attention_bwd(q, k, v, mask, 3, 0.1, H, m, l, g)
    tiled = ta.train_attention_bwd_tiled(q, k, v, mask, 3, 0.1, H, m, l, g)
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert all(torch.equal(a, b) for a, b in zip(tiled, want_grads))
    assert _launch_counts() == before


def test_cuda_route_tensor_cores_for_bf16_cuda_cores_for_f32():
    """The selection a CUDA call goes through: every bf16 head of UniVL's
    main paths on the tensor-core kernels, f32 (which tensor cores would
    multiply as TF32) and bf16 heads past their limits on the CUDA-core ones;
    the launch helpers refuse a CPU tensor before any build or launch."""
    heads = [(48, 48), (96, 96), (128, 128), (224, 224), (128, 224)]  # towers, cross, caption
    for Lq, Lk in heads:
        assert ta.cuda_route(torch.bfloat16, 64, Lq, Lk) == ta.TENSOR_CORES
        assert ta.cuda_route(torch.float32, 64, Lq, Lk) == ta.CUDA_CORES
    assert ta.cuda_route(torch.bfloat16, 64, 512, 256) == ta.TENSOR_CORES
    for D, Lq, Lk in [(32, 48, 48), (128, 48, 48), (64, 48, 257), (64, 513, 48)]:
        assert ta.cuda_route(torch.bfloat16, D, Lq, Lk) == ta.CUDA_CORES
    q = torch.zeros(2, 8, 4 * 64)
    assert ta._cuda_route_of(q, q, 4) == ta.CUDA_CORES
    assert ta._cuda_route_of(q.bfloat16(), q.bfloat16(), 4) == ta.TENSOR_CORES
    mask = torch.ones(2, 8)
    for kind in (ta.FWD, ta.FWD_MMA):
        with pytest.raises(ValueError, match="no training-attention kernel for device cpu"):
            ta._launch_fwd(kind, q, q, q, mask, 0, 0.1, 4)
    m = torch.zeros(2, 4, 8)
    for kind in (ta.BWD_WHOLE, ta.BWD_TILED, ta.BWD_MMA):
        with pytest.raises(ValueError, match="no training-attention kernel for device cpu"):
            ta._launch_bwd(kind, q, q, q, mask, 0, 0.1, 4, m, m, q)
