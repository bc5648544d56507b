"""The port's eval attention (univl_tpu_torch/kernels/attention.py) against
the Pallas kernel it replaces, run in interpret mode on the CPU, with its
key mask and with its causal branch.

On a CPU tensor the port's wrapper takes the plain PyTorch version; the
CUDA kernel itself is checked against that version on the card by
chip_smoke.py.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univl_tpu.kernels.attention import fused_attention_masked as jax_attention
from univl_tpu_torch.kernels import attention as attn
from univl_tpu_torch.kernels.attention import attention_reference, fused_attention_masked


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(B, H, L, D, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    mask = (rng.rand(B, L) > 0.3).astype(np.float32)
    mask[:, -1] = 1.0  # every row keeps a key: all-masked rows are padding
    mask[0] = 0.0
    mask[0, L // 2] = 1.0  # a row with a single valid key
    return q, k, v, mask


# f32 throughout: the two compute the same f32 math in another order, so
# they agree to rounding (measured <= 1e-6); 1e-5 leaves room for it.
@pytest.mark.parametrize("B,H,L,D", [(2, 3, 10, 8), (2, 12, 48, 64), (2, 12, 96, 64)])
def test_matches_pallas_kernel(B, H, L, D):
    q, k, v, mask = _inputs(B, H, L, D)
    want = np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v, mask))))
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got_ref = attention_reference(*t).numpy()
    got = fused_attention_masked(*t).numpy()
    np.testing.assert_allclose(got_ref, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, got_ref)  # the CPU wrapper is the plain version
    assert fused_attention_masked.launches == 0  # no kernel launch on the CPU


def _causal_rows(mask, Lq):
    """[B, Lq]: the query keeps a valid key at or before its own position;
    the other rows are discarded (padding), as for the key mask alone."""
    return np.cumsum(mask, axis=1)[:, :Lq] > 0


# f32: as above, 1e-5. The shapes: square, and Lk != Lq, where row and column
# are compared directly (no offset), as in the TPU kernel.
@pytest.mark.parametrize("B,H,Lq,Lk,D", [(2, 3, 10, 10, 8), (2, 12, 48, 48, 64),
                                         (2, 2, 6, 12, 16)])
def test_causal_matches_pallas_kernel(B, H, Lq, Lk, D):
    rng = np.random.RandomState(3)
    q = rng.randn(B, H, Lq, D).astype(np.float32)
    k, v = (rng.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
    mask = (rng.rand(B, Lk) > 0.3).astype(np.float32)
    mask[0, :3] = 0.0  # the first queries of row 0 see no valid key: discarded
    mask[1, 0] = 1.0
    want = np.asarray(jax_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), causal=True))
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got = fused_attention_masked(*t, causal=True).numpy()
    keep = _causal_rows(mask, Lq)
    assert not keep.all()
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[keep],
                               want.transpose(0, 2, 1, 3)[keep], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, attention_reference(*t, causal=True).numpy())
    # the first query attends to key 0 alone where that key is valid
    np.testing.assert_array_equal(got[1, :, 0], v[1, :, 0])
    assert fused_attention_masked.launches == fused_attention_masked.causal_launches == 0


def test_strided_head_split_views():
    """The model passes [B, L, H, D] projections viewed as [B, H, L, D]."""
    q, k, v, mask = _inputs(2, 4, 12, 16, seed=1)
    dense = [torch.from_numpy(a).transpose(1, 2).contiguous() for a in (q, k, v)]
    views = [t.transpose(1, 2) for t in dense]
    got = fused_attention_masked(*views, torch.from_numpy(mask))
    want = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_bfloat16_rounds_probs_like_pallas():
    q, k, v, mask = _inputs(2, 3, 16, 8, seed=2)
    want = jax_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask))
    got = fused_attention_masked(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                 torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the output (values below 4 in magnitude)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=1.6e-2)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "rank", "kv_shape", "mask_shape",
                                  "head_dim"])
def test_rejects_bad_inputs(case):
    q = torch.zeros(2, 3, 8, 16)
    k = torch.zeros(2, 3, 8, 16)
    v = torch.zeros(2, 3, 8, 16)
    mask = torch.ones(2, 8)
    err = ValueError
    if case == "dtype":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif case == "mixed_dtype":
        k, err = k.bfloat16(), TypeError
    elif case == "rank":
        q = q[0]
    elif case == "kv_shape":
        v = torch.zeros(2, 3, 9, 16)
    elif case == "mask_shape":
        mask = torch.ones(2, 9)
    elif case == "head_dim":
        q, k, v = (torch.zeros(2, 3, 8, 256) for _ in range(3))
    with pytest.raises(err):
        fused_attention_masked(q, k, v, mask)


def test_import_needs_no_cuda_toolchain():
    code = (
        "import univl_tpu_torch.kernels.attention as a, univl_tpu_torch.kernels._build as b\n"
        "assert b._lib is None\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env={"PATH": ""},
                   cwd=Path(__file__).parents[1])


# The caption eval's cross tower (128 words + 96 frames = 224 keys, the most
# any call of the model takes) and causal heads with Lq != Lk both ways; the
# JAX kernel in interpret mode under jax.jit. f32: the same math in another
# order, 1e-5 as above.
@pytest.mark.parametrize("B,H,Lq,Lk,D,causal", [(2, 2, 224, 224, 64, False),
                                                (2, 4, 48, 96, 64, True),
                                                (2, 4, 96, 48, 64, True),
                                                (2, 3, 17, 40, 16, True)])
def test_long_and_causal_heads_match_pallas_kernel(B, H, Lq, Lk, D, causal):
    rng = np.random.RandomState(5)
    q = rng.randn(B, H, Lq, D).astype(np.float32)
    k, v = (rng.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
    mask = (rng.rand(B, Lk) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0  # every query keeps a valid key at or before it
    want = np.asarray(jax.jit(functools.partial(jax_attention, causal=causal))(
        *(jnp.asarray(a) for a in (q, k, v, mask))))
    got = fused_attention_masked(*(torch.from_numpy(a) for a in (q, k, v, mask)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# The route of a CUDA call: the tensor cores take bf16 at head dim 64 with at
# most 256 keys, whatever the query length; f32 (TF32 on the tensor cores)
# and every other bf16 head take the CUDA cores.
@pytest.mark.parametrize("dtype,D,Lq,Lk,route", [
    (torch.bfloat16, 64, 48, 48, attn.TENSOR_CORES),
    (torch.bfloat16, 64, 224, 224, attn.TENSOR_CORES),
    (torch.bfloat16, 64, 1000, 256, attn.TENSOR_CORES),
    (torch.bfloat16, 64, 96, 257, attn.CUDA_CORES),
    (torch.float32, 64, 96, 96, attn.CUDA_CORES),
    (torch.bfloat16, 32, 96, 96, attn.CUDA_CORES),
    (torch.bfloat16, 128, 48, 48, attn.CUDA_CORES),
])
def test_cuda_route(dtype, D, Lq, Lk, route):
    assert attn.cuda_route(dtype, D, Lq, Lk) == route


# 16-row query tiles a tensor-core block takes: 3 where Lq is a multiple of
# 48 (no ragged tile at the towers' 48 and the cross tower's 96), else 4.
@pytest.mark.parametrize("Lq,warps", [(1, 4), (16, 4), (17, 4), (40, 4), (48, 3), (80, 4),
                                      (96, 3), (128, 4), (144, 3), (224, 4), (512, 4)])
def test_query_tile_warps(Lq, warps):
    assert attn.query_tile_warps(Lq) == warps <= attn.MMA_MAX_WARPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_path_never_falls_back(dtype):
    """A tensor that is not on the CPU goes to a kernel or raises, on either route."""
    q = torch.zeros(2, 3, 8, 64, dtype=dtype, device="meta")
    mask = torch.ones(2, 8, device="meta")
    before = [getattr(fused_attention_masked, c) for c in (
        "launches", "cuda_core_launches", "causal_launches", "cuda_core_causal_launches")]
    for causal in (False, True):
        with pytest.raises(ValueError, match="no eval-attention kernel for device meta"):
            fused_attention_masked(q, q, q, mask, causal=causal)
    assert before == [getattr(fused_attention_masked, c) for c in (
        "launches", "cuda_core_launches", "causal_launches", "cuda_core_causal_launches")]
