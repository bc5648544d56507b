"""The port's eval attention (univl_tpu_torch/kernels/attention.py) against
the Pallas kernel it replaces, run in interpret mode on the CPU.

On a CPU tensor the port's wrapper takes the plain PyTorch version; the
CUDA kernel itself is checked against that version on the card by
chip_smoke.py.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univl_tpu.kernels.attention import fused_attention_masked as jax_attention
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
