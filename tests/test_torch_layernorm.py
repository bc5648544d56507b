"""The port's LayerNorm kernel #6 (univl_tpu_torch/kernels/layernorm.py)
against the Pallas kernel it replaces, run in interpret mode on the CPU, and
the model's fused-LayerNorm route.

On a CPU tensor the port's wrappers take the plain PyTorch versions; the CUDA
kernels themselves are held against those versions on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univl_tpu.kernels.layernorm import fused_layer_norm as jax_fused_layer_norm
from univl_tpu_torch import config
from univl_tpu_torch.kernels import layernorm as ln
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers

EPS = 1e-12
D = 128


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(rows: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, D).astype(np.float32) * 2.0 + 0.5,
            (1.0 + 0.2 * rng.randn(D)).astype(np.float32),
            (0.1 * rng.randn(D)).astype(np.float32),
            rng.randn(rows, D).astype(np.float32))


# 256 rows tile the TPU kernel's blocks; 300 take a single block there. f32:
# the same f32 math, sums in another order. bf16: inputs rounded to bf16 on
# both sides; the f32 math agrees to ~1e-6 and the output's bf16 rounding
# flips by one ulp where it lands on a boundary (2^-8 of the value).
@pytest.mark.parametrize("rows", [256, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(rows, dtype):
    x, scale, bias, g = _inputs(rows)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)

    def loss(x_, s_, b_):
        y = jax_fused_layer_norm(x_, s_, b_, EPS, True)
        return jnp.sum(y.astype(jnp.float32) * jg.astype(jnp.float32)), y

    (_, want_y), (want_dx, want_ds, want_db) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jx, jnp.asarray(scale), jnp.asarray(bias))
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    y = ln.layer_norm_fwd(tx, ts, tb, EPS)
    dx, ds, db = ln.layer_norm_bwd(tx, ts, tg, EPS)
    assert y.dtype == dx.dtype == tdt and ds.dtype == db.dtype == torch.float32

    def close(got, want, rtol, atol):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=rtol, atol=atol)

    ytol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 1e-2)
    close(y, want_y, *ytol)
    close(dx, want_dx, *ytol)
    # column sums over 256-300 rows of terms ~1: f32 rounding of the sum order
    close(ds, want_ds, 1e-5, 1e-4)
    close(db, want_db, 1e-5, 1e-4)
    assert ln.layer_norm_fwd.launches == ln.layer_norm_bwd.launches == 0  # no kernel on the CPU


def test_autograd_function_matches_layernorm_tf():
    """fused_layer_norm's gradients are LayerNormTF's (autograd through the
    plain ops), on a [B, L, D] input that needs its gradient."""
    x, scale, bias, g = _inputs(24, seed=1)
    x = torch.from_numpy(x).view(2, 12, D)
    ref = layers.LayerNormTF(D)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(scale))
        ref.bias.copy_(torch.from_numpy(bias))
    fused = layers.LayerNormTF(D)
    fused.load_state_dict(ref.state_dict())
    layers.set_fused_layer_norm(fused)
    outs = []
    for mod in (ref, fused):
        xi = x.clone().requires_grad_()
        y = mod(xi)
        (y * torch.from_numpy(g).view(2, 12, D)).sum().backward()
        outs.append((y.detach(), xi.grad, mod.weight.grad, mod.bias.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_set_fused_layer_norm_reaches_every_layernorm_and_keeps_the_output():
    """Every LayerNormTF of a caption model (towers, NormalizeVideo, decoder,
    classifier transform) takes the fused route, and the decoder's logits
    stay the plain route's on the CPU."""
    cfg = config.UniVLConfig.tiny(stage_two=True, task_type="caption")
    model = UniVL(cfg).eval()
    lns = [m for m in model.modules() if isinstance(m, layers.LayerNormTF)]
    assert len(lns) == 2 * sum(c.num_hidden_layers for c in (cfg.bert, cfg.visual, cfg.cross)) \
        + 3 * cfg.decoder.num_decoder_layers + 6  # 3 tower embeddings, video, decoder + transform
    rng = np.random.RandomState(2)
    B, Lw, Lv = 2, cfg.max_words, cfg.max_frames
    ids = torch.from_numpy(rng.randint(1, cfg.bert.vocab_size, (B, Lw)))
    am = torch.ones(B, Lw, dtype=torch.long)
    video = torch.from_numpy(rng.randn(B, Lv, cfg.video_dim).astype(np.float32))
    vm = torch.ones(B, Lv, dtype=torch.long)
    with torch.no_grad():
        seq, vis = model.encode(ids, torch.zeros_like(ids), am, video, vm)
        want = model.decoder_logits(seq, vis, am, vm, ids, am)
        layers.set_fused_layer_norm(model)
        assert all(m.fused for m in lns)
        seq, vis = model.encode(ids, torch.zeros_like(ids), am, video, vm)
        got = model.decoder_logits(seq, vis, am, vm, ids, am)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    layers.set_fused_layer_norm(model, False)
    assert not any(m.fused for m in lns)


def test_cuda_path_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    x = torch.zeros(4, 768, device="meta")
    s, b = torch.ones(768, device="meta"), torch.zeros(768, device="meta")
    with pytest.raises(ValueError, match="no LayerNorm kernel for device meta"):
        ln.layer_norm_fwd(x, s, b)
    with pytest.raises(ValueError, match="no LayerNorm kernel for device meta"):
        ln.layer_norm_bwd(x, s, x)
    assert ln.layer_norm_fwd.launches == ln.layer_norm_bwd.launches == 0


@pytest.mark.parametrize("case", ["dtype", "scale_dtype", "scale_shape", "width"])
def test_rejects_bad_inputs(case):
    x, s, b = torch.zeros(4, 16), torch.ones(16), torch.zeros(16)
    err = ValueError
    if case == "dtype":
        x, err = x.double(), TypeError
    elif case == "scale_dtype":
        s = s.bfloat16()
    elif case == "scale_shape":
        s = torch.ones(8)
    elif case == "width":
        b = torch.zeros(8)
    with pytest.raises(err):
        ln.fused_layer_norm(x, s, b)


# NormalizeVideo's LayerNorm: S3D width 1024 in f32 (the model normalizes the
# raw features in f32). Tolerances as above; the column sums over 256 rows.
def test_plain_version_matches_pallas_kernel_at_video_width():
    rng = np.random.RandomState(3)
    rows, width = 256, 1024
    x = rng.randn(rows, width).astype(np.float32) * 2.0 + 0.5
    scale = (1.0 + 0.2 * rng.randn(width)).astype(np.float32)
    bias = (0.1 * rng.randn(width)).astype(np.float32)
    g = rng.randn(rows, width).astype(np.float32)

    def loss(x_, s_, b_):
        y = jax_fused_layer_norm(x_, s_, b_, EPS, True)
        return jnp.sum(y * jnp.asarray(g)), y

    (_, want_y), (want_dx, want_ds, want_db) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*(jnp.asarray(a) for a in (x, scale, bias)))
    tx, ts, tb, tg = (torch.from_numpy(a) for a in (x, scale, bias, g))
    y = ln.layer_norm_fwd(tx, ts, tb, EPS)
    dx, ds, db = ln.layer_norm_bwd(tx, ts, tg, EPS)
    for got, want, tol in ((y, want_y, 1e-5), (dx, want_dx, 1e-5), (ds, want_ds, 1e-4),
                           (db, want_db, 1e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=tol)


# The backward's grid, and so the partial rows its dscale/dbias sum adds: a
# block for every BWD_WARPS rows (one a warp), at most one an SM.
@pytest.mark.parametrize("rows,sms,blocks", [(0, 132, 1), (1, 132, 1), (8, 132, 1), (9, 132, 2),
                                             (300, 132, 38), (1056, 132, 132),
                                             (1536, 132, 132), (2048, 132, 132),
                                             (3584, 132, 132), (3584, 114, 114)])
def test_bwd_blocks(rows, sms, blocks):
    assert ln.BWD_WARPS == 8
    assert ln.bwd_blocks(rows, sms) == blocks
    assert -(-rows // blocks) * blocks >= rows  # every row has a block
