"""The port's fused FFN kernels #3, #4, #5 (univl_tpu_torch/kernels/ffn.py)
against the Pallas kernels they replace, run in interpret mode on the CPU;
their Philox dropout; the fused routes of TransformerLayer against JAX's; and
FT-Align training (the cross encoder over all pairs) against
jax.value_and_grad on every FFN route.

On a CPU tensor the port's wrappers take the plain PyTorch versions; the CUDA
kernels themselves are held against those versions on the card by
chip_smoke.py, which also checks that the forward kernel, the backward kernel
and the plain version drop the same entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univl_tpu import config as jax_config
from univl_tpu.kernels import ffn as jffn
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.nn import layers as jl
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import state_dict_from_jax_params
from univl_tpu_torch.kernels import ffn, philox
from univl_tpu_torch.kernels import train_attention as ta
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers

H, F = 256, 512
EPS = 1e-12


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(N, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.randn(N, H).astype(np.float32),
        "r": rng.randn(N, H).astype(np.float32),
        "w1": (0.05 * rng.randn(H, F)).astype(np.float32),
        "b1": (0.1 * rng.randn(F)).astype(np.float32),
        "w2": (0.05 * rng.randn(F, H)).astype(np.float32),
        "b2": (0.1 * rng.randn(H)).astype(np.float32),
        "w": (0.05 * rng.randn(H, H)).astype(np.float32),
        "b": (0.1 * rng.randn(H)).astype(np.float32),
        "scale": (1.0 + 0.3 * rng.randn(H)).astype(np.float32),
        "bias": (0.1 * rng.randn(H)).astype(np.float32),
        "g": rng.randn(N, H).astype(np.float32),
    }


# name -> (argument names, JAX kernel at rate 0, port function at rate 0)
KERNELS = {
    "ffn": (("x", "w1", "b1", "w2", "b2"), jffn.fused_ffn, ffn.fused_ffn),
    "ffn_block": (("x", "w1", "b1", "w2", "b2", "scale", "bias"),
                  lambda *a: jffn.fused_ffn_block(*a, jnp.int32(0), 0.0, EPS),
                  lambda *a: ffn.fused_ffn_block(*a, 0, 0.0, EPS)),
    "dense_block": (("x", "r", "w", "b", "scale", "bias"),
                    lambda *a: jffn.fused_dense_block(*a, jnp.int32(0), 0.0, EPS),
                    lambda *a: ffn.fused_dense_block(*a, 0, 0.0, EPS)),
}


# f32 on both sides: the same math with sums in another order and the exact
# erf against the kernels' A&S polynomial (|err| <= 1.5e-7)
@pytest.mark.parametrize("N", [256, 300])  # 300 leaves a ragged last row tile
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plain_version_matches_pallas_kernel(name, N):
    """Forward within 1e-5; every gradient (dscale and dbias included) within
    2e-5 of its largest entry, through the port's autograd.Function."""
    names, jax_fn, port_fn = KERNELS[name]
    inp = _inputs(N)
    args = [inp[n] for n in names]
    want, vjp = jax.vjp(jax.jit(jax_fn), *(jnp.asarray(a) for a in args))
    want_grads = vjp(jnp.asarray(inp["g"]))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = port_fn(*leaves)
    got.backward(torch.from_numpy(inp["g"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for n, leaf, w in zip(names, leaves, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy() / np.abs(w).max(), w / np.abs(w).max(),
                                   rtol=0, atol=2e-5, err_msg=n)
    assert all(f.launches == 0 for f in (ffn.ffn_fwd, ffn.ffn_bwd, ffn.ffn_block_fwd,
                                         ffn.ffn_block_bwd, ffn.dense_block_fwd,
                                         ffn.dense_block_bwd))


def test_plain_versions_match_the_jax_oracles():
    """The three JAX oracles (ffn_reference, ffn_block_reference,
    dense_block_reference) against the port's plain forwards at rate 0."""
    inp = _inputs(64, seed=1)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    pairs = [
        (ffn.ffn_reference_fwd(t["x"], t["w1"], t["b1"], t["w2"], t["b2"])[0],
         jffn.ffn_reference(j["x"], j["w1"], j["b1"], j["w2"], j["b2"])),
        (ffn.ffn_block_reference_fwd(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["scale"],
                                     t["bias"], 0, 0.0)[0],
         jffn.ffn_block_reference(j["x"], j["w1"], j["b1"], j["w2"], j["b2"], j["scale"],
                                  j["bias"])),
        (ffn.dense_block_reference_fwd(t["x"], t["r"], t["w"], t["b"], t["scale"], t["bias"], 0,
                                       0.0)[0],
         jffn.dense_block_reference(j["x"], j["r"], j["w"], j["b"], j["scale"], j["bias"])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", ["ffn_block", "dense_block"])
def test_dropout_mask_forward_equals_backward(kernel):
    """At rate 0.1 the plain forward drops exactly the entries the plain
    backward drops, both the Philox mask; the share within 5 binomial
    standard deviations. Forward: s - residual is the dropped output, 0
    exactly where dropped; backward: the dropped gradient, likewise."""
    N, rate, seed = 300, 0.1, 12345
    t = {k: torch.from_numpy(v) for k, v in _inputs(N, seed=2).items()}
    if kernel == "ffn_block":
        tag, res = philox.FFN_BLOCK_TAG, t["x"]
        _, pre, s = ffn.ffn_block_fwd(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["scale"],
                                      t["bias"], seed, rate, save=True)
        dropped = ffn.ffn_block_bwd(s, t["g"], pre, t["w1"], t["w2"], t["scale"], seed, rate)[3]
    else:
        tag, res = philox.DENSE_BLOCK_TAG, t["r"]
        _, s = ffn.dense_block_fwd(t["x"], t["r"], t["w"], t["b"], t["scale"], t["bias"], seed,
                                   rate, save=True)
        dropped = ffn.dense_block_bwd(s, t["g"], t["w"], t["scale"], seed, rate)[1]
    keep = philox.row_dropout_keep(seed, N, H, tag, rate)
    assert torch.equal(s != res, keep)
    assert torch.equal(dropped != 0, keep)
    share = 1.0 - keep.float().mean().item()
    assert abs(share - rate) <= 5 * np.sqrt(rate * (1 - rate) / keep.numel())
    # a pure function of (row, col): the rows from 100 on are the mask's tail
    assert torch.equal(philox.row_dropout_keep(seed, N - 100, H, tag, rate, row0=100),
                       keep[100:])
    other = philox.DENSE_BLOCK_TAG + philox.FFN_BLOCK_TAG - tag
    assert not torch.equal(philox.row_dropout_keep(seed, N, H, other, rate), keep)


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


def test_philox_module_gives_the_attention_masks_and_known_answers():
    """kernels/philox.py is the generator of #2 as well: Random123's known
    answer, and #2's and #4's keep bits from a pure-Python Philox."""
    got = philox.philox4x32(*(torch.tensor([0]) for _ in range(4)), 0)
    assert [int(w) for w in got] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    ones = [torch.tensor([0xFFFFFFFF]) for _ in range(4)]
    got = philox.philox4x32(*ones, 0xFFFFFFFFFFFFFFFF)
    assert [int(w) for w in got] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert ta.philox4x32 is philox.philox4x32
    seed, rate = 0x123456789ABCDEF, 0.1
    key = [seed & 0xFFFFFFFF, seed >> 32]
    thr = philox.keep_threshold(rate)
    att = ta.dropout_keep(seed, 2, 3, 5, 7, rate)
    row = philox.row_dropout_keep(seed, 5, 10, philox.FFN_BLOCK_TAG, rate)
    for b, h, i, j in [(0, 0, 0, 0), (1, 2, 4, 6), (1, 0, 3, 5), (0, 1, 2, 3)]:
        assert bool(att[b, h, i, j]) == (_philox_python((j // 4, i, h, b), key)[j % 4] >= thr)
    for r, c in [(0, 0), (4, 9), (2, 5), (3, 7)]:
        word = _philox_python((c // 4, r, philox.FFN_BLOCK_TAG, 0), key)[c % 4]
        assert bool(row[r, c]) == (word >= thr)


def test_cuda_path_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel or raises: on a
    device without the kernels, the wrapper raises instead of computing the
    plain version."""
    x = torch.zeros(4, 768, device="meta")
    w1, b1 = torch.zeros(768, 512, device="meta"), torch.zeros(512, device="meta")
    w2, b2 = torch.zeros(512, 768, device="meta"), torch.zeros(768, device="meta")
    with pytest.raises(ValueError, match="no fused-FFN kernel for device meta"):
        ffn.ffn_fwd(x, w1, b1, w2, b2)
    assert ffn.ffn_fwd.launches == 0


@pytest.mark.parametrize("N, splits, wide, narrow, fwd_mb, bwd_mb", [
    (1, 8, 12, 24, 0.0307, 0.0251),
    (300, 8, 36, 72, 9.2160, 7.3779),
    (1536, 4, 144, 144, 28.3116, 18.8989),
    (98304, 1, 9216, 2304, 603.9798, 1.5729),
])
def test_bf16_plan(N, splits, wide, narrow, fwd_mb, bwd_mb):
    """The bf16 kernels' plan at FT-Align's shapes (F 3072): 128-row GEMM
    tiles; h W2 and dpre W1^T split along F until the card's 132 SMs have a
    tile each (at least 4 stages of 64 a split), so a tower's 1,536 rows
    fill the card; scratch: h, the splits' f32 sums, #4's row statistics."""
    plan = ffn.ffn_plan(N, 3072)
    assert (plan["row_tile"], plan["col_tile"]) == (128, 256)
    assert (plan["splits"], plan["wide_tiles"], plan["narrow_tiles"]) == (splits, wide, narrow)
    steps = 3072 // ffn.GEMM_DEPTH
    assert steps % splits == 0 and steps // splits >= ffn.MIN_SPLIT_STEPS
    rows = -(-N // 32) * 32
    part = 4 * splits * N * 768 if splits > 1 else 0
    assert plan["scratch_bytes"] == {"fwd": 2 * N * 3072 + part, "bwd": part + 16 * rows}
    assert [round(plan["scratch_bytes"][k] / 1e6, 4) for k in ("fwd", "bwd")] == [fwd_mb, bwd_mb]
    if N >= 1536:
        assert min(wide, narrow) >= ffn.CARD_SMS
    # #3 keeps no row statistics; a narrow F cannot be split below 4 stages
    assert ffn.ffn_plan(N, 3072, block=False)["scratch_bytes"]["bwd"] == part
    assert ffn.ffn_plan(N, 256)["splits"] == 1


@pytest.mark.parametrize("N, ln_rows, blocks", [
    (98304, 32, 3072),
    (1536, 8, 192),
    (300, 8, 38),
    (1, 8, 1),
])
def test_ln_block_rows(N, ln_rows, blocks):
    """The bf16 backwards' LayerNorm head (#4 and #5) takes 32 rows a block
    where that gives the card's 132 SMs two blocks each, else 8 (a tower's
    1,536 rows: 192 blocks, not 48); the dscale/dbias partials have one row
    a block, and #4's plan reports the same rows."""
    assert ffn.ln_block_rows(N) == ffn.ffn_plan(N, 3072)["ln_block_rows"] == ln_rows
    assert -(-N // ln_rows) == blocks
    assert blocks >= 2 * ffn.CARD_SMS or ln_rows == ffn.LN_BLOCK_ROWS // 4
    x = torch.zeros(N, 768, dtype=torch.bfloat16, device="meta")
    assert ffn._partials(x, None).shape == (2, blocks, 768)


def test_dense_block_never_falls_back():
    """#5's wrappers send a tensor that is not on the CPU to the kernels or
    raise; nothing is counted."""
    x = torch.zeros(4, 768, device="meta")
    w, b = torch.zeros(768, 768, device="meta"), torch.zeros(768, device="meta")
    ln = torch.zeros(768, device="meta")
    with pytest.raises(ValueError, match="no fused-FFN kernel for device meta"):
        ffn.dense_block_fwd(x, x, w, b, ln, ln, 0, 0.1)
    with pytest.raises(ValueError, match="no fused-FFN kernel for device meta"):
        ffn.dense_block_bwd(x, x, w, ln, 0, 0.1)
    for f in (ffn.dense_block_fwd, ffn.dense_block_bwd):
        assert f.launches == f.cuda_core_launches == 0


@pytest.mark.parametrize("H, F", [(512, 1024), (768, 640), (768, 128)])
def test_card_refuses_shapes_the_kernels_do_not_take(H, F):
    """On the card the kernels take H = 768 and F a multiple of 256 (the
    GEMM tile's columns): other shapes raise before anything launches."""
    x = torch.zeros(4, H, device="meta")
    w1, b1 = torch.zeros(H, F, device="meta"), torch.zeros(F, device="meta")
    w2, b2 = torch.zeros(F, H, device="meta"), torch.zeros(H, device="meta")
    scale, bias = torch.zeros(H, device="meta"), torch.zeros(H, device="meta")
    with pytest.raises(ValueError, match="the kernels take H = 768 and F a multiple of 256"):
        ffn.ffn_fwd(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="the kernels take H = 768 and F a multiple of 256"):
        ffn.ffn_block_bwd(x, x, torch.zeros(4, F, device="meta"), w1, w2, scale, 0, 0.1)
    assert ffn.ffn_fwd.launches == ffn.ffn_block_bwd.launches == 0


@pytest.mark.parametrize("case", ["rank", "dtype", "ln_dtype", "rate"])
def test_rejects_bad_inputs(case):
    inp = {k: torch.from_numpy(v) for k, v in _inputs(8).items()}
    args = [inp[n] for n in ("x", "w1", "b1", "w2", "b2", "scale", "bias")]
    rate, err = 0.1, ValueError
    if case == "rank":
        args[0] = args[0][None]
    elif case == "dtype":
        args[1], err = args[1].double(), TypeError
    elif case == "ln_dtype":
        args[5], err = args[5].bfloat16(), TypeError
    elif case == "rate":
        rate = 1.0
    with pytest.raises(err):
        ffn.fused_ffn_block(*args, 0, rate)


def test_fused_ffn_gate_and_refusals():
    enc = config.BertConfig(hidden_size=128, num_attention_heads=4, intermediate_size=256)
    assert layers.fused_ffn_active(enc, "block") and layers.fused_ffn_active(enc, True)
    assert not layers.fused_ffn_active(enc, False)
    assert not layers.fused_ffn_active(enc.replace(hidden_size=64), True)
    assert not layers.fused_ffn_active(enc.replace(intermediate_size=192), "block")
    for mode in ("auto", "auto_block"):
        with pytest.raises(ValueError, match="measured on the TPU"):
            layers.fused_ffn_active(enc, mode)
        with pytest.raises(ValueError, match="measured on the TPU"):
            config.UniVLConfig.tiny(use_fused_ffn=mode)
    # hidden 64: the tiny config takes the unfused route under every mode
    model = UniVL(config.UniVLConfig.tiny(use_fused_ffn="block"))
    assert not any(layer.fused_ffn for layer in model.bert.encoder.layer)


def _no_dropout(enc, **kw):
    return enc.replace(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **kw)


@pytest.mark.parametrize("mode", [True, "block"])
def test_transformer_layer_matches_jax(mode, monkeypatch):
    """A layer on each fused route, with the unfused layer's parameter names,
    against JAX's (its Pallas kernels in interpret mode): the eval output,
    and in training mode (dropout 0) the gradients of every parameter and of
    the input."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    kw = dict(hidden_size=128, num_heads=4, intermediate_size=256, dropout_rate=0.0,
              attn_dropout_rate=0.0)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, 128).astype(np.float32)
    mask = (np.arange(24) < np.array([[24], [9]])).astype(np.int32)
    gout = rng.randn(2, 24, 128).astype(np.float32)
    jlayer = jl.TransformerLayer(use_fused_ffn=mode, **kw)
    bias = jl.additive_mask_bias(mask)
    params = jlayer.init(jax.random.key(0), x, bias, True)["params"]
    unfused = jl.TransformerLayer(use_fused_ffn=False, **kw).init(
        jax.random.key(0), x, bias, True)["params"]
    assert jax.tree.map(jnp.shape, params) == jax.tree.map(jnp.shape, unfused)
    params = jax.tree.map(np.asarray, params)

    def loss(p, xx):
        return jnp.sum(jlayer.apply({"params": p}, xx, bias, False) * gout)

    # jitted: interpret-mode kernels run eagerly can deadlock against the next
    # dispatch (a kernel's io_callback waits while the main thread dispatches)
    want_eval = jax.jit(lambda p: jlayer.apply({"params": p}, x, bias, True))(params)
    want_grads, want_dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))

    enc = _no_dropout(config.BertConfig(hidden_size=128, num_attention_heads=4,
                                        intermediate_size=256))
    layer = layers.TransformerLayer(enc, torch.float32, use_fused_ffn=mode)
    assert layer.fused_ffn and layer.attention.output.fold_epilogue == (mode == "block")
    prefix = "bert.encoder.layer.0."

    def port_names(tree):
        sd = state_dict_from_jax_params({"text": {"encoder": {"layer_0": tree}}})
        return {k[len(prefix):]: v for k, v in sd.items()}

    layer.load_state_dict(port_names(params), strict=True)
    with torch.no_grad():
        got = layer.eval()(torch.from_numpy(x), torch.from_numpy(mask).float())
    np.testing.assert_allclose(got.numpy(), np.asarray(want_eval), rtol=0, atol=2e-5)

    xt = torch.from_numpy(x).requires_grad_()
    out = layer.train()(xt, torch.from_numpy(mask).float())
    out.backward(torch.from_numpy(gout))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=0, atol=1e-4)
    want = port_names(jax.tree.map(np.asarray, want_grads))
    for name, p in layer.named_parameters():
        if name.endswith("attention.self.key.bias"):
            continue  # zero in exact arithmetic: rounding noise on both sides
        rel = float((p.grad - want[name]).norm() / want[name].norm())
        assert rel <= 1e-4, (name, rel)


B = 4


def _ft_align_cfgs(mode):
    """(JAX config, port config): tiny at hidden 128 and FFN 256 (JAX fuses
    only widths that are multiples of 128), one layer a tower, FT-Align,
    dropout 0, the FFN route ``mode``."""
    out = []
    for mod in (jax_config, config):
        c = mod.UniVLConfig.tiny(batch_size_per_device=B, train_sim_after_cross=True,
                                 use_fused_ffn=mode)
        arch = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=1)
        out.append(c.replace(bert=_no_dropout(c.bert, **arch),
                             visual=_no_dropout(c.visual, **arch),
                             cross=_no_dropout(c.cross, **arch),
                             decoder=_no_dropout(c.decoder, hidden_size=128,
                                                 intermediate_size=256)))
    return out


def _ft_align_batch(cfg):
    rng = np.random.RandomState(4)
    return {
        "input_ids": rng.randint(1, cfg.bert.vocab_size, (B, cfg.max_words)).astype(np.int32),
        "token_type_ids": np.zeros((B, cfg.max_words), np.int32),
        "attention_mask": (np.arange(cfg.max_words) < np.array([[16], [9], [2], [5]])
                           ).astype(np.int32),
        "video": rng.randn(B, cfg.max_frames, cfg.video_dim).astype(np.float32),
        "video_mask": (np.arange(cfg.max_frames) < np.array([[8], [3], [1], [6]])
                       ).astype(np.int32),
    }


@pytest.mark.parametrize("mode", [False, True, "block"], ids=["xla", "pallas", "block"])
def test_ft_align_loss_and_gradients_match_jax(mode, monkeypatch):
    """FT-Align's training forward (all B x B pairs through the cross tower,
    the max-margin loss on the [B, B] cross similarity) on each FFN route:
    the loss within 1e-5 and every gradient within 1e-4 of its norm of
    jax.value_and_grad's (JAX's Pallas kernels in interpret mode)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jcfg, cfg = _ft_align_cfgs(mode)
    batch = _ft_align_batch(jcfg)
    jm = JaxUniVL(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), batch,
                                              deterministic=True)["params"])

    def loss_fn(p):
        return jm.apply({"params": p}, batch, deterministic=False)["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = UniVL(cfg)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    assert all(layer.fused_ffn == bool(mode) for tower in (model.bert, model.visual, model.cross)
               for layer in tower.encoder.layer)
    out = model.train()({k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.Generator().manual_seed(0))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-5, atol=0)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    assert float(got["similarity_dense.weight"].norm()) > 0  # the cross tower is on the path
    # The hinge loss's gradient over a text's pairs sums to ~0, so a bias that
    # moves every pair's score alike gets a gradient that is a difference of
    # near-equal f32 sums (norms of 1e-5 to 1e-4 here, 1e-3 to 1e-2 of the
    # largest): gradients under 1e-2 of the largest norm are held to 1e-4 of that.
    floor = 1e-2 * max(float(w.norm()) for w in want.values())
    for name, g in got.items():
        if name.endswith("attention.self.key.bias"):
            assert max(float(g.norm()), float(want[name].norm())) < 1e-7, name
            continue
        rel = float((g - want[name]).norm()) / max(float(want[name].norm()), floor)
        assert rel <= 1e-4, (name, rel, float(want[name].norm()), floor)


def test_cross_similarity_pairs_every_text_with_every_video():
    """Entry (i, j) of cross_similarity is the row-aligned score of text i
    with video j, in f32."""
    _, cfg = _ft_align_cfgs("block")
    batch = {k: torch.from_numpy(v) for k, v in _ft_align_batch(cfg).items()}
    model = UniVL(cfg).eval()
    with torch.no_grad():
        seq, vis = model.encode(batch["input_ids"], batch["token_type_ids"],
                                batch["attention_mask"], batch["video"], batch["video_mask"])
        sim = model.similarity_logits(seq, vis, batch["attention_mask"], batch["video_mask"])
        i, j = torch.tensor([0, 1, 3, 2]), torch.tensor([2, 1, 0, 3])
        pairs = model.cross_similarity_pairs(seq[i], vis[j], batch["attention_mask"][i],
                                             batch["video_mask"][j])
    assert sim.shape == (B, B) and sim.dtype == torch.float32
    np.testing.assert_allclose(sim[i, j].numpy(), pairs.numpy(), rtol=0, atol=1e-5)
