"""The port's layers and towers (univl_tpu_torch/nn, models, checkpoint)
against the flax modules, with the same weights and inputs, in f32 on the CPU.

Weights cross over through univl_tpu_torch.checkpoint.convert; on the CPU
the JAX attention takes its XLA path and the port's its plain version, which
agree wherever a query has a valid key (every row here has one).
"""

import jax
import numpy as np
import pytest
import torch

from univl_tpu.checkpoint.torch_convert import export_torch_state_dict
from univl_tpu.config import UniVLConfig
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.nn import layers as jl
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers as tl

ATOL = 1e-4  # f32 on both sides; sums differ only in order (measured ~1e-6)
B = 3


@pytest.fixture(scope="module")
def carried():
    """(cfg, batch, jax model, jax params, port model) with one set of weights."""
    cfg = UniVLConfig.tiny(train_sim_after_cross=True)
    rng = np.random.RandomState(0)
    batch = {
        "input_ids": rng.randint(1, cfg.bert.vocab_size, (B, cfg.max_words)).astype(np.int32),
        "token_type_ids": np.zeros((B, cfg.max_words), np.int32),
        "attention_mask": (np.arange(cfg.max_words) < np.array([[16], [5], [2]])).astype(np.int32),
        "video": rng.randn(B, cfg.max_frames, cfg.video_dim).astype(np.float32),
        "video_mask": (np.arange(cfg.max_frames) < np.array([[8], [3], [1]])).astype(np.int32),
    }
    jm = JaxUniVL(cfg)
    params = jm.init(jax.random.key(0), batch, deterministic=True)["params"]
    params = jax.tree.map(np.asarray, params)
    model = UniVL(config.UniVLConfig.tiny(train_sim_after_cross=True))
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return cfg, batch, jm, params, model.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_converter_matches_export_and_loads_strict(carried):
    cfg, _, _, params, _ = carried
    got = state_dict_from_jax_params(params)
    want = export_torch_state_dict(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the seeded init fills exactly the same names and shapes
    tcfg = config.UniVLConfig.tiny(train_sim_after_cross=True)
    init = init_state_dict(tcfg, seed=0)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in got.items()}
    UniVL(tcfg).load_state_dict(init, strict=True)


def test_layer_norm_tf(carried):
    _, batch, _, params, model = carried
    x = np.random.RandomState(1).randn(B, 8, 32).astype(np.float32) * 3 + 1
    want = jl.LayerNormTF().apply({"params": params["video_norm"]}, x)
    _close(model.normalize_video.visual_norm2d(_t(x)), want)


def test_gelu_erf():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(tl.gelu_erf(_t(x)), jl.gelu_erf(x))


def test_additive_mask_bias():
    m = np.array([[1, 1, 0], [0, 1, 1]], np.int32)
    _close(tl.additive_mask_bias(_t(m)), jl.additive_mask_bias(m))


def _hidden_and_mask(cfg):
    rng = np.random.RandomState(2)
    x = rng.randn(B, cfg.max_words, cfg.bert.hidden_size).astype(np.float32)
    mask = (np.arange(cfg.max_words) < np.array([[16], [7], [1]])).astype(np.int32)
    return x, mask


def _jax_stack_kw(enc):
    return dict(hidden_size=enc.hidden_size, num_heads=enc.num_attention_heads,
                intermediate_size=enc.intermediate_size, hidden_act=enc.hidden_act)


def test_transformer_layer(carried):
    cfg, _, _, params, model = carried
    x, mask = _hidden_and_mask(cfg)
    want = jl.TransformerLayer(**_jax_stack_kw(cfg.bert)).apply(
        {"params": params["text"]["encoder"]["layer_1"]}, x, jl.additive_mask_bias(mask))
    with torch.no_grad():
        got = model.bert.encoder.layer[1](_t(x), _t(mask).float())
    _close(got, want)


def test_transformer_stack(carried):
    cfg, _, _, params, model = carried
    x, mask = _hidden_and_mask(cfg)
    want = jl.TransformerStack(num_layers=cfg.visual.num_hidden_layers,
                               **_jax_stack_kw(cfg.visual)).apply(
        {"params": params["visual"]["encoder"]}, x, jl.additive_mask_bias(mask))
    with torch.no_grad():
        got = model.visual.encoder(_t(x), _t(mask).float())
    _close(got, want)


def test_text_tower(carried):
    _, batch, jm, params, model = carried
    keys = ("input_ids", "token_type_ids", "attention_mask")
    want = jm.apply({"params": params}, *(batch[k] for k in keys), method=JaxUniVL.encode_text)
    with torch.no_grad():
        got = model.encode_text(*(_t(batch[k]) for k in keys))
    _close(got, want)


def test_visual_tower(carried):
    _, batch, jm, params, model = carried
    want = jm.apply({"params": params}, batch["video"], batch["video_mask"],
                    method=JaxUniVL.encode_video)
    with torch.no_grad():
        got = model.encode_video(_t(batch["video"]), _t(batch["video_mask"]))
    _close(got, want)


def test_cross_tower_and_similarity(carried):
    cfg, batch, jm, params, model = carried
    rng = np.random.RandomState(3)
    seq = rng.randn(B, cfg.max_words, cfg.bert.hidden_size).astype(np.float32)
    vis = rng.randn(B, cfg.max_frames, cfg.visual.hidden_size).astype(np.float32)
    args = (seq, vis, batch["attention_mask"], batch["video_mask"])
    want_h, want_pooled, _ = jm.apply({"params": params}, *args,
                                      method=JaxUniVL.get_cross_output)
    want_sim = jm.apply({"params": params}, *args, method=JaxUniVL.cross_similarity_pairs)
    want_text, want_video = JaxUniVL.mean_pool(*args)
    with torch.no_grad():
        got_h, got_pooled, _ = model.get_cross_output(*map(_t, args))
        got_sim = model.cross_similarity_pairs(*map(_t, args))
    got_text, got_video = UniVL.mean_pool(*map(_t, args))
    for got, want in ((got_h, want_h), (got_pooled, want_pooled), (got_sim, want_sim),
                      (got_text, want_text), (got_video, want_video)):
        _close(got, want)
