"""The plain versions of the port's decode kernels (univl_tpu_torch/kernels/
reorder.py, decode_attention.py, vocab_topk.py) against the Pallas kernels
they replace, run in interpret mode on the CPU; and the decoder's weights
carried across from a JAX tree and a reference .bin.

On a CPU tensor each wrapper computes its plain version; the CUDA kernels
are held against those versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univl_tpu.checkpoint.torch_convert import export_torch_state_dict, save_torch_bin
from univl_tpu.config import UniVLConfig as JaxConfig
from univl_tpu.kernels.decode_attention import beam_decode_self_attention as jax_decode_attention
from univl_tpu.kernels.reorder import beam_reorder_groups_inplace as jax_reorder
from univl_tpu.kernels.vocab_topk import classify_topk as jax_classify_topk
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu_torch.checkpoint.convert import (
    init_state_dict,
    load_reference_bin,
    state_dict_from_jax_params,
)
from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.kernels.decode_attention import (
    beam_decode_self_attention,
    decode_attention_reference,
)
from univl_tpu_torch.kernels.reorder import beam_reorder_groups_inplace
from univl_tpu_torch.kernels.vocab_topk import (
    classify_topk,
    classify_topk_reference,
    pad_vocab_inputs,
    stable_topk,
)
from univl_tpu_torch.models.univl import UniVL

N, H, L, D, K = 6, 2, 8, 16, 3  # two beam groups of three


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _perm(seed):
    return np.random.RandomState(seed).randint(0, K, N).astype(np.int32)


def test_reorder_bitwise_equals_pallas():
    rng = np.random.RandomState(0)
    arrays = [rng.randn(N, H, L, D).astype(np.float32) for _ in range(3)]
    arrays.append(rng.randn(N, 5).astype(np.float32))  # any trailing shape
    prev_k = _perm(1)
    want = jax_reorder([jnp.asarray(a) for a in arrays], jnp.asarray(prev_k), K)
    got = [torch.from_numpy(a.copy()) for a in arrays]
    out = beam_reorder_groups_inplace(got, torch.from_numpy(prev_k), K)
    assert all(o is g for o, g in zip(out, got))  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert beam_reorder_groups_inplace.launches == 0  # no kernel launch on the CPU


def _decode_inputs(t, seed=0):
    rng = np.random.RandomState(seed)
    q, k_new, v_new = (rng.randn(N, H, D).astype(np.float32) for _ in range(3))
    caches = [rng.randn(N, H, L, D).astype(np.float32) for _ in range(2)]
    for c in caches:
        c[:, :, t:] = 0.0  # positions >= t are still empty
    return q, k_new, v_new, caches[0], caches[1], _perm(seed + 1)


@pytest.mark.parametrize("t", [0, 3, L - 1])
def test_decode_attention_matches_pallas(t):
    q, k_new, v_new, kc, vc, prev_k = _decode_inputs(t)
    scale = 1.0 / np.sqrt(D)
    want = jax_decode_attention(*(jnp.asarray(a) for a in (q, k_new, v_new, kc, vc, prev_k)),
                                jnp.int32(t), K, scale=scale, interpret=True, donate=False)
    args = [torch.from_numpy(a) for a in (q, k_new, v_new, kc, vc, prev_k)]
    got = beam_decode_self_attention(*args, t, K, scale=scale)
    ref = decode_attention_reference(*args, t, K, scale)
    for g, r, w in zip(got, ref, want):
        np.testing.assert_array_equal(g.numpy(), r.numpy())  # the CPU wrapper is the plain version
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert beam_decode_self_attention.launches == 0


def _vocab_inputs(V=700, Hd=32, R=5):
    rng = np.random.RandomState(3)
    h = rng.randn(R, Hd).astype(np.float32)
    w = (rng.randn(V, Hd) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    # a forced tie: three zero rows with one large bias top every row with equal
    # logits; 10 and 20 share a vocab tile, 300 is in another
    for i in (300, 10, 20):
        w[i] = 0.0
        b[i] = 20.0
    return h, w, b


def test_vocab_topk_matches_pallas_with_ties():
    h, w, b = _vocab_inputs()
    want_v, want_i = jax_classify_topk(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), 5,
                                       block_v=128, interpret=True)
    got_v, got_i = classify_topk(*(torch.from_numpy(a) for a in (h, w, b)), 5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i[:, :3].numpy(), [[10, 20, 300]] * h.shape[0])
    assert classify_topk.launches == 0


def test_vocab_padding_changes_nothing():
    h, w, b = (torch.from_numpy(a) for a in _vocab_inputs())
    wp, bp = pad_vocab_inputs(w, b)
    assert wp.shape[0] % 128 == 0 and wp.shape[0] >= w.shape[0] > wp.shape[0] - 128
    for got, want in zip(classify_topk_reference(h, wp, bp, 5), classify_topk(h, w, b, 5)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_stable_topk_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = stable_topk(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]] and vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]


@pytest.mark.parametrize("case", ["shape", "dtype", "t", "group"])
def test_decode_attention_rejects_bad_inputs(case):
    args = [torch.from_numpy(a) for a in _decode_inputs(2)]
    t, group, err = 2, K, ValueError
    if case == "shape":
        args[0] = args[0][:, :1]
    elif case == "dtype":
        args[1], err = args[1].double(), TypeError
    elif case == "t":
        t = L
    else:
        group = 4
    with pytest.raises(err):
        beam_decode_self_attention(*args, t, group, scale=0.25)


@pytest.mark.parametrize("case", ["rows", "group"])
def test_reorder_rejects_bad_inputs(case):
    a, prev_k = torch.zeros(N, 4), torch.from_numpy(_perm(0))
    with pytest.raises(ValueError):
        if case == "rows":
            beam_reorder_groups_inplace([a[:K]], prev_k, K)
        else:
            beam_reorder_groups_inplace([a], prev_k, 4)


@pytest.fixture(scope="module")
def caption_params():
    cfg = JaxConfig.tiny(stage_two=True, task_type="caption")
    B = 2
    batch = {
        "input_ids": np.ones((B, cfg.max_words), np.int32),
        "token_type_ids": np.zeros((B, cfg.max_words), np.int32),
        "attention_mask": np.ones((B, cfg.max_words), np.int32),
        "video": np.zeros((B, cfg.max_frames, cfg.video_dim), np.float32),
        "video_mask": np.ones((B, cfg.max_frames), np.int32),
        "input_caption_ids": np.ones((B, cfg.max_words), np.int32),
        "decoder_mask": np.ones((B, cfg.max_words), np.int32),
        "output_caption_ids": np.ones((B, cfg.max_words), np.int32),
    }
    jm = JaxUniVL(cfg)
    params = jax.jit(lambda key: jm.init(key, batch, deterministic=True))(jax.random.key(0))
    return jax.tree.map(np.asarray, params["params"])


_TIED = ("decoder.embeddings.word_embeddings.weight",
         "decoder.embeddings.position_embeddings.weight",
         "decoder.classifier.cls.predictions.decoder.weight")


def test_decoder_weights_carried_across(caption_params):
    got = state_dict_from_jax_params(caption_params)
    want = export_torch_state_dict(caption_params)
    assert set(_TIED) <= set(want)  # the reference stores the tied tables again
    assert sorted(got) == sorted(k for k in want if k not in _TIED)
    assert any(k.startswith("decoder.decoder.layer.1.enc_attn.att.") for k in got)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    cfg = UniVLConfig.tiny(stage_two=True, task_type="caption")
    init = init_state_dict(cfg, seed=0)
    # the seeded init also fills the FT-Align head, which the JAX training forward never builds
    assert sorted(set(init) - set(got)) == ["similarity_dense.bias", "similarity_dense.weight"]
    assert all(tuple(init[k].shape) == tuple(v.shape) for k, v in got.items())
    model = UniVL(cfg)
    model.load_state_dict({**init, **got}, strict=True)
    assert torch.equal(model.bert.embeddings.word_embeddings.weight,
                       torch.tensor(want["decoder.classifier.cls.predictions.decoder.weight"]))


def test_reference_bin_tied_tables_checked(caption_params, tmp_path):
    path = str(tmp_path / "univl.bin")
    save_torch_bin(path, caption_params)
    loaded = load_reference_bin(path)
    want = state_dict_from_jax_params(caption_params)
    assert sorted(loaded) == sorted(want)
    for k, v in want.items():
        assert torch.equal(loaded[k], v), k
    sd = torch.load(path, weights_only=True)
    sd["decoder.embeddings.position_embeddings.weight"] = (
        sd["decoder.embeddings.position_embeddings.weight"] + 1.0)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="tied"):
        load_reference_bin(path)
