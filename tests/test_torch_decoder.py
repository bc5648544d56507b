"""The port's caption decoder (univl_tpu_torch/nn/decoder.py,
evals/fast_decoder.py, evals/beam.py) against the JAX package, with the
same weights and inputs, in f32 on the CPU.

Weights cross over through univl_tpu_torch.checkpoint.convert. On the CPU
the port's kernels take their plain versions; the JAX package's fused decode
kernels run in Pallas interpret mode, as its own tests run them.
"""

import jax
import numpy as np
import pytest
import torch

from univl_tpu.config import UniVLConfig as JaxConfig
from univl_tpu.evals.beam import make_beam_decode_fn as jax_beam
from univl_tpu.evals.beam import make_fast_beam_decode_fn as jax_fast_beam
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.evals.beam import make_beam_decode_fn, make_fast_beam_decode_fn
from univl_tpu_torch.evals.fast_decoder import FastDecoder, encoder_bias
from univl_tpu_torch.models.univl import UniVL

B, MAX_LEN, BOS, EOS = 3, 10, 2, 3
FAST_LEN = 36  # cache buckets [32, 36]: the beam grows its cache once
CFG = dict(stage_two=True, task_type="caption")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def carried():
    """(jax model, jax params, port model, encoder outputs, masks) over one set of weights."""
    jcfg = JaxConfig.tiny(**CFG)
    rng = np.random.RandomState(0)
    Lw, Lf = jcfg.max_words, jcfg.max_frames
    batch = {
        "input_ids": rng.randint(1, jcfg.bert.vocab_size, (B, Lw)).astype(np.int32),
        "token_type_ids": np.zeros((B, Lw), np.int32),
        "attention_mask": (np.arange(Lw) < np.array([[Lw], [5], [2]])).astype(np.int32),
        "video": rng.randn(B, Lf, jcfg.video_dim).astype(np.float32),
        "video_mask": (np.arange(Lf) < np.array([[Lf], [3], [1]])).astype(np.int32),
        "input_caption_ids": rng.randint(0, jcfg.decoder.vocab_size, (B, Lw)).astype(np.int32),
        "decoder_mask": (np.arange(Lw) < np.array([[Lw], [9], [4]])).astype(np.int32),
        "output_caption_ids": rng.randint(0, jcfg.decoder.vocab_size, (B, Lw)).astype(np.int32),
    }
    jm = JaxUniVL(jcfg)
    init = jax.jit(lambda key: jm.init(key, batch, deterministic=True))
    params = jax.tree.map(np.asarray, init(jax.random.key(0)))
    cfg = UniVLConfig.tiny(**CFG)
    model = UniVL(cfg)
    # the JAX training forward never builds the FT-Align head: it stays at the seeded init
    sd = init_state_dict(cfg, seed=0)
    sd.update(state_dict_from_jax_params(params["params"]))
    model.load_state_dict(sd, strict=True)
    keys = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")
    seq, vis = jax.jit(lambda p: jm.apply(p, *(batch[k] for k in keys),
                                          method=JaxUniVL.encode))(params)
    return jm, params, model.eval(), batch, np.asarray(seq), np.asarray(vis)


def _enc(carried):
    _, _, _, batch, seq, vis = carried
    return seq, vis, batch["attention_mask"], batch["video_mask"]


def test_full_prefix_decoder_logits(carried):
    jm, params, model, batch, _, _ = carried
    args = _enc(carried) + (batch["input_caption_ids"], batch["decoder_mask"])
    want = jax.jit(lambda p, *a: jm.apply(p, *a, method=JaxUniVL.decoder_logits))(params, *args)
    with torch.no_grad():
        got = model.decoder_logits(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_step_logits_match_full_prefix(carried, fused):
    """Teacher-forced, one position at a time through the KV cache, against
    the JAX full-prefix decoder at every position (identity permutation on
    the fused path)."""
    jm, params, model, _, _, _ = carried
    L = MAX_LEN
    tokens = np.random.RandomState(1).randint(0, model.cfg.decoder.vocab_size, (B, L))
    cross, _, concat_mask = jm.apply(params, *_enc(carried), method=JaxUniVL.get_cross_output)
    want = jax.jit(lambda p, *a: jm.apply(p, *a, method=JaxUniVL.decode_step_logits))(
        params, cross, concat_mask, tokens.astype(np.int32), np.ones((B, L), np.int32))
    want = np.asarray(want)
    fd = FastDecoder(model)
    with torch.no_grad():
        enc_kv = fd.precompute_enc_kv(_t(cross))
        bias = encoder_bias(_t(concat_mask))
        cache = fd.init_cache(B, L)
        for t in range(L):
            tok = _t(tokens[:, t])
            if fused:
                identity = torch.zeros(B, dtype=torch.long)
                got, cache = fd.step_fused(tok, t, cache, enc_kv, bias, identity, 1)
            else:
                got, cache = fd.step(tok, t, cache, enc_kv, bias)
            np.testing.assert_allclose(got.numpy(), want[:, t], rtol=2e-4, atol=2e-4,
                                       err_msg=f"step {t}")


def test_full_prefix_beam_matches_jax(carried):
    jm, params, model, _, _, _ = carried
    enc = _enc(carried)
    t1, s1 = jax_beam(jm, 4, MAX_LEN, bos_id=BOS, eos_id=EOS)(params, *enc)
    t2, s2, steps = make_beam_decode_fn(model, 4, MAX_LEN, bos_id=BOS, eos_id=EOS)(
        *map(_t, enc))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(t1))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), rtol=0, atol=1e-4)
    assert steps == MAX_LEN - 1


@pytest.mark.parametrize("fused_vocab", [False, True])
@pytest.mark.parametrize("fused_decode", [False, True])
@pytest.mark.parametrize("K", [1, 5])
def test_fast_beam_matches_jax(carried, K, fused_decode, fused_vocab):
    """Same tokens as the JAX package's KV-cache beam with the same options,
    scores within 1e-4."""
    jm, params, model, _, _, _ = carried
    enc = _enc(carried)
    kw = dict(bos_id=BOS, eos_id=EOS, fused_decode=fused_decode, fused_vocab=fused_vocab)
    t1, s1 = jax_fast_beam(jm, K, FAST_LEN, **kw)(params, *enc)
    t2, s2, steps = make_fast_beam_decode_fn(model, K, FAST_LEN, **kw)(*map(_t, enc))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(t1))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), rtol=0, atol=1e-4)
    assert 1 <= steps <= FAST_LEN - 1
