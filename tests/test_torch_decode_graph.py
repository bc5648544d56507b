"""The caption beam search over device state (univl_tpu_torch/evals/beam.py,
evals/fast_decoder.py, kernels/decode_attention.py): the step body that a
CUDA graph captures, run eagerly on the CPU in f32 at the tiny config.

A run of ``unroll`` steps reads nothing back to the host; every unroll gives
the hypotheses of one step a run, as JAX's ``UNIVL_TPU_DECODE_UNROLL`` does;
the decode-attention plain version takes the position as a tensor and
writes into given caches; a decoder reused after a weight change decodes as
a fresh one; and ``--decode_unroll`` reaches the generator from both CLIs.
On the card ``chip_smoke.py`` (C1) holds the graph replays against this
eager route bit for bit.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from univl_tpu.config import UniVLConfig as JaxConfig
from univl_tpu.evals.beam import make_fast_beam_decode_fn as jax_fast_beam
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.cli import common, serve, task_caption
from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.data import fixtures
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.evals.beam import make_fast_beam_decode_fn
from univl_tpu_torch.kernels.decode_attention import (
    beam_decode_self_attention,
    decode_attention_reference,
)
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.serving.captioning import CaptionService

B, K, BOS, EOS = 3, 4, 2, 3
MAX_LEN = 36  # cache buckets [32, 36]: U = 3 and U = 8 leave tails in both
CFG = dict(stage_two=True, task_type="caption")
ROUTES = [(False, False), (False, True), (True, False), (True, True)]  # (decode, vocab)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def carried():
    """(jax model, jax params, port model, encoder outputs and masks) over one set of weights."""
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
        "decoder_mask": np.ones((B, Lw), np.int32),
        "output_caption_ids": rng.randint(0, jcfg.decoder.vocab_size, (B, Lw)).astype(np.int32),
    }
    jm = JaxUniVL(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jm.init(key, batch, deterministic=True))(jax.random.key(0)))
    cfg = UniVLConfig.tiny(**CFG)
    model = UniVL(cfg)
    sd = init_state_dict(cfg, seed=0)
    sd.update(state_dict_from_jax_params(params["params"]))
    model.load_state_dict(sd, strict=True)
    keys = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")
    seq, vis = jax.jit(lambda p: jm.apply(p, *(batch[k] for k in keys),
                                          method=JaxUniVL.encode))(params)
    enc = (np.asarray(seq), np.asarray(vis), batch["attention_mask"], batch["video_mask"])
    return jm, params, model.eval(), enc


def _decode(model, enc, **kw):
    return make_fast_beam_decode_fn(model, K, MAX_LEN, bos_id=BOS, eos_id=EOS, **kw)(
        *map(_t, enc))


def _early_exit(model):
    """A copy of ``model`` whose [SEP] bias makes every instance end at its first step."""
    early = copy.deepcopy(model)
    with torch.no_grad():
        early.decoder.classifier.cls.predictions.bias[EOS] += 100.0
    return early


def _scheduled(steps: int, unroll: int, buckets=(32, MAX_LEN)) -> int:
    """The steps a decode of ``unroll`` steps a run takes when one step a run
    takes ``steps``: its runs (then single steps to each bucket's end) until
    the run that reaches ``steps``."""
    t = 1
    for bound in buckets:
        for n in ((unroll, 1) if unroll > 1 else (1,)):
            while t + n - 1 < bound:
                t += n
                if t - 1 >= steps:
                    return t - 1
    return t - 1


HOST_READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__")


@pytest.mark.parametrize("fused_decode,fused_vocab", ROUTES)
def test_steps_make_no_host_read(carried, monkeypatch, fused_decode, fused_vocab):
    """A run of U steps, as a graph captures it, with every way of reading a
    tensor's value on the host patched to raise."""
    _, _, model, enc = carried
    dec = make_fast_beam_decode_fn(model, K, MAX_LEN, bos_id=BOS, eos_id=EOS, unroll=3,
                                   fused_decode=fused_decode, fused_vocab=fused_vocab,
                                   fused_cls=fused_vocab)
    assert not dec.graph  # the CPU's route: the same body, eagerly
    seq, vis, am, vm = map(_t, enc)
    with torch.inference_mode():
        st = dec.state(B, am.shape[1] + vm.shape[1])
        dec.prologue(st, seq, vis, am, vm)
        t0 = st.seqs.clone()

        def refuse(*a, **k):
            raise AssertionError("a host read inside the decode steps")

        with monkeypatch.context() as m:
            for name in HOST_READS:
                m.setattr(torch.Tensor, name, refuse)
            dec._steps(st, dec.buckets[0], 0, 3)
            dec._steps(st, dec.buckets[0], 1, 1)
    assert int(st.t) == 5 and not torch.equal(st.seqs, t0)
    assert bool(st.finished) == bool(st.done.all())


@pytest.mark.parametrize("unroll", [3, 8])
@pytest.mark.parametrize("route", ROUTES + ["fused_cls"])
def test_unroll_keeps_the_hypotheses(carried, route, unroll):
    """U steps a run, single steps in each bucket's tail: the tokens and
    scores of one step a run, bitwise; the steps up to the end of the run in
    which every instance had finished."""
    _, _, model, enc = carried
    kw = (dict(fused_decode=True, fused_vocab=True, fused_cls=True) if route == "fused_cls"
          else dict(fused_decode=route[0], fused_vocab=route[1]))
    t1, s1, n1 = _decode(model, enc, **kw)
    tu, su, nu = _decode(model, enc, unroll=unroll, **kw)
    assert torch.equal(tu, t1) and torch.equal(su, s1)
    assert nu == _scheduled(n1, unroll) and n1 <= nu <= n1 + unroll - 1


@pytest.mark.parametrize("unroll", [1, 3])
@pytest.mark.parametrize("fused_decode,fused_vocab", [(False, False), (True, True)])
def test_early_exit_runs_masked_steps(carried, fused_decode, fused_vocab, unroll):
    """Every instance ends at its first step: one step a run stops after it,
    U steps a run after U, the extra steps masked no-ops."""
    _, _, model, enc = carried
    early = _early_exit(model)
    kw = dict(fused_decode=fused_decode, fused_vocab=fused_vocab)
    t1, s1, n1 = _decode(early, enc, **kw)
    tu, su, nu = _decode(early, enc, unroll=unroll, **kw)
    assert (n1, nu) == (1, _scheduled(1, unroll)) == (1, unroll)
    assert torch.equal(tu, t1) and torch.equal(su, s1)
    assert (t1[:, 0] == EOS).all()


def test_unroll_matches_jax(carried, monkeypatch):
    """JAX's KV-cache beam with UNIVL_TPU_DECODE_UNROLL=3 against the port's
    unroll=3: the same tokens, scores within 1e-4."""
    jm, params, model, enc = carried
    monkeypatch.setenv("UNIVL_TPU_DECODE_UNROLL", "3")
    want_t, want_s = jax_fast_beam(jm, K, MAX_LEN, bos_id=BOS, eos_id=EOS)(params, *enc)
    got_t, got_s, steps = _decode(model, enc, unroll=3)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-4)
    assert steps == _scheduled(_decode(model, enc)[2], 3)


@pytest.mark.parametrize("t", [0, 3, 7])
def test_decode_attention_position_tensor_and_out(t):
    """#9's plain version and its CPU wrapper with a 0-d int32 position and
    out= caches, against the int form: bitwise, the caches written into out."""
    N, H, L, D = 6, 2, 8, 16
    rng = np.random.RandomState(t)
    q, k_new, v_new = (torch.from_numpy(rng.randn(N, H, D).astype(np.float32))
                       for _ in range(3))
    kc, vc = (torch.from_numpy(rng.randn(N, H, L, D).astype(np.float32)) for _ in range(2))
    prev_k = torch.from_numpy(rng.randint(0, 3, N).astype(np.int32))
    args = (q, k_new, v_new, kc, vc, prev_k)
    want = decode_attention_reference(*args, t, 3, 0.25)
    pos = torch.tensor(t, dtype=torch.int32)
    for fn in (lambda o: decode_attention_reference(*args, pos, 3, 0.25, out=o),
               lambda o: beam_decode_self_attention(*args, pos, 3, scale=0.25, out=o)):
        out = (torch.full_like(kc, float("nan")), torch.full_like(vc, float("nan")))
        got = fn(out)
        assert got[1] is out[0] and got[2] is out[1]
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert beam_decode_self_attention.launches == 0


@pytest.mark.parametrize("case", ["dtype", "shape", "alias", "out_shape"])
def test_decode_attention_refuses_bad_positions_and_outs(case):
    N, H, L, D = 6, 2, 8, 16
    q = torch.zeros(N, H, D)
    kc, vc = torch.zeros(N, H, L, D), torch.zeros(N, H, L, D)
    t, out = torch.tensor(2, dtype=torch.int32), None
    if case == "dtype":
        t = torch.tensor(2)
    elif case == "shape":
        t = torch.tensor([2], dtype=torch.int32)
    elif case == "alias":
        out = (torch.zeros_like(kc), vc)
    else:
        out = (torch.zeros(N, H, L + 1, D), torch.zeros(N, H, L + 1, D))
    with pytest.raises(ValueError):
        beam_decode_self_attention(q, q, q, kc, vc, torch.zeros(N, dtype=torch.int32), t, 3,
                                   scale=0.25, out=out)


@pytest.mark.parametrize("fused_decode,fused_vocab", [(False, False), (True, True)])
def test_reused_decoder_reads_new_weights(carried, fused_decode, fused_vocab):
    """bf16 on the CPU, so the decoder holds casts of the weights: a decoder
    used, then reused after the weights change in place, decodes as one
    built after the change."""
    _, _, model, enc = carried
    cfg = model.cfg.replace(compute_dtype="bfloat16")
    a, b = init_state_dict(cfg, seed=1), init_state_dict(cfg, seed=2)
    m = UniVL(cfg).eval()
    m.load_state_dict(a, strict=True)
    kw = dict(fused_decode=fused_decode, fused_vocab=fused_vocab)
    enc_t = tuple(map(_t, enc))
    reused = make_fast_beam_decode_fn(m, K, MAX_LEN, bos_id=BOS, eos_id=EOS, **kw)
    before = reused(*enc_t)
    m.load_state_dict(b, strict=True)
    again = reused(*enc_t)
    fresh = make_fast_beam_decode_fn(m, K, MAX_LEN, bos_id=BOS, eos_id=EOS, **kw)(*enc_t)
    assert torch.equal(again[0], fresh[0]) and torch.equal(again[1], fresh[1])
    assert not torch.equal(before[1], fresh[1])


@pytest.mark.parametrize("route", ["unfused", "fused", "fused_cls"])
def test_refresh_covers_every_cast_from_the_start(carried, route):
    """bf16: every cast of the weights that a step reads exists when the
    decoder is built, so the refresh that a graph of the prologue captures at
    the first decode covers them all; no decode adds one."""
    _, _, model, enc = carried
    cfg = model.cfg.replace(compute_dtype="bfloat16")
    m = UniVL(cfg).eval()
    m.load_state_dict(init_state_dict(cfg, seed=1), strict=True)
    kw = {"unfused": {}, "fused": dict(fused_decode=True, fused_vocab=True),
          "fused_cls": dict(fused_decode=True, fused_vocab=True, fused_cls=True)}[route]
    dec = make_fast_beam_decode_fn(m, K, MAX_LEN, bos_id=BOS, eos_id=EOS, **kw)
    built = [id(c) for c, _ in dec.fd._copies]
    assert built  # bf16: the decoder holds casts
    dec(*map(_t, enc))
    assert [id(c) for c, _ in dec.fd._copies] == built


def test_decode_unroll_flag(tmp_path, carried):
    """--decode_unroll on both CLIs, into the caption generator; 0 refused."""
    parser = serve.add_serve_args(common.base_parser("serve"))
    out = ["--output_dir", str(tmp_path)]
    assert parser.parse_args(out + ["--decode_unroll", "4"]).decode_unroll == 4
    assert parser.parse_args(out).decode_unroll == 1
    base = out + ["--do_eval", "--vocab_file", "vocab.txt"]
    assert task_caption.parse_args(base + ["--decode_unroll", "3"]).decode_unroll == 3
    for bad in ("0", "-2"):
        with pytest.raises(SystemExit):
            parser.parse_args(out + ["--decode_unroll", bad])
        with pytest.raises(SystemExit):
            task_caption.parse_args(base + ["--decode_unroll", bad])
    _, _, model, _ = carried
    tok = WordPieceTokenizer(fixtures.make_vocab(str(tmp_path / "vocab.txt")))
    svc = CaptionService(model, tok, "cpu", beam_size=K, batch_size=2, decode_unroll=4)
    assert svc.generator.decoder.unroll == 4 and not svc.generator.decoder.graph
    with pytest.raises(ValueError):
        make_fast_beam_decode_fn(model, K, MAX_LEN, bos_id=BOS, eos_id=EOS, unroll=0)
    with pytest.raises(ValueError):
        make_fast_beam_decode_fn(model, K, MAX_LEN, bos_id=BOS, eos_id=EOS, graph=True)
