"""The port's evaluation slice against the JAX package, on the CPU in f32 at
tiny widths: the beam decoder with the classifier transform inside the vocab
top-k kernel (``fused_cls``), the MSRVTT fixtures and readers, the retrieval
metrics, ``RetrievalEvaluator`` (joint and cross similarity matrices, the
device-resident rescoring against the host tiles), and the retrieval and
caption CLIs' eval runs on MSRVTT-format files.

Weights cross over through univl_tpu_torch.checkpoint.convert. On the CPU the
port's kernels take their plain versions; the JAX package's Pallas kernels
run in interpret mode, as its own tests run them.
"""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from univl_tpu.config import UniVLConfig as JaxConfig
from univl_tpu.data import fixtures as jax_fixtures
from univl_tpu.data import msrvtt as jax_msrvtt
from univl_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from univl_tpu.evals.beam import make_beam_decode_fn as jax_beam
from univl_tpu.evals.beam import make_fast_beam_decode_fn as jax_fast_beam
from univl_tpu.evals.caption_metrics import compute_caption_metrics as jax_caption_metrics
from univl_tpu.evals.metrics import compute_retrieval_metrics as jax_retrieval_metrics
from univl_tpu.evals.retrieval import RetrievalEvaluator as JaxEvaluator
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.cli import task_caption, task_retrieval
from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.data import fixtures, msrvtt
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.evals.beam import make_fast_beam_decode_fn
from univl_tpu_torch.evals.metrics import compute_retrieval_metrics
from univl_tpu_torch.evals.retrieval import RetrievalEvaluator
from univl_tpu_torch.kernels.attention import fused_attention_masked
from univl_tpu_torch.kernels.vocab_topk import classify_topk
from univl_tpu_torch.models.univl import UniVL

B, MAX_LEN, BOS, EOS = 3, 12, 2, 3
KEYS = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")
CAPTION_KEYS = KEYS + ("input_caption_ids", "output_caption_ids", "decoder_mask")


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(cfg, n, rng, with_caption=False):
    Lw, Lf = cfg.max_words, cfg.max_frames
    batch = {
        "input_ids": rng.randint(1, cfg.bert.vocab_size, (n, Lw)).astype(np.int32),
        "token_type_ids": np.zeros((n, Lw), np.int32),
        "attention_mask": (np.arange(Lw) < rng.randint(2, Lw + 1, (n, 1))).astype(np.int32),
        "video": rng.randn(n, Lf, cfg.video_dim).astype(np.float32),
        "video_mask": (np.arange(Lf) < rng.randint(1, Lf + 1, (n, 1))).astype(np.int32),
    }
    if with_caption:
        batch.update(input_caption_ids=np.ones((n, Lw), np.int32),
                     output_caption_ids=np.ones((n, Lw), np.int32),
                     decoder_mask=np.ones((n, Lw), np.int32))
    return batch


def _carry(jcfg, cfg, batch):
    """(JAX model, its params as numpy, the port's model with the same weights)."""
    jm = JaxUniVL(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jm.init(key, batch, deterministic=True))(jax.random.key(0)))
    model = UniVL(cfg)
    model.load_state_dict({**init_state_dict(cfg, seed=0),
                           **state_dict_from_jax_params(params["params"])}, strict=True)
    return jm, params, model.eval()


# --------------------------------------------------------------- fused_cls beam
@pytest.fixture(scope="module")
def caption():
    """(JAX model, params, the port's model, encoder outputs and masks)."""
    kw = dict(stage_two=True, task_type="caption")
    jcfg, cfg = JaxConfig.tiny(**kw), UniVLConfig.tiny(**kw)
    batch = _batch(jcfg, B, np.random.RandomState(0), with_caption=True)
    jm, params, model = _carry(jcfg, cfg, batch)
    seq, vis = jax.jit(lambda p: jm.apply(p, *(batch[k] for k in KEYS),
                                          method=JaxUniVL.encode))(params)
    enc = (np.asarray(seq), np.asarray(vis), batch["attention_mask"], batch["video_mask"])
    return jm, params, model, enc


@pytest.mark.parametrize("fused_decode", [False, True])
def test_fused_cls_beam_matches_jax(caption, monkeypatch, fused_decode):
    """The classifier transform inside the vocab kernel (the step returns the
    raw hidden): the same tokens as JAX's full-prefix beam and as JAX's
    KV-cache beam with UNIVL_TPU_FUSED_CLS=1 and the same options, scores
    within 1e-4."""
    jm, params, model, enc = caption
    K = 3 if fused_decode else 4
    full_t, full_s = jax_beam(jm, K, MAX_LEN, bos_id=BOS, eos_id=EOS)(params, *enc)
    monkeypatch.setenv("UNIVL_TPU_FUSED_CLS", "1")
    kw = dict(bos_id=BOS, eos_id=EOS, fused_decode=fused_decode, fused_vocab=True)
    fast_t, fast_s = jax_fast_beam(jm, K, MAX_LEN, **kw)(params, *enc)
    got_t, got_s, steps = make_fast_beam_decode_fn(model, K, MAX_LEN, fused_cls=True, **kw)(
        *map(_t, enc))
    for want_t, want_s in ((full_t, full_s), (fast_t, fast_s)):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-4)
    assert 1 <= steps <= MAX_LEN - 1
    assert classify_topk.launches == classify_topk.transform_launches == 0


def test_fused_cls_without_fused_vocab_warns(caption):
    """As JAX's UNIVL_TPU_FUSED_CLS=1 without the vocab kernel: ignored, with
    a warning, so an A/B does not compare identical programs unawares."""
    _, _, model, enc = caption
    with pytest.warns(UserWarning, match="fused_cls"):
        decode = make_fast_beam_decode_fn(model, 3, 8, bos_id=BOS, eos_id=EOS,
                                          fused_vocab=False, fused_cls=True)
    plain = make_fast_beam_decode_fn(model, 3, 8, bos_id=BOS, eos_id=EOS)
    for a, b in zip(decode(*map(_t, enc))[:2], plain(*map(_t, enc))[:2]):
        assert torch.equal(a, b)


# --------------------------------------------------------------- MSRVTT data
@pytest.mark.parametrize("layout", [False, True])
def test_make_msrvtt_is_byte_identical(tmp_path, layout):
    kw = dict(n_videos=5, sentences_per_video=4, video_dim=8, frames=7, seed=3, id_offset=2,
              caption_test_layout=layout)
    got = fixtures.make_msrvtt(str(tmp_path / "port"), **kw)
    want = jax_fixtures.make_msrvtt(str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.fixture(scope="module")
def msrvtt_files(tmp_path_factory):
    """{"retrieval": files with the videos in the train list, "caption": the
    caption test layout}, each (train csv, test csv, json, features), and a vocab."""
    d = tmp_path_factory.mktemp("msrvtt")
    kw = dict(n_videos=6, sentences_per_video=3, video_dim=16, frames=9, seed=1)
    files = {"retrieval": fixtures.make_msrvtt(str(d / "ret"), **kw),
             "caption": fixtures.make_msrvtt(str(d / "cap"), caption_test_layout=True, **kw)}
    return files, fixtures.make_vocab(str(d / "vocab.txt"))


def _readers(name, files, vocab):
    """The port's reader and JAX's over the same files and arguments."""
    train_csv, test_csv, json_path, feats = files["caption" if name == "caption_test" else
                                                  "retrieval"]
    kw = dict(max_words=10, max_frames=6, seed=4)
    tok, jtok = WordPieceTokenizer(vocab), JaxTokenizer(vocab)
    if name == "eval":
        return (msrvtt.MsrvttRetrievalEvalDataset(test_csv, feats, tok, **kw),
                jax_msrvtt.MsrvttRetrievalEvalDataset(test_csv, feats, jtok, **kw))
    if name.startswith("train"):
        kw["unfold_sentences"] = name == "train_unfold"
        return (msrvtt.MsrvttRetrievalTrainDataset(train_csv, json_path, feats, tok, **kw),
                jax_msrvtt.MsrvttRetrievalTrainDataset(train_csv, json_path, feats, jtok, **kw))
    kw["split_type"] = name.split("_")[1]
    return (msrvtt.MsrvttCaptionDataset(train_csv, json_path, feats, tok, **kw),
            jax_msrvtt.MsrvttCaptionDataset(train_csv, json_path, feats, jtok, **kw))


@pytest.mark.parametrize("name", ["eval", "train", "train_unfold", "caption_train",
                                  "caption_test"])
def test_msrvtt_readers_match_jax(msrvtt_files, name):
    """Every key the port's sample has equals JAX's, in epochs 0 and 1 (a
    training video's caption is drawn anew each epoch from the same
    per-sample rng); a caption clip's references too."""
    ds, jds = _readers(name, *msrvtt_files)
    assert len(ds) == len(jds) == {"eval": 6, "train": 6, "caption_test": 6}.get(name, 18)
    keys = CAPTION_KEYS if name.startswith("caption") else KEYS
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert set(got) == set(keys)
            for k in keys:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {i} {k}")
            if name.startswith("caption"):
                assert ds.references(i) == jds.references(i)
                assert len(ds.references(i)) == 3


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_metrics_match_jax_with_ties(seed):
    """Scores drawn from 4 values: most rows tie with their diagonal. The rank
    counts only the strictly greater entries, as in JAX."""
    sim = np.random.RandomState(seed).randint(0, 4, (30, 30)).astype(np.float32)
    assert compute_retrieval_metrics(sim) == jax_retrieval_metrics(sim)
    assert compute_retrieval_metrics(np.ones((3, 3)))["R1"] == 1.0  # all tied: rank 0
    with pytest.raises(ValueError):
        compute_retrieval_metrics(sim[:, :5])


# --------------------------------------------------------------- evaluator
N_CLIPS, EVAL_BATCH, TB, VB = 10, 4, 3, 4  # ragged encode batches and cross blocks


@pytest.fixture(scope="module")
def retrieval():
    """(JAX model, params, the port's model, the eval batches): FT-Align at
    the tiny config, the similarity head scaled up so the cross scores
    spread (at the seeded init every pair scores about alike)."""
    jcfg = JaxConfig.tiny(train_sim_after_cross=True)
    cfg = UniVLConfig.tiny(train_sim_after_cross=True)
    rng = np.random.RandomState(2)
    jm, params, _ = _carry(jcfg, cfg, _batch(jcfg, EVAL_BATCH, rng))
    p = params["params"]
    p["similarity_dense"]["kernel"] = p["similarity_dense"]["kernel"] * 300.0
    model = UniVL(cfg)
    model.load_state_dict({**init_state_dict(cfg, seed=0), **state_dict_from_jax_params(p)},
                          strict=True)
    data = _batch(jcfg, N_CLIPS, rng)
    batches = [{k: v[i:i + EVAL_BATCH] for k, v in data.items()}
               for i in range(0, N_CLIPS, EVAL_BATCH)]
    return jm, params, model.eval(), batches


def _evaluators(retrieval):
    jm, params, model, batches = retrieval
    kw = dict(batch_size=EVAL_BATCH, cross_text_block=TB, cross_video_block=VB)
    return JaxEvaluator(jm, params, **kw), RetrievalEvaluator(model, **kw), batches


def test_joint_sim_matrix_matches_jax(retrieval):
    """f32 pooled embeddings of the same encoders in another summation order:
    within 1e-5."""
    jev, ev, batches = _evaluators(retrieval)
    want = jev.joint_sim_matrix(jev.encode_dataset(iter(batches), store_full=False))
    enc = ev.encode_dataset(iter(batches), store_full=False)
    assert set(enc) == {"text_emb", "video_emb"}
    got = ev.joint_sim_matrix(enc)
    assert got.shape == (N_CLIPS, N_CLIPS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cross_sim_matrix_matches_jax(retrieval):
    """The device-resident rescoring against JAX's: the cross tower over the
    same pairs, scores scaled by the 300x head, within 1e-4."""
    jev, ev, batches = _evaluators(retrieval)
    want = jev.cross_sim_matrix_device(jev.encode_dataset_device(iter(batches)))
    got = ev.cross_sim_matrix_device(ev.encode_dataset_device(iter(batches)))
    assert got.shape == (N_CLIPS, N_CLIPS) and np.ptp(want) > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert fused_attention_masked.launches == 0


def test_device_resident_rescoring_equals_host_tiles(retrieval):
    """The same padded blocks through the same modules, on the device or
    moved there tile by tile: equal."""
    _, ev, batches = _evaluators(retrieval)
    host = ev.cross_sim_matrix(ev.encode_dataset(iter(batches), store_full=True))
    dev = ev.cross_sim_matrix_device(ev.encode_dataset_device(iter(batches)))
    np.testing.assert_array_equal(dev, host)


@pytest.mark.parametrize("mode", ["joint", "cross"])
def test_evaluate_matches_jax(retrieval, mode):
    jev, ev, batches = _evaluators(retrieval)
    model = ev.model.train()
    got = ev.evaluate(iter(batches), mode=mode)
    assert model.training  # restored after the eval-mode pass
    model.eval()
    want = jev.evaluate(iter(batches), mode=mode)
    assert got == want and got["mode"] == mode


# --------------------------------------------------------------- CLIs
def _cli_argv(files, vocab, out, *extra):
    train_csv, test_csv, json_path, feats = files
    return ["--device", "cpu", "--datatype", "msrvtt", "--vocab_file", vocab,
            "--train_csv", train_csv, "--val_csv", test_csv, "--data_path", json_path,
            "--features_path", feats, "--output_dir", out, "--max_words", "12",
            "--max_frames", "6", "--video_dim", "16", "--hidden_size", "32",
            "--num_attention_heads", "4", "--intermediate_size", "64",
            "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
            "--cross_num_hidden_layers", "1", "--decoder_num_hidden_layers", "1",
            "--batch_size", "4", "--batch_size_val", "4", "--epochs", "2", "--n_display", "1",
            "--lr", "1e-3", "--num_thread_reader", "2", *extra]


@pytest.mark.parametrize("mode", ["joint", "cross"])
def test_cli_retrieval_eval_on_msrvtt(msrvtt_files, tmp_path, mode):
    """--do_eval alone: the metrics of the seeded init, joint or (with
    --train_sim_after_cross) the cross encoder's."""
    files, vocab = msrvtt_files
    extra = ["--train_sim_after_cross"] if mode == "cross" else []
    steps, metrics = task_retrieval.main(_cli_argv(files["retrieval"], vocab,
                                                   str(tmp_path / "out"), "--do_eval", *extra))
    assert steps == 0 and metrics["mode"] == mode
    assert set(metrics) == {"R1", "R5", "R10", "MR", "MeanR", "mode", "encode_s",
                            "similarity_s"}
    assert metrics["R10"] == 1.0 and 1.0 <= metrics["MR"] <= 6.0  # 6 clips


def test_cli_retrieval_trains_and_evaluates_on_msrvtt(msrvtt_files, tmp_path):
    """--do_train --do_eval --expand_msrvtt_sentences: 18 captions in batches of
    4 (4 steps an epoch), an eval after each epoch, the best epoch by R1."""
    files, vocab = msrvtt_files
    out = str(tmp_path / "out")
    steps, best = task_retrieval.main(_cli_argv(files["retrieval"], vocab, out, "--do_train",
                                                "--do_eval", "--expand_msrvtt_sentences"))
    assert steps == 8
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    evals = [r for r in records if r["kind"] == "eval"]
    assert [r["epoch"] for r in evals] == [0, 1]
    assert best["R1"] == max(r["R1"] for r in evals)
    assert best["epoch"] == [r["R1"] for r in evals].index(best["R1"])
    assert [r for r in records if r["kind"] == "best"][0]["epoch"] == best["epoch"]


def test_cli_caption_eval_fused_cls_on_msrvtt(msrvtt_files, tmp_path):
    """--do_eval --fused_vocab --fused_cls on MSRVTT's test split: the same
    captions as without --fused_cls (f32), scored against every reference of
    a clip."""
    files, vocab = msrvtt_files
    runs = {}
    for name, extra in (("fused_cls", ["--fused_cls"]), ("plain", [])):
        out = str(tmp_path / name)
        steps, metrics = task_caption.main(_cli_argv(files["caption"], vocab, out, "--do_eval",
                                                     "--fused_vocab", *extra))
        assert steps == 0
        runs[name] = (metrics, open(os.path.join(out, "hyp.txt")).read().split("\n"))
    assert runs["fused_cls"] == runs["plain"]
    metrics, hyps = runs["fused_cls"]
    train_csv, _, json_path, feats = files["caption"]
    jds = jax_msrvtt.MsrvttCaptionDataset(train_csv, json_path, feats, JaxTokenizer(vocab),
                                          split_type="test", max_words=12, max_frames=6)
    refs = [list(jds.references(i)) for i in range(len(jds))]
    assert len(hyps) == len(refs) == 6 and all(len(r) == 3 for r in refs)
    assert metrics == pytest.approx(jax_caption_metrics(refs, hyps), rel=1e-12)
