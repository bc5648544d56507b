"""The port's evaluation slice against the JAX package, on the CPU in f32 at
tiny widths: the beam decoder with the classifier transform inside the vocab
top-k kernel (``fused_cls``), the MSRVTT fixtures and readers, the retrieval
metrics, ``RetrievalEvaluator`` (joint and cross similarity matrices, the
device-resident rescoring against the host tiles), the data-parallel
fan-out (``mesh=``) of the evaluator, the retrieval index and the caption
generator on two gloo ranks, spawned once through
``univl_tpu_torch.parallel.pp_replay``, against JAX's classes on a 2-device
mesh and the port in one process, and the retrieval and caption CLIs' eval
runs on MSRVTT-format files.

Weights cross over through univl_tpu_torch.checkpoint.convert. On the CPU the
port's kernels take their plain versions; the JAX package's Pallas kernels
run in interpret mode, as its own tests run them.
"""

import filecmp
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from univl_tpu.config import UniVLConfig as JaxConfig
from univl_tpu.data import fixtures as jax_fixtures
from univl_tpu.data import msrvtt as jax_msrvtt
from univl_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from univl_tpu.evals.beam import CaptionGenerator as JaxCaptionGenerator
from univl_tpu.evals.beam import make_beam_decode_fn as jax_beam
from univl_tpu.evals.beam import make_fast_beam_decode_fn as jax_fast_beam
from univl_tpu.evals.caption_metrics import compute_caption_metrics as jax_caption_metrics
from univl_tpu.evals.metrics import compute_retrieval_metrics as jax_retrieval_metrics
from univl_tpu.evals.retrieval import RetrievalEvaluator as JaxEvaluator
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from univl_tpu.serving import VideoRetrievalIndex as JaxIndex
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.cli import task_caption, task_retrieval
from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.data import fixtures, msrvtt
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.evals.beam import CaptionGenerator, make_fast_beam_decode_fn
from univl_tpu_torch.evals.metrics import compute_retrieval_metrics
from univl_tpu_torch.evals.retrieval import RetrievalEvaluator
from univl_tpu_torch.kernels.attention import fused_attention_masked
from univl_tpu_torch.kernels.vocab_topk import classify_topk
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.parallel import mesh as dp_mesh
from univl_tpu_torch.parallel import pp_replay
from univl_tpu_torch.serving.index import VideoRetrievalIndex

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


# --------------------------------------------------------------- fan-out
RANKS = 2
MODES = ("joint", "cross")
ATOL = {"joint": 1e-5, "cross": 1e-4}


INDEX_CLIPS, INDEX_BATCH, INDEX_TOP_K, INDEX_RERANKS = 9, 4, 3, (0, 5)
INDEX_QUERIES = ["whisk the eggs", "pour into the pan", "chop the garlic"]
CAPTION_BATCH, CAPTION_OPTIONS = 4, dict(beam_size=3, max_len=8)


@pytest.fixture(scope="module")
def fanout_data(retrieval, caption, tmp_path_factory):
    """What the fan-out's index and caption entries run: a vocab, ragged
    clips for the index, and a batch of encoder inputs for the captions."""
    rng = np.random.RandomState(7)
    cfg = retrieval[2].cfg
    clips = [rng.randn(rng.randint(1, cfg.max_frames + 3), cfg.video_dim).astype(np.float32)
             for _ in range(INDEX_CLIPS)]
    jcfg = JaxConfig.tiny(stage_two=True, task_type="caption")
    batch = {k: v for k, v in _batch(jcfg, CAPTION_BATCH, rng).items() if k in KEYS}
    vocab = fixtures.make_vocab(str(tmp_path_factory.mktemp("fanout_vocab") / "vocab.txt"))
    return vocab, clips, [f"v{i}" for i in range(INDEX_CLIPS)], batch


@pytest.fixture(scope="module")
def fanout(retrieval, caption, fanout_data, tmp_path_factory):
    """The evaluator (both modes), the retrieval index and the caption
    generator on two gloo ranks (``mesh=`` the ranks' group), spawned once
    in the background: ([rank r's results], the ranks' reports)."""
    _, _, model, batches = retrieval
    vocab, clips, ids, cap_batch = fanout_data
    d = tmp_path_factory.mktemp("fanout")
    torch.save(model.state_dict(), str(d / "weights.bin"))
    torch.save(caption[2].state_dict(), str(d / "caption.bin"))
    spec = {"evals": [dict(name="fanout", config=model.cfg, weights=str(d / "weights.bin"),
                           batches=batches, modes=MODES, batch_size=EVAL_BATCH,
                           cross_text_block=TB, cross_video_block=VB)],
            "indexes": [dict(name="fanout", config=model.cfg, weights=str(d / "weights.bin"),
                             vocab=vocab, batch_size=INDEX_BATCH, videos=clips, ids=ids,
                             queries=INDEX_QUERIES, top_k=INDEX_TOP_K, reranks=INDEX_RERANKS)],
            "captions": [dict(name="fanout", config=caption[2].cfg,
                              weights=str(d / "caption.bin"), vocab=vocab, batches=[cap_batch],
                              options=dict(batch_size=CAPTION_BATCH, **CAPTION_OPTIONS))]}
    torch.save(spec, str(d / "spec.pt"))
    argv = ["--spec", str(d / "spec.pt"), "--output", str(d / "out"), "--device", "cpu",
            "--n_gpu", str(RANKS)]

    def go():
        pp_replay.main(argv)
        reports = list(dp_mesh.spawn.ranks)
        return ([torch.load(str(d / "out" / f"rank{r}.pt"), weights_only=False)
                 for r in range(RANKS)], reports)

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(go)


def _jax_mesh_sims(retrieval):
    """JAX's evaluator on a 2-device mesh: {mode: (similarity, metrics)}."""
    jm, params, _, batches = retrieval
    jev = JaxEvaluator(jm, params, batch_size=EVAL_BATCH, cross_text_block=TB,
                       cross_video_block=VB, mesh=jax_make_mesh(RANKS))
    sims = {"joint": jev.joint_sim_matrix(jev.encode_dataset(iter(batches), store_full=False)),
            "cross": jev.cross_sim_matrix_device(jev.encode_dataset_device(iter(batches)))}
    return {m: (sim, jax_retrieval_metrics(sim)) for m, sim in sims.items()}


@pytest.mark.parametrize("mode", MODES)
def test_fanout_matches_jax_mesh(retrieval, fanout, mode):
    """Two ranks (10 clips, ragged encode batches padded to a multiple of 2,
    cross stripes of 2 x 3 texts) against JAX's evaluator on its 2-device
    mesh: joint within 1e-5, cross within 1e-4, the metrics equal, on every
    rank."""
    want, want_metrics = _jax_mesh_sims(retrieval)[mode]
    assert np.ptp(want) > 1e-2
    for res in fanout.result()[0]:
        got = res["evals"]["fanout"][mode]
        assert got["sim"].shape == (N_CLIPS, N_CLIPS)
        np.testing.assert_allclose(got["sim"], want, rtol=0, atol=ATOL[mode])
        metrics = {k: v for k, v in got["metrics"].items() if k in want_metrics}
        assert metrics == want_metrics and got["metrics"]["mode"] == mode


@pytest.mark.parametrize("mode", MODES)
def test_fanout_matches_one_process(retrieval, fanout, mode):
    """Two ranks against the port's evaluator in one process (no mesh) on the
    same batches: the same limits, the same metrics, and both ranks hold the
    same matrix."""
    _, ev, batches = _evaluators(retrieval)
    want = ev.evaluate(iter(batches), mode=mode)
    one, two = (r["evals"]["fanout"] for r in fanout.result()[0])
    np.testing.assert_allclose(one[mode]["sim"], ev.similarity, rtol=0, atol=ATOL[mode])
    np.testing.assert_array_equal(one[mode]["sim"], two[mode]["sim"])
    assert {k: one[mode]["metrics"][k] for k in want} == want


def _index_results(index, reranks=INDEX_RERANKS):
    return {rerank: index.search(INDEX_QUERIES, top_k=INDEX_TOP_K, rerank=rerank)
            for rerank in reranks}


def _assert_same_search(got, want, atol):
    assert len(got) == len(want) == len(INDEX_QUERIES)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w] and len(g) == INDEX_TOP_K
        np.testing.assert_allclose([x for _, x in g], [x for _, x in w], rtol=0, atol=atol)


@pytest.mark.parametrize("against", ["jax_mesh", "one_process"])
def test_index_fanout_matches(retrieval, fanout_data, fanout, against):
    """``VideoRetrievalIndex(mesh=)`` on two ranks (9 ragged clips in encode
    batches of 4, each rank encoding 2 rows) against JAX's index on its
    2-device mesh (``tests/test_serving.py``'s check) and against the port's
    index in one process: the embeddings and the visual outputs within 1e-5,
    and each search's ids equal and scores within 1e-5, with and without
    rerank, on both ranks."""
    jm, params, model, _ = retrieval
    vocab, clips, ids, _ = fanout_data
    if against == "jax_mesh":
        want = JaxIndex(jm, params, JaxTokenizer(vocab), batch_size=INDEX_BATCH, store_full=True,
                        mesh=jax_make_mesh(RANKS))
    else:
        want = VideoRetrievalIndex(model, WordPieceTokenizer(vocab), "cpu",
                                   batch_size=INDEX_BATCH, store_full=True)
    want.add(clips, ids=ids)
    results = _index_results(want)
    for res in fanout.result()[0]:
        got = res["indexes"]["fanout"]
        np.testing.assert_allclose(got["video_emb"], want.video_emb, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["vis_full"], want.vis_full, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["vm_full"], want.vm_full)
        for rerank in INDEX_RERANKS:
            _assert_same_search(got["results"][rerank], results[rerank], 1e-5)
        assert not any(got["launches"].values())  # the CPU: the kernels' plain versions


@pytest.mark.parametrize("against", ["jax_mesh", "one_process"])
def test_caption_fanout_matches(caption, fanout_data, fanout, against):
    """``CaptionGenerator(mesh=)`` on two ranks (a batch of 4, each rank
    encoding and decoding 2 rows, beam 3, 8 positions) against JAX's
    generator on its 2-device mesh (``tests/test_fast_decoder.py``'s check)
    and against the port's generator in one process: the tokens equal and
    the scores within 1e-5 on both ranks; a rank's steps are no more than
    the whole batch's."""
    jm, params, model, _ = caption
    vocab, _, _, batch = fanout_data
    if against == "jax_mesh":
        gen = JaxCaptionGenerator(jm, params, JaxTokenizer(vocab), batch_size=CAPTION_BATCH,
                                  mesh=jax_make_mesh(RANKS), **CAPTION_OPTIONS)
        sharded = {k: jax.device_put(v, gen._sharding) for k, v in batch.items()}
        seq, vis = gen._encode(params, *(sharded[k] for k in KEYS))
        tokens, scores = gen._decode(params, seq, vis, sharded["attention_mask"],
                                     sharded["video_mask"])
        want = (np.asarray(tokens), np.asarray(scores), None)
    else:
        t, sc, n = CaptionGenerator(model, WordPieceTokenizer(vocab), "cpu",
                                    **CAPTION_OPTIONS).decode(batch)
        want = (t.numpy(), sc.numpy(), n)
    for res in fanout.result()[0]:
        got = res["captions"]["fanout"]
        np.testing.assert_array_equal(got["tokens"][0].numpy(), want[0])
        np.testing.assert_allclose(got["scores"][0].numpy(), want[1], rtol=0, atol=1e-5)
        assert 1 <= got["steps"][0] <= (want[2] or CAPTION_OPTIONS["max_len"] - 1)


def test_fanout_children_import_only_the_port(fanout):
    for r in fanout.result()[1]:
        assert not {"jax", "jaxlib", "flax", "univl_tpu"} & set(r["modules"]), r["rank"]


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
