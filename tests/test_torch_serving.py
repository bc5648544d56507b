"""The port's retrieval-serving slice against the JAX package, end to end on
the CPU: the index (dense search and cross-encoder rerank; the device
functions that its CUDA graphs capture, run eagerly; a reused index after a
weight change; the fan-out's refusals), its .npz format, the HTTP server,
the port's own copies of the JAX package's configuration, tokenizer and text
encoding, and the port's independence from JAX. The index's fan-out over
ranks runs in ``tests/test_torch_eval.py``'s spawn; on the card
``chip_smoke.py`` (I1) holds the graph route against the eager one."""

import ast
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from univl_tpu import config as jax_config
from univl_tpu.data import fixtures
from univl_tpu.data import text_encoding as jax_text
from univl_tpu.data import tokenization as jax_tokenization
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.serving import VideoRetrievalIndex as JaxIndex
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.cli import pretrain, task_caption, task_retrieval
from univl_tpu_torch.data import text_encoding
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.parallel import mesh, pp_replay, replay
from univl_tpu_torch.probes import zero1_ab
from univl_tpu_torch.serving.captioning import CaptionService
from univl_tpu_torch.serving.index import RERANK_TILE, VideoRetrievalIndex

ATOL = 1e-4  # f32 on both sides
QUERIES = ["stir the soup", "slice the onion", "heat oil in a pan"]
REPO = Path(__file__).parents[1]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return fixtures.make_vocab(str(tmp_path_factory.mktemp("v") / "vocab.txt"))


@pytest.fixture(scope="module")
def pair(vocab):
    """A JAX index and the port's, over one set of weights, with one corpus added."""
    tok = WordPieceTokenizer(vocab)
    enc = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)
    jcfg = jax_config.UniVLConfig.tiny(
        train_sim_after_cross=True, bert=jax_config.BertConfig(vocab_size=len(tok), **enc))
    cfg = config.UniVLConfig.tiny(
        train_sim_after_cross=True, bert=config.BertConfig(vocab_size=len(tok), **enc))
    jm = JaxUniVL(jcfg)
    rng = np.random.RandomState(0)
    example = {
        "input_ids": np.ones((2, cfg.max_words), np.int32),
        "token_type_ids": np.zeros((2, cfg.max_words), np.int32),
        "attention_mask": np.ones((2, cfg.max_words), np.int32),
        "video": rng.randn(2, cfg.max_frames, cfg.video_dim).astype(np.float32),
        "video_mask": np.ones((2, cfg.max_frames), np.int32),
    }
    params = jm.init(jax.random.key(0), example, deterministic=True)["params"]
    model = UniVL(cfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)),
                          strict=True)
    model.eval()
    jidx = JaxIndex(jm, {"params": params}, jax_tokenization.WordPieceTokenizer(vocab),
                    batch_size=4, store_full=True)
    tidx = VideoRetrievalIndex(model, tok, "cpu", batch_size=4, store_full=True)
    vids = [rng.randn(rng.randint(1, 12), cfg.video_dim).astype(np.float32) for _ in range(10)]
    ids = [f"v{i}" for i in range(10)]
    jidx.add(vids, ids=ids)
    tidx.add(vids, ids=ids)
    return jidx, tidx, model, tok


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=ATOL)


def test_index_embeddings_match(pair):
    jidx, tidx, _, _ = pair
    np.testing.assert_allclose(tidx.video_emb, jidx.video_emb, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tidx.vis_full, jidx.vis_full, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tidx.vm_full, jidx.vm_full)


@pytest.mark.parametrize("rerank", [0, 6])
def test_search_matches_jax(pair, rerank):
    jidx, tidx, _, _ = pair
    got = tidx.search(QUERIES, top_k=4, rerank=rerank)
    _assert_same_results(got, jidx.search(QUERIES, top_k=4, rerank=rerank))
    assert all(len(r) == 4 for r in got)


@pytest.mark.parametrize("saved_by", ["jax", "torch"])
def test_npz_loads_in_the_other_package(pair, saved_by, tmp_path):
    jidx, tidx, model, tok = pair
    path = str(tmp_path / "index")  # np.savez_compressed appends .npz
    if saved_by == "jax":
        jidx.save(path)
        loaded = VideoRetrievalIndex.load(path, model, tok, "cpu", batch_size=4)
        want = jidx.search(QUERIES, top_k=3, rerank=5)
    else:
        tidx.save(path)
        loaded = JaxIndex.load(path, jidx.model, jidx.params, tok, batch_size=4)
        want = tidx.search(QUERIES, top_k=3, rerank=5)
    assert loaded.ids == tidx.ids
    _assert_same_results(loaded.search(QUERIES, top_k=3, rerank=5), want)


HOST_READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__", "cpu", "numpy")


def test_index_functions_make_no_host_read(pair, monkeypatch):
    """The three functions that the index's graphs capture (the visual and
    the text tower with their pooling, the rerank tile's cross encoder), run
    eagerly on their padded inputs with every way of reading a tensor's
    value on the host patched to raise."""
    _, tidx, _, _ = pair
    rng = np.random.RandomState(3)
    B, F, L = tidx.batch_size, tidx.max_frames, tidx.max_words
    video = torch.from_numpy(rng.randn(B, F, tidx.video_dim).astype(np.float32))
    vmask = torch.from_numpy((np.arange(F) < rng.randint(1, F + 1, (B, 1))).astype(np.int32))
    ids = torch.from_numpy(rng.randint(1, 50, (B, L)).astype(np.int32))
    amask = torch.from_numpy((np.arange(L) < rng.randint(2, L + 1, (B, 1))).astype(np.int32))
    T, M = RERANK_TILE, 5
    cand = torch.from_numpy(rng.randint(0, len(tidx), (T, M)))
    vis_t = torch.from_numpy(tidx.vis_full)[cand]
    vm_t = torch.from_numpy(tidx.vm_full)[cand]
    with torch.inference_mode(), monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, lambda *a, **k: pytest.fail("a host read"))
        vis, pooled = tidx._video_fn(video, vmask)
        seq, text = tidx._text_fn(ids, torch.zeros_like(ids), amask)
        scores = tidx._rerank_fn(seq[:1].expand(T, L, -1), vis_t, amask[:1].expand(T, L), vm_t)
    assert vis.shape == (B, F, 64) and pooled.shape == text.shape == (B, 64)
    assert scores.shape == (T, M) and torch.isfinite(scores).all()
    torch.testing.assert_close(pooled.norm(dim=-1), torch.ones(B))


def test_reused_index_reads_new_weights(vocab):
    """An index reused after its model's weights changed (in place, then
    each parameter's storage replaced: its graphs and their pool dropped)
    encodes and searches, with and without rerank, as an index built after
    the change."""
    tok = WordPieceTokenizer(vocab)
    cfg = config.UniVLConfig.tiny(train_sim_after_cross=True,
                                  bert=config.BertConfig(vocab_size=len(tok), hidden_size=64,
                                                         num_hidden_layers=1,
                                                         num_attention_heads=4,
                                                         intermediate_size=128))
    model = UniVL(cfg).eval()
    model.load_state_dict(init_state_dict(cfg, seed=1), strict=True)
    rng = np.random.RandomState(4)
    clips = [rng.randn(rng.randint(2, 10), cfg.video_dim).astype(np.float32) for _ in range(9)]
    reused = VideoRetrievalIndex(model, tok, "cpu", batch_size=4, store_full=True)
    reused.add(clips[:5])
    before = reused.search(QUERIES, top_k=3, rerank=5)
    model.load_state_dict(init_state_dict(cfg, seed=2), strict=True)
    reused.capturer.pool = "a pool"  # as the card's route leaves it
    assert not reused.check_weights() and reused.capturer.pool == "a pool"
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.clone()
    assert reused.check_weights() and not reused.check_weights()
    assert reused.capturer.pool is None  # a pool whose graphs all went takes no capture
    fresh = VideoRetrievalIndex(model, tok, "cpu", batch_size=4, store_full=True)
    fresh.add(clips[5:])
    reused.add(clips[5:])
    np.testing.assert_array_equal(reused.video_emb[5:], fresh.video_emb)
    np.testing.assert_array_equal(reused.vis_full[5:], fresh.vis_full)
    fresh.ids, fresh.video_emb = reused.ids, reused.video_emb  # one store for both
    fresh.vis_full, fresh.vm_full = reused.vis_full, reused.vm_full
    for rerank in (0, 5):
        assert reused.search(QUERIES, top_k=3, rerank=rerank) == fresh.search(
            QUERIES, top_k=3, rerank=rerank)
    assert reused.search(QUERIES, top_k=3, rerank=5) != before


def test_index_and_service_refuse_a_batch_the_ranks_do_not_divide(pair):
    """As JAX's assert, with the reason named: a mesh of 2 ranks and a batch
    of 5; the eager route refuses graphs on the CPU."""
    _, _, model, tok = pair
    two = mesh.Mesh(size=2)  # the rank count is all the check reads
    with pytest.raises(ValueError, match="batch_size 5 is not a multiple of the mesh's 2 ranks"):
        VideoRetrievalIndex(model, tok, "cpu", batch_size=5, mesh=two)
    with pytest.raises(ValueError, match="batch_size 5 is not a multiple of the mesh's 2 ranks"):
        CaptionService(model, tok, "cpu", batch_size=5, mesh=two)
    assert VideoRetrievalIndex(model, tok, "cpu", batch_size=4, mesh=two).mesh is two
    with pytest.raises(ValueError, match="CUDA graphs"):
        VideoRetrievalIndex(model, tok, "cpu", graph=True)


TINY = [
    "--video_dim", "32", "--max_words", "16", "--max_frames", "12",
    "--text_num_hidden_layers", "2", "--visual_num_hidden_layers", "1",
    "--cross_num_hidden_layers", "1", "--hidden_size", "64", "--num_attention_heads", "4",
    "--intermediate_size", "128", "--seed", "0",
]


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serve_endpoints_on_cpu(tmp_path, vocab):
    from univl_tpu_torch.cli.serve import main

    server = main(["--device", "cpu", "--mode", "retrieval", "--train_sim_after_cross",
                   "--rerank_store_full", "--vocab_file", vocab, "--output_dir",
                   str(tmp_path / "srv"), "--port", "0", "--serve_batch_size", "4"] + TINY,
                  serve_forever=False)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok", "mode": "retrieval", "indexed": 0}
        rng = np.random.RandomState(0)
        vids = [rng.randn(rng.randint(3, 10), 32).tolist() for _ in range(5)]
        code, out = _post(port, "/v1/retrieval/add",
                          {"videos": vids, "ids": [f"v{i}" for i in range(5)]})
        assert code == 200 and out["indexed"] == 5
        for rerank in (0, 4):
            code, out = _post(port, "/v1/retrieval/search",
                              {"queries": ["mix the batter", "cut"], "top_k": 3, "rerank": rerank})
            assert code == 200 and [len(r) for r in out["results"]] == [3, 3]
            scores = [h["score"] for h in out["results"][0]]
            assert scores == sorted(scores, reverse=True)
        code, out = _post(port, "/v1/retrieval/save", {"path": str(tmp_path / "idx.npz")})
        assert code == 200 and (tmp_path / "idx.npz").exists()
        code, out = _post(port, "/v1/retrieval/search", {"nope": 1})
        assert code == 400 and "error" in out
        code, out = _post(port, "/v1/caption", {"videos": vids[:1]})
        assert code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("argv", [["--mode", "caption", "--train_sim_after_cross"],
                                  ["--device", "cuda"]])
def test_serve_refuses_what_it_cannot_run(tmp_path, vocab, argv, monkeypatch):
    """A caption decoder is not built with --train_sim_after_cross; a CUDA
    device is refused where there is none."""
    from univl_tpu_torch.cli.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--device", "cpu", "--vocab_file", vocab, "--output_dir", str(tmp_path), "--port", "0"]
    with pytest.raises((ValueError, RuntimeError)):
        main(base + TINY + argv, serve_forever=False)


BLOCK_JAX = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
""")


def test_port_runs_with_jax_blocked(tmp_path, vocab):
    script = BLOCK_JAX + textwrap.dedent(f"""
        import numpy as np
        from univl_tpu_torch.config import BertConfig, UniVLConfig
        from univl_tpu_torch.data.tokenization import WordPieceTokenizer
        from univl_tpu_torch.checkpoint.convert import init_state_dict
        from univl_tpu_torch.models.univl import UniVL
        from univl_tpu_torch.serving.index import VideoRetrievalIndex

        tok = WordPieceTokenizer({vocab!r})
        enc = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
                   intermediate_size=128)
        cfg = UniVLConfig.tiny(train_sim_after_cross=True,
                               bert=BertConfig(vocab_size=len(tok), **enc))
        model = UniVL(cfg)
        model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
        idx = VideoRetrievalIndex(model.eval(), tok, "cpu", batch_size=4, store_full=True)
        rng = np.random.RandomState(0)
        idx.add([rng.randn(5, cfg.video_dim).astype(np.float32) for _ in range(6)])
        res = idx.search(["stir the soup"], top_k=2, rerank=4)
        assert len(res[0]) == 2 and all(np.isfinite(s) for _, s in res[0])
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax", "univl_tpu")]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_imports_only_the_port():
    """No module of the port (the data-, tensor- and pipeline-parallel
    ``parallel/`` modules, ``train/zero1_tp.py`` and the native tokenizer's
    ``data/native.py`` included), and not chip_smoke.py, imports the JAX
    package or JAX itself,
    at any depth of the file; every child process's entry point (the
    spawned rank's ``parallel/mesh.py:_rank_main`` and the entries it runs)
    is in the port; without a CUDA device chip_smoke.py prints no result and
    exits non-zero."""
    files = sorted((REPO / "univl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    parallel = {REPO / "univl_tpu_torch" / "parallel" / f"{m}.py"
                for m in ("mesh", "comm", "replay", "tp", "sp", "pp", "pp_replay")}
    parallel.add(REPO / "univl_tpu_torch" / "train" / "zero1_tp.py")
    parallel.add(REPO / "univl_tpu_torch" / "data" / "native.py")
    assert parallel <= set(files)
    assert mesh._rank_main.__module__ == "univl_tpu_torch.parallel.mesh"
    for entry in (task_retrieval.ENTRY, task_caption.ENTRY, pretrain.ENTRY, replay.ENTRY,
                  zero1_ab.ENTRY, pp_replay.ENTRY):
        module, fn = entry.split(":")
        assert module.startswith("univl_tpu_torch.") and (
            REPO / (module.replace(".", "/") + ".py")) in files, entry
        assert callable(getattr(importlib.import_module(module), fn)), entry
    for path in files:
        tree = ast.parse(path.read_text())
        modules = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        modules += [n.module or "" for n in ast.walk(tree)
                    if isinstance(n, ast.ImportFrom) and n.level == 0]
        roots = {m.split(".")[0] for m in modules}
        assert not roots & {"univl_tpu", "jax", "jaxlib", "flax", "optax"}, (path, sorted(roots))

    script = BLOCK_JAX + textwrap.dedent("""
        import runpy
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 1, out.stderr
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("name", ["base", "tiny"])
def test_config_copy_matches_jax(name):
    kw = dict(stage_two=True, task_type="caption", max_words=20)
    got = getattr(config.UniVLConfig, name)(**kw)
    want = getattr(jax_config.UniVLConfig, name)(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.replace(max_frames=12).validate().max_frames == 12


TEXTS = ["Stir the soup, then add salt!", "heat oil in a pan", "", "naïve café Ünïcode",
         "chop the garlic and the onion finely before frying them in butter"]


def test_tokenizer_and_text_encoding_copies_match_jax(vocab):
    tok = WordPieceTokenizer(vocab)
    jtok = jax_tokenization.WordPieceTokenizer(vocab)
    assert len(tok) == len(jtok)
    assert (tok.pad_id, tok.bos_id, tok.eos_id) == (jtok.pad_id, jtok.bos_id, jtok.eos_id)
    for text in TEXTS:
        assert tok.tokenize(text) == jtok.tokenize(text)
        ids = tok.convert_tokens_to_ids(tok.tokenize(text))
        assert ids == jtok.convert_tokens_to_ids(jtok.tokenize(text))
        assert tok.convert_ids_to_tokens(ids) == jtok.convert_ids_to_tokens(ids)
        got = text_encoding.encode_text(text, tok, 8)
        want = jax_text.encode_text(text, jtok, 8, with_mlm=False)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    clip = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    for got, want in zip(text_encoding.pad_video(clip, 8, 4), jax_text.pad_video(clip, 8, 4)):
        np.testing.assert_array_equal(got, want)
