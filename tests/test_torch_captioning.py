"""The port's caption serving (univl_tpu_torch/serving/captioning.py,
coalesce.py and the caption mode of cli/serve.py) against the JAX package,
end to end on the CPU in f32."""

import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from univl_tpu.config import BertConfig as JaxBertConfig
from univl_tpu.config import DecoderConfig as JaxDecoderConfig
from univl_tpu.config import UniVLConfig as JaxConfig
from univl_tpu.data import fixtures
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.serving import CaptionService as JaxCaptionService
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.config import BertConfig, DecoderConfig, UniVLConfig
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.serving.captioning import CaptionService
from univl_tpu_torch.serving.coalesce import CoalescingCaptionService

BEAM, MAX_LEN, BATCH = 3, 10, 4
TRANSCRIPTS = ["chop the garlic", "", "stir the soup slowly", "add salt", "mix", "boil water"]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return fixtures.make_vocab(str(tmp_path_factory.mktemp("v") / "vocab.txt"))


def _cfg_kw(config_module_classes, n_vocab):
    bert_cls, dec_cls = config_module_classes
    enc = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)
    return dict(stage_two=True, task_type="caption", bert=bert_cls(vocab_size=n_vocab, **enc),
                decoder=dec_cls(vocab_size=n_vocab, num_decoder_layers=2, **enc))


@pytest.fixture(scope="module")
def services(vocab):
    """A JAX caption service and the port's, over one set of weights."""
    tok = WordPieceTokenizer(vocab)
    jcfg = JaxConfig.tiny(**_cfg_kw((JaxBertConfig, JaxDecoderConfig), len(tok)))
    B = 2
    batch = {
        "input_ids": np.ones((B, jcfg.max_words), np.int32),
        "token_type_ids": np.zeros((B, jcfg.max_words), np.int32),
        "attention_mask": np.ones((B, jcfg.max_words), np.int32),
        "video": np.zeros((B, jcfg.max_frames, jcfg.video_dim), np.float32),
        "video_mask": np.ones((B, jcfg.max_frames), np.int32),
        "input_caption_ids": np.ones((B, jcfg.max_words), np.int32),
        "decoder_mask": np.ones((B, jcfg.max_words), np.int32),
        "output_caption_ids": np.ones((B, jcfg.max_words), np.int32),
    }
    jm = JaxUniVL(jcfg)
    params = jax.jit(lambda key: jm.init(key, batch, deterministic=True))(jax.random.key(0))
    params = jax.tree.map(np.asarray, params)
    cfg = UniVLConfig.tiny(**_cfg_kw((BertConfig, DecoderConfig), len(tok)))
    model = UniVL(cfg)
    model.load_state_dict({**init_state_dict(cfg, seed=0),
                           **state_dict_from_jax_params(params["params"])}, strict=True)
    kw = dict(beam_size=BEAM, max_len=MAX_LEN, batch_size=BATCH)
    jax_svc = JaxCaptionService(jm, params, tok, **kw)
    svc = CaptionService(model.eval(), tok, "cpu", **kw)
    assert not (svc.fused_decode or svc.fused_vocab)  # the CPU default
    return jax_svc, svc, cfg


def _videos(dim, n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(rng.randint(1, 12), dim).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("with_transcripts", [False, True])
def test_captions_match_jax_on_ragged_batches(services, with_transcripts):
    jax_svc, svc, cfg = services
    vids = _videos(cfg.video_dim)  # a full batch of 4, then a padded one of 2
    txts = TRANSCRIPTS if with_transcripts else None
    got = svc.caption(vids, transcripts=txts)
    assert got == jax_svc.caption(vids, transcripts=txts)
    assert len(got) == len(vids) and all(isinstance(c, str) for c in got)
    assert svc.generator.batches > 0 and svc.generator.steps >= svc.generator.batches


def test_coalesced_captions_equal_sequential(services):
    _, svc, cfg = services
    vids = _videos(cfg.video_dim, n=7, seed=1)
    want = [svc.caption([v], transcripts=[t])[0] for v, t in zip(vids, TRANSCRIPTS + ["x"])]
    coalescer = CoalescingCaptionService(svc)
    try:
        with ThreadPoolExecutor(max_workers=7) as ex:
            futs = [ex.submit(coalescer.caption, [v], [t])
                    for v, t in zip(vids, TRANSCRIPTS + ["x"])]
            got = [f.result(timeout=120)[0] for f in futs]
    finally:
        coalescer.close()
    assert got == want


TINY = [
    "--video_dim", "32", "--max_words", "12", "--max_frames", "8",
    "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
    "--cross_num_hidden_layers", "1", "--decoder_num_hidden_layers", "1",
    "--hidden_size", "64", "--num_attention_heads", "4", "--intermediate_size", "128",
    "--seed", "0", "--beam_size", "2", "--serve_batch_size", "4",
]


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("mode", ["caption", "both"])
def test_caption_endpoint_on_cpu(tmp_path, vocab, mode):
    """One /v1/caption round trip; --mode both also serves retrieval behind
    the same lock."""
    from univl_tpu_torch.cli.serve import main

    server = main(["--device", "cpu", "--mode", mode, "--vocab_file", vocab,
                   "--output_dir", str(tmp_path / "srv"), "--port", "0"] + TINY,
                  serve_forever=False)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            indexed = None if mode == "caption" else 0
            assert json.loads(r.read()) == {"status": "ok", "mode": mode, "indexed": indexed}
        vids = [v.tolist() for v in _videos(32, n=5)]
        code, out = _post(port, "/v1/caption", {"videos": vids})
        assert code == 200 and len(out["captions"]) == 5
        code, out = _post(port, "/v1/caption", {"videos": vids[:2], "transcripts": ["a", "b c"]})
        assert code == 200 and len(out["captions"]) == 2
        direct = server.caption_service.caption([np.asarray(v, np.float32) for v in vids[:2]],
                                                transcripts=["a", "b c"])
        assert out["captions"] == direct
        code, out = _post(port, "/v1/caption", {"videos": vids[:2], "transcripts": ["a"]})
        assert code == 400 and "transcripts" in out["error"]
        if mode == "caption":
            code, out = _post(port, "/v1/retrieval/search", {"queries": ["a"]})
            assert code == 404
        else:
            assert _post(port, "/v1/retrieval/add", {"videos": vids})[0] == 200
            code, out = _post(port, "/v1/retrieval/search",
                              {"queries": ["stir"], "top_k": 2})
            assert code == 200 and len(out["results"][0]) == 2
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert not server.caption_coalescer._worker.is_alive()  # closed with the server
