"""The port's caption fine-tuning slice against the JAX package, on the CPU
in f32 at the tiny config: stage two's caption training forward (loss and
every gradient, with and without the fused LayerNorm) and its retrieval
route, the masked cross entropy and CrossEn, the YouCook2 caption dataset,
the caption metrics, the decoder's training mode, and the caption CLI
(training with per-epoch eval, eval alone, and its refusals).

With every dropout rate 0 the two compute the same function. The JAX
decoder's encoder attention (XLA, -10000 key bias) and the port's (the
training-attention plain version, -1e9) agree wherever a query has a valid
key, and every row here has one. JAX's fused LayerNorm runs its Pallas
kernels in interpret mode (``UNIVL_TPU_FUSED_LN=1``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from univl_tpu import config as jax_config
from univl_tpu.data import youcook as jax_youcook
from univl_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from univl_tpu.evals import caption_metrics as jax_metrics
from univl_tpu.models import losses as jax_losses
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import load_reference_bin, state_dict_from_jax_params
from univl_tpu_torch.cli import task_caption
from univl_tpu_torch.data import fixtures, youcook
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.evals import caption_metrics
from univl_tpu_torch.models import losses
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers

B = 4
CAPTION_KEYS = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask",
                "input_caption_ids", "output_caption_ids", "decoder_mask")


def _no_dropout(cfg):
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return cfg.replace(bert=cfg.bert.replace(**off), visual=cfg.visual.replace(**off),
                       cross=cfg.cross.replace(**off), decoder=cfg.decoder.replace(**off))


def _batch(cfg, seed: int = 0):
    """Ragged text, video and caption lengths (at least one valid key each);
    targets 0-padded past each caption, as the dataset pads them."""
    rng = np.random.RandomState(seed)
    Lw, Lv = cfg.max_words, cfg.max_frames
    words = rng.randint(2, Lw + 1, (B, 1))
    frames = rng.randint(1, Lv + 1, (B, 1))
    caps = rng.randint(1, Lw + 1, (B, 1))
    dec_mask = np.arange(Lw) < caps
    return {
        "input_ids": rng.randint(1, cfg.bert.vocab_size, (B, Lw)).astype(np.int32),
        "token_type_ids": np.zeros((B, Lw), np.int32),
        "attention_mask": (np.arange(Lw) < words).astype(np.int32),
        "video": rng.randn(B, Lv, cfg.video_dim).astype(np.float32),
        "video_mask": (np.arange(Lv) < frames).astype(np.int32),
        "input_caption_ids": np.where(dec_mask, rng.randint(1, cfg.bert.vocab_size, (B, Lw)),
                                      0).astype(np.int32),
        "output_caption_ids": np.where(dec_mask, rng.randint(1, cfg.bert.vocab_size, (B, Lw)),
                                       0).astype(np.int32),
        "decoder_mask": dec_mask.astype(np.int32),
    }


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=["caption", "retrieval"])
def stage_two(request):
    """(task, jax cfg, port cfg, jax model, jax params as numpy, batch)."""
    kw = dict(stage_two=True, task_type=request.param, batch_size_per_device=B)
    jcfg = _no_dropout(jax_config.UniVLConfig.tiny(**kw))
    cfg = _no_dropout(config.UniVLConfig.tiny(**kw))
    batch = _batch(jcfg)
    jm = JaxUniVL(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(k, batch, deterministic=True))(
        jax.random.key(0))["params"])
    if request.param == "retrieval":
        # at the seeded init every pair scores about alike (CrossEn ~ ln B), so
        # the gradients are differences of near-equal sums; a larger head
        # spreads the scores
        params["similarity_dense"]["kernel"] = params["similarity_dense"]["kernel"] * 300.0
    return request.param, jcfg, cfg, jm, params, batch


def _check_loss_and_grads(stage_two, fused_ln: bool):
    task, _, cfg, jm, params, batch = stage_two

    def loss_fn(p):
        out = jm.apply({"params": p}, batch, deterministic=False,
                       rngs={"dropout": jax.random.key(1)})
        return out["loss"], out

    (loss, jout), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = UniVL(cfg)
    # JAX's tree holds what its loss reads: the caption route's lacks the
    # similarity head, the retrieval route's the decoder
    model.load_state_dict({**model.state_dict(), **state_dict_from_jax_params(params)},
                          strict=True)
    layers.set_fused_layer_norm(model, fused_ln)
    out = model.train()(_t(batch), torch.Generator().manual_seed(0))
    out["loss"].backward()
    assert set(out) == set(jout)
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-5, atol=0, err_msg=k)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in model.named_parameters()}
    idle = set(got) - set(want)
    assert idle and all(n.startswith("similarity_dense." if task == "caption" else "decoder.")
                        for n in idle)
    assert all(float(got[n].norm()) == 0.0 for n in idle)
    got = {n: got[n] for n in want}
    # The retrieval route scores every text-video pair through the cross
    # tower and CrossEn's gradients over a row of scores sum to 0, so a
    # parameter that moves every pair alike (the cross tower's biases and
    # LayerNorms, the one token-type row) gets a difference of near-equal f32
    # sums: against an f64 run of the port, both the port's f32 and JAX's f32
    # gradients of such parameters are 5e-5 to 2e-4 off. There every
    # gradient is held to 1e-4 of the largest gradient norm.
    floor = max(float(w.norm()) for w in want.values()) if task == "retrieval" else 0.0
    for name, g in got.items():
        if name.endswith(("attention.self.key.bias", "att.key.bias", "similarity_dense.bias")):
            # zero in exact arithmetic (a per-query constant added to every
            # score leaves the softmax unchanged; CrossEn's gradients over a
            # row of scores sum to 0): both sides give rounding noise
            assert max(float(g.norm()), float(want[name].norm())) < 1e-7, name
            continue
        if float(want[name].norm()) == 0.0:  # off the loss's path (the cross pooler)
            assert float(g.norm()) == 0.0, name
            continue
        rel = float((g - want[name]).norm()) / max(float(want[name].norm()), floor)
        assert rel <= 1e-4, (name, rel)


def test_stage_two_loss_and_gradients_match_jax(stage_two):
    """Caption (decoder_loss) and retrieval (sim_loss_text_visual): the loss
    within 1e-5, every gradient within 1e-4 of its tensor's norm (retrieval:
    of the largest norm)."""
    _check_loss_and_grads(stage_two, fused_ln=False)


def test_stage_two_fused_layernorm_matches_jax_fused_layernorm(stage_two, monkeypatch):
    """The same with every LayerNorm on the fused route, on both sides: the
    port's #6 plain version against JAX's Pallas LayerNorm (interpret mode)."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("UNIVL_TPU_FUSED_LN", "1")
    with pltpu.force_tpu_interpret_mode():
        _check_loss_and_grads(stage_two, fused_ln=True)


def test_stage_two_without_caption_ids_matches_jax(stage_two):
    """A stage-two batch without caption ids: JAX adds no decoder loss
    (univl_tpu/models/univl.py:509), so the caption route's dict is the total
    alone, 0, and the retrieval route's is unchanged."""
    task, _, cfg, jm, params, batch = stage_two
    batch = {k: v for k, v in batch.items() if "caption" not in k and k != "decoder_mask"}
    jout = jax.jit(lambda p, b: jm.apply({"params": p}, b, deterministic=True))(params, batch)
    model = UniVL(cfg)
    model.load_state_dict({**model.state_dict(), **state_dict_from_jax_params(params)},
                          strict=True)
    with torch.no_grad():
        out = model.eval()(_t(batch))
    assert set(out) == set(jout) == ({"loss"} if task == "caption"
                                     else {"loss", "sim_loss_text_visual"})
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-5, atol=0, err_msg=k)


def test_masked_cross_entropy_with_padded_targets():
    """0-padded targets count (the caption convention), -1 positions do not,
    all ignored gives 0."""
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 5, 7).astype(np.float32)
    labels = np.array([[3, 1, 0, 0, 0], [6, -1, 2, -1, 0]], np.int32)
    for lab in (labels, np.full_like(labels, -1)):
        want = jax_losses.masked_cross_entropy(logits, lab)
        got = losses.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    sim = rng.randn(6, 6).astype(np.float32)
    np.testing.assert_allclose(losses.cross_en_loss(torch.from_numpy(sim)).item(),
                               float(jax_losses.cross_en_loss(sim)), rtol=1e-6)


def test_decoder_training_mode_drops_and_is_seeded():
    """With the tiny config's dropout the decoder's training loss moves with
    the generator's seed and repeats with it; the decoder's self-attention
    runs sdpa_bias with its probability dropout; eval mode drops nothing."""
    cfg = config.UniVLConfig.tiny(stage_two=True, task_type="caption", batch_size_per_device=B)
    model = UniVL(cfg)
    batch = _t(_batch(cfg, seed=1))
    got = [model.train()(batch, torch.Generator().manual_seed(s))["loss"].item()
           for s in (1, 1, 2)]
    assert got[0] == got[1] != got[2]
    with torch.no_grad():
        a = model.eval()(batch)["loss"].item()
        b = model.eval()(batch, torch.Generator().manual_seed(3))["loss"].item()
    assert a == b
    att = model.decoder.decoder.layer[0].slf_attn.att
    assert att.dropout_rate == cfg.decoder.attention_probs_dropout_prob > 0
    rng = layers.Randomness.derive(torch.Generator().manual_seed(0), "cpu")
    q = torch.randn(2, 4, 6, 8)
    bias = torch.zeros(2, 1, 6, 6)
    kept = layers.sdpa_bias(q, q, torch.ones_like(q), bias, 0.5, rng)
    assert not torch.equal(kept, layers.sdpa_bias(q, q, torch.ones_like(q), bias))


@pytest.fixture(scope="module")
def caption_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("youcook_caption")
    csv, data, feats = fixtures.make_youcook(str(d), n_videos=4, clips_per_video=3,
                                             video_dim=16, seed=5)
    return csv, data, feats, fixtures.make_vocab(str(d / "vocab.txt"))


def test_caption_dataset_matches_jax(caption_files):
    """Every key the port's caption sample has equals JAX's (the transcript
    as the encoder's text, the caption as the decoder's), and so do the
    reference captions."""
    csv, data, feats, vocab = caption_files
    kw = dict(max_words=10, max_frames=6, seed=4)
    ds = youcook.YoucookCaptionDataset(csv, data, feats, WordPieceTokenizer(vocab), **kw)
    jds = jax_youcook.YoucookCaptionDataset(csv, data, feats, JaxTokenizer(vocab), **kw)
    assert len(ds) == len(jds) == 12
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert set(got) == set(CAPTION_KEYS)
        for k in CAPTION_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert ds.reference_caption(i) == jds.reference_caption(i)


def test_caption_metrics_match_jax():
    refs = [["add the chopped onions to the pan"], ["stir well"], ["boil the pasta in water"],
            ["slice the tomato and serve"]]
    hyps = ["add onions to the pan", "stir the sauce well", "boil pasta", "serve the tomato"]
    got = caption_metrics.compute_caption_metrics(refs, hyps)
    want = jax_metrics.compute_caption_metrics(refs, hyps)
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
    assert got == pytest.approx(want, rel=1e-12)


def _cli_argv(files, out, *extra):
    csv, data, feats, vocab = files
    return ["--device", "cpu", "--vocab_file", vocab, "--train_csv", csv, "--val_csv", csv,
            "--data_path", data, "--features_path", feats, "--output_dir", out,
            "--max_words", "12", "--max_frames", "6", "--video_dim", "16", "--hidden_size", "32",
            "--num_attention_heads", "4", "--intermediate_size", "64",
            "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
            "--cross_num_hidden_layers", "1", "--decoder_num_hidden_layers", "1",
            "--batch_size", "6", "--epochs", "1", "--n_display", "1", "--lr", "1e-3",
            "--num_thread_reader", "2", "--batch_size_val", "8", *extra]


def test_cli_trains_evaluates_and_writes_a_bin(caption_files, tmp_path):
    """Two steps with --fused_ln and --do_eval: the losses, the eval's seven
    metrics and captions, a pytorch_model.bin.0 that loads strict; then
    --do_eval alone from that file gives the same captions."""
    out = str(tmp_path / "out")
    steps, best = task_caption.main(_cli_argv(caption_files, out, "--do_train", "--do_eval",
                                              "--fused_ln"))
    assert steps == 2 and best["epoch"] == 0  # 12 clips in batches of 6
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records if r["kind"] == "train"] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records if r["kind"] == "train")
    evals = [r for r in records if r["kind"] == "eval"]
    assert len(evals) == 1 and all(np.isfinite(evals[0][k]) for k in
                                   ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr"))
    with open(os.path.join(out, "args.json")) as f:
        assert json.load(f)["fused_ln"] is True
    hyps = open(os.path.join(out, "hyp.0.txt")).read().split("\n")
    assert len(hyps) == 12
    sd = load_reference_bin(os.path.join(out, "pytorch_model.bin.0"))
    assert any(k.startswith("decoder.decoder.layer.0.enc_attn") for k in sd)
    out2 = str(tmp_path / "eval")
    steps, metrics = task_caption.main(_cli_argv(
        caption_files, out2, "--do_eval", "--init_model",
        os.path.join(out, "pytorch_model.bin.0")))
    assert steps == 0 and metrics == pytest.approx({k: v for k, v in best.items()
                                                   if k != "epoch"})
    assert open(os.path.join(out2, "hyp.txt")).read().split("\n") == hyps


@pytest.mark.parametrize("extra", [["--use_mil"], ["--load_checkpoint"]])
def test_cli_runs_what_it_once_refused(caption_files, tmp_path, extra):
    """Flags this CLI once refused. ``--use_mil``: accepted and ignored, as
    JAX's driver does in stage two: the weights equal a run without it,
    bitwise. ``--load_checkpoint``: a run preempted after its first step and
    resumed writes the uninterrupted run's weights and losses, bitwise."""
    full, out = str(tmp_path / "full"), str(tmp_path / "out")
    assert task_caption.main(_cli_argv(caption_files, full, "--do_train"))[0] == 2
    if extra == ["--load_checkpoint"]:
        assert task_caption.main(_cli_argv(caption_files, out, "--do_train",
                                           "--inject_preempt_after", "1"))[0] == 1
    assert task_caption.main(_cli_argv(caption_files, out, "--do_train", *extra))[0] == 2
    want, got = (load_reference_bin(os.path.join(d, "pytorch_model.bin.0")) for d in (full, out))
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [(r["step"], r["loss"]) for r in map(json.loads, f) if r["kind"] == "train"]

    assert losses(out) == losses(full)


@pytest.mark.parametrize("extra", [
    ["--do_pretrain"], ["--zero1"], ["--remat"],
    ["--n_gpu", "2"], ["--tensor_parallel", "2"], ["--datatype", "howto100m"],
    ["--train_sim_after_cross"],
])
def test_cli_refuses_what_it_does_not_run(caption_files, tmp_path, extra, capsys):
    with pytest.raises(SystemExit) as e:
        task_caption.main(_cli_argv(caption_files, str(tmp_path / "out"), "--do_train", *extra))
    assert e.value.code == 2
    assert extra[0] in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_cli_needs_train_or_eval(caption_files, tmp_path):
    with pytest.raises(SystemExit):
        task_caption.main(_cli_argv(caption_files, str(tmp_path / "out")))
