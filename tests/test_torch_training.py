"""The port's FT-Joint training slice against the JAX package, on the CPU in
f32 at the tiny config: the training forward's loss and gradients, the
max-margin ranking loss, BertAdam and its parameter groups, the trainer with
gradient accumulation, the YouCook2 dataset, the batcher and the fixtures,
and the retrieval training CLI (whose ``pytorch_model.bin.<epoch>`` the JAX
package reads back).

Weights and gradients cross over through univl_tpu_torch.checkpoint.convert.
With every dropout rate 0 the two compute the same function; the JAX model's
XLA attention (-10000 key bias) and the port's training attention (-1e9)
agree wherever a query has a valid key, and every row here has one. With
dropout on, the two draw different bits, so the port is checked for rates
and determinism instead.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from univl_tpu import config as jax_config
from univl_tpu.checkpoint.torch_convert import convert_torch_state_dict, load_torch_bin
from univl_tpu.data import batching as jax_batching
from univl_tpu.data import fixtures as jax_fixtures
from univl_tpu.data import youcook as jax_youcook
from univl_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from univl_tpu.models import losses as jax_losses
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.parallel.mesh import make_mesh
from univl_tpu.train import optimization as jax_opt
from univl_tpu.train.trainer import Trainer as JaxTrainer
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import (
    jax_path,
    load_reference_bin,
    state_dict_from_jax_params,
)
from univl_tpu_torch.cli import task_retrieval
from univl_tpu_torch.data import batching, fixtures, youcook
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.models import losses
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer

B = 4
KEYS = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")


def _no_dropout(cfg):
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return cfg.replace(bert=cfg.bert.replace(**off), visual=cfg.visual.replace(**off),
                       cross=cfg.cross.replace(**off), decoder=cfg.decoder.replace(**off))


def _cfgs(**kw):
    """(JAX config, port config): tiny, FT-Joint, dropout 0."""
    kw = dict(batch_size_per_device=B, **kw)
    return (_no_dropout(jax_config.UniVLConfig.tiny(**kw)),
            _no_dropout(config.UniVLConfig.tiny(**kw)))


def _batch(cfg, rng, lead=()):
    shape = lead + (B,)
    n = int(np.prod(shape))
    words = rng.randint(1, cfg.max_words + 1, (n, 1))
    frames = rng.randint(1, cfg.max_frames + 1, (n, 1))
    batch = {
        "input_ids": rng.randint(1, cfg.bert.vocab_size, (n, cfg.max_words)),
        "token_type_ids": np.zeros((n, cfg.max_words)),
        "attention_mask": np.arange(cfg.max_words) < np.maximum(words, 2),
        "video": rng.randn(n, cfg.max_frames, cfg.video_dim).astype(np.float32),
        "video_mask": np.arange(cfg.max_frames) < frames,
    }
    return {k: v.reshape(shape + v.shape[1:]).astype(np.float32 if k == "video" else np.int32)
            for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def carried():
    """(jax cfg, port cfg, jax model, jax params as numpy, batch)."""
    jcfg, cfg = _cfgs()
    batch = _batch(jcfg, np.random.RandomState(0))
    jm = JaxUniVL(jcfg)
    params = jax.jit(lambda k: jm.init(k, batch, deterministic=True))(jax.random.key(0))
    return jcfg, cfg, jm, jax.tree.map(np.asarray, params["params"]), batch


def _port_model(cfg, params):
    model = UniVL(cfg)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model


def test_training_forward_loss_and_gradients_match_jax(carried):
    """Training mode through the training-attention plain version: the loss
    within 1e-5, every gradient within 1e-4 of its tensor's norm."""
    _, cfg, jm, params, batch = carried

    def loss_fn(p):
        out = jm.apply({"params": p}, batch, deterministic=False,
                       rngs={"dropout": jax.random.key(1)})
        return out["loss"], out

    (loss, jout), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = _port_model(cfg, params).train()
    out = model(_t(batch), torch.Generator().manual_seed(0))
    out["loss"].backward()
    assert set(out) == set(jout) == {"sim_loss", "loss"}
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-5, atol=0)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        if name.endswith("attention.self.key.bias"):
            # zero in exact arithmetic (a per-query constant added to every
            # score leaves the softmax unchanged): both sides give rounding noise
            assert max(float(g.norm()), float(want[name].norm())) < 1e-8, name
            continue
        rel = float((g - want[name]).norm() / want[name].norm())
        assert rel <= 1e-4, (name, rel)


def test_max_margin_ranking_loss_with_negative_weighting():
    sim = np.random.RandomState(1).randn(6, 6).astype(np.float32)
    for kw in (dict(), dict(negative_weighting=True, batch_size=3, n_pair=2, margin=0.2,
                            hard_negative_rate=0.3)):
        want = jax_losses.max_margin_ranking_loss(jnp.asarray(sim), **kw)
        got = losses.max_margin_ranking_loss(torch.from_numpy(sim), **kw)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("route", ["stage_two", "use_mil", "do_pretrain"])
def test_training_routes_not_ported_raise(carried, route):
    """The routes this file once held refused run now, each against JAX (loss
    and every gradient, tests/test_torch_pretrain.py's limits): MIL-NCE in
    stage one (``use_mil``), pretraining stage I (``do_pretrain``, the
    max-margin loss without MIL) and stage II (``stage_two`` with
    ``do_pretrain``: the five losses)."""
    from test_torch_pretrain import check_route_against_jax, pretrain_batch

    flags = {"stage_two": dict(stage_two=True, do_pretrain=True)}.get(route, {route: True})
    batch = carried[4]
    if route == "stage_two":
        batch = pretrain_batch(config.UniVLConfig.tiny(), seed=1, clips=B, pairs=1)
    out = check_route_against_jax(dict(batch_size_per_device=B, **flags), batch,
                                  spread_cross=route == "stage_two")
    assert len(out) == (6 if route == "stage_two" else 2)


def test_dropout_is_seeded_and_at_its_rate(carried):
    """With the tiny config's dropout (0.1 everywhere): the same generator
    seed gives the same loss, another seed another; eval mode drops nothing."""
    _, _, _, params, batch = carried
    model = _port_model(config.UniVLConfig.tiny(batch_size_per_device=B), params)
    losses_by_seed = [model.train()(_t(batch), torch.Generator().manual_seed(s))["loss"].item()
                      for s in (1, 1, 2)]
    assert losses_by_seed[0] == losses_by_seed[1] != losses_by_seed[2]
    with torch.no_grad():
        a = model.eval()(_t(batch))["loss"]
        b = model.eval()(_t(batch), torch.Generator().manual_seed(3))["loss"]
    assert a.item() == b.item()
    rng = layers.Randomness.derive(torch.Generator().manual_seed(0), "cpu")
    y = layers.dropout(torch.ones(200_000), 0.1, rng)
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.1) <= 5 * np.sqrt(0.1 * 0.9 / y.numel())
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))


def test_training_mode_routes_attention(monkeypatch):
    """Key-masked attention: the training kernels in training mode, the eval
    kernel in eval mode; the additive-bias path (the caption decoder's) takes
    sdpa_bias in both, with its probability dropout only in training."""
    calls = []
    monkeypatch.setattr(layers, "fused_train_attention",
                        lambda q, k, v, mask, seed, rate, heads: calls.append("train") or q)
    monkeypatch.setattr(layers, "fused_attention_masked",
                        lambda q, k, v, mask: calls.append("eval") or q)
    monkeypatch.setattr(layers, "sdpa_bias",
                        lambda q, k, v, bias, rate, rng: calls.append(("bias", rate)) or q)
    att = layers.MultiHeadAttention(16, 4, torch.float32, dropout_rate=0.1)
    x, mask = torch.randn(2, 5, 16), torch.ones(2, 5)
    rng = layers.Randomness.derive(torch.Generator().manual_seed(0), "cpu")
    att.train()(x, mask, rng=rng)
    att.eval()(x, mask)
    att.train()(x, bias=torch.zeros(2, 1, 5, 5), rng=rng)
    att.eval()(x, bias=torch.zeros(2, 1, 5, 5))
    assert calls == ["train", "eval", ("bias", 0.1), ("bias", 0.0)]


def test_bf16_gradients_stay_dense_f32(carried):
    _, cfg, _, params, batch = carried
    model = _port_model(cfg.replace(compute_dtype="bfloat16"), params).train()
    model(_t(batch), torch.Generator().manual_seed(0))["loss"].backward()
    g = model.bert.embeddings.word_embeddings.weight.grad
    assert g.dtype == torch.float32 and g.layout == torch.strided and not g.is_sparse
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_jax_path_inverts_the_converter():
    """Every leaf of a JAX tree with all four towers and both heads maps to a
    port name whose jax_path is the leaf's path."""
    jcfg = jax_config.UniVLConfig.tiny(stage_two=True, task_type="caption")
    rng = np.random.RandomState(2)
    batch = _batch(jcfg, rng)
    batch.update(input_caption_ids=batch["input_ids"], output_caption_ids=batch["input_ids"],
                 decoder_mask=batch["attention_mask"])
    shapes = jax.eval_shape(lambda k: JaxUniVL(jcfg).init(k, batch, deterministic=True),
                            jax.random.key(0))["params"]
    paths = {p: np.full(s.shape, i, np.float32)
             for i, (p, s) in enumerate(_flat(shapes).items())}
    tree = {}
    for p, v in paths.items():
        node = tree
        for part in p.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[p.split("/")[-1]] = v
    sd = state_dict_from_jax_params(tree)
    ids = {float(v.flatten()[0]) if v.numel() else None: n for n, v in sd.items()}
    for i, p in enumerate(paths):
        if i in ids:
            assert jax_path(ids[i]) == p
    assert sorted(jax_path(n) for n in sd) == sorted(p for p in paths if not p.startswith(
        ("mlm_head", "mfm_head")))


def test_param_groups_match_jax_masks(carried):
    """Decay and coef_lr leaf for leaf against univl_decay_mask and
    univl_lr_scale (normalize_video.visual_norm2d.weight undecayed)."""
    jcfg, cfg, _, params, _ = carried
    decay = _flat(jax_opt.univl_decay_mask(params))
    scale = _flat(jax_opt.univl_lr_scale(params, 0.1))
    model = _port_model(cfg, params)
    names = {id(p): n for n, p in model.named_parameters()}
    opt = make_univl_optimizer(model, lr=1e-3, t_total=10, coef_lr=0.1)
    seen = set()
    for group in opt.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            path = jax_path(name)
            seen.add(path)
            assert (group["weight_decay"] > 0) == bool(decay[path]), name
            assert group["lr_scale"] == scale[path], name
    assert seen == set(decay)
    assert not decay["video_norm/scale"]


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_bert_adam_matches_jax(carried, state_dtype):
    """Three steps with warmup (the first at lr 0) on the same parameters and
    gradients. f32 moments: the same f32 ops, within rounding (2e-7). bf16
    moments: a moment that rounds to the other bf16 neighbour moves its update
    by at most 2^-7 of it, so within lr * 2^-7 * max|update| (~3.2 with
    these moments), 3e-5 at lr 1e-3."""
    _, cfg, _, params, _ = carried
    lr, rng = 1e-3, np.random.RandomState(4)
    tx = jax_opt.make_univl_optimizer(lr=lr, t_total=10, warmup_proportion=0.1, coef_lr=0.1,
                                      state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    model = _port_model(cfg, params)
    opt = make_univl_optimizer(model, lr=lr, t_total=10, warmup_proportion=0.1, coef_lr=0.1,
                               state_dtype=state_dtype)
    update = jax.jit(tx.update)
    for step in range(3):
        grads = jax.tree.map(lambda p: (rng.randn(*p.shape) * (step + 1)).astype(np.float32),
                             params)
        upd, state = update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        tgrads = state_dict_from_jax_params(grads)
        for name, p in model.named_parameters():
            p.grad = tgrads[name]
        opt.step()
    atol = 2e-7 if state_dtype is None else 3e-5
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=atol,
                                   err_msg=name)
    assert opt.steps == 3


def test_trainer_with_accumulation_matches_jax(carried):
    """Three steps at gradient_accumulation_steps 2 against the JAX trainer on
    a one-device mesh, dropout 0: parameters within 1e-4."""
    jcfg, cfg, jm, params, _ = carried
    rng = np.random.RandomState(5)
    batches = [_batch(jcfg, rng, lead=(2,)) for _ in range(3)]
    kw = dict(lr=1e-3, t_total=3, warmup_proportion=0.1, coef_lr=0.1)
    jt = JaxTrainer(jm, jax_opt.make_univl_optimizer(**kw), make_mesh(1), grad_accum_steps=2)
    state = jt.init_state(jax.random.key(0), None, params=jax.tree.map(jnp.asarray, params))
    model = _port_model(cfg, params)
    trainer = Trainer(model, make_univl_optimizer(model, **kw), grad_accum_steps=2)
    for step, batch in enumerate(batches):
        state, jmetrics = jt.train_step(state, jt.shard_batch(batch), jax.random.key(step))
        metrics = trainer.train_step(_t(batch), step)
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_fixtures_are_byte_identical(tmp_path):
    kw = dict(n_videos=3, clips_per_video=2, video_dim=8, seed=7)
    got = fixtures.make_youcook(str(tmp_path / "port"), **kw)
    want = jax_fixtures.make_youcook(str(tmp_path / "jax"), **kw)
    got += (fixtures.make_vocab(str(tmp_path / "port" / "vocab.txt")),)
    want += (jax_fixtures.make_vocab(str(tmp_path / "jax" / "vocab.txt")),)
    for a, b in zip(got, want):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.fixture(scope="module")
def youcook_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("youcook")
    csv, data, feats = fixtures.make_youcook(str(d), n_videos=5, clips_per_video=3,
                                             video_dim=16, seed=3)
    return csv, data, feats, fixtures.make_vocab(str(d / "vocab.txt"))


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataset_and_batcher_match_jax(youcook_files, drop_last):
    """The five keys of every sample and of every update-batch (shuffled,
    grad_accum 2, the partial last chunk wrap-padded) equal JAX's."""
    csv, data, feats, vocab = youcook_files
    kw = dict(max_words=12, max_frames=6, seed=9)
    ds = youcook.YoucookRetrievalDataset(csv, data, feats, WordPieceTokenizer(vocab), **kw)
    jds = jax_youcook.YoucookRetrievalDataset(csv, data, feats, JaxTokenizer(vocab), **kw)
    assert len(ds) == len(jds) == 15
    for i in (0, 7, 14):
        got, want = ds[i], jds[i]
        assert set(got) == set(KEYS)
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k])
        assert ds.pairs[i] == jds.pairs[i]
        assert ds._rng(i).randint(1 << 30) == jds._rng(i).randint(1 << 30)
    bkw = dict(shuffle=True, seed=2, grad_accum=2, drop_last=drop_last, num_workers=2)
    b, jb = batching.Batcher(ds, 4, **bkw), jax_batching.Batcher(jds, 4, **bkw)
    assert len(b) == len(jb) == (1 if drop_last else 2)
    for epoch in (0, 1):
        pairs = list(zip(b.epoch(epoch), jb.epoch(epoch)))
        assert len(pairs) == len(b)
        for got, want in pairs:
            assert got["video"].shape == (2, 4, 6, 16)
            for k in KEYS:
                np.testing.assert_array_equal(got[k], want[k])


def _cli_argv(files, out, *extra):
    csv, data, feats, vocab = files
    return ["--do_train", "--device", "cpu", "--vocab_file", vocab, "--train_csv", csv,
            "--data_path", data, "--features_path", feats, "--output_dir", out,
            "--max_words", "12", "--max_frames", "6", "--video_dim", "16", "--hidden_size", "32",
            "--num_attention_heads", "4", "--intermediate_size", "64",
            "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
            "--batch_size", "4", "--epochs", "1", "--n_display", "1", "--lr", "1e-3",
            "--num_thread_reader", "2", *extra]


def test_cli_trains_and_writes_a_bin_jax_reads(youcook_files, tmp_path):
    out = str(tmp_path / "out")
    steps, best = task_retrieval.main(_cli_argv(youcook_files, out,
                                                "--gradient_accumulation_steps", "2"))
    assert best is None  # no --do_eval
    assert steps == 3  # 15 pairs in update-batches of 2 micro-batches of 2
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in train)
    path = os.path.join(out, "pytorch_model.bin.0")
    tree, report = convert_torch_state_dict(load_torch_bin(path))
    assert report["unknown"] == [] and report["skipped"] == []
    saved = load_reference_bin(path)
    back = state_dict_from_jax_params(tree)
    assert sorted(back) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("fused_ffn", ["block", "pallas"])
def test_cli_trains_ft_align_and_writes_a_bin_jax_reads(youcook_files, tmp_path, fused_ffn):
    """--train_sim_after_cross on each fused FFN route (hidden 128 and FFN 256,
    which the gate fuses): every step's loss finite, and the cross tower and
    FT-Align head in a .bin that JAX's converter reads with no unknown key."""
    out = str(tmp_path / "out")
    argv = _cli_argv(youcook_files, out, "--train_sim_after_cross", "--fused_ffn", fused_ffn,
                     "--cross_num_hidden_layers", "1")
    argv[argv.index("--hidden_size") + 1] = "128"
    argv[argv.index("--intermediate_size") + 1] = "256"
    assert task_retrieval.main(argv)[0] == 3  # 15 pairs in batches of 4, the last one wrapped
    train = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in train if r["kind"] == "train"] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in train if r["kind"] == "train")
    with open(os.path.join(out, "args.json")) as f:
        assert json.load(f)["fused_ffn"] == fused_ffn
    path = os.path.join(out, "pytorch_model.bin.0")
    tree, report = convert_torch_state_dict(load_torch_bin(path))
    assert report["unknown"] == [] and report["skipped"] == []
    assert "cross" in tree and "similarity_dense" in tree
    saved = load_reference_bin(path)
    assert any(k.startswith("cross.encoder.layer.0.output.LayerNorm") for k in saved)
    back = state_dict_from_jax_params(tree)
    assert sorted(back) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("extra", [["--load_checkpoint"], ["--use_mil"], ["--sampled_use_mil"]])
def test_cli_runs_what_it_once_refused(youcook_files, tmp_path, extra):
    """Flags this CLI once refused. ``--use_mil`` and ``--sampled_use_mil``:
    the JAX package's parser, finalize_args and build_config, given the same
    flags, make a config (MIL-NCE) whose eval-mode loss on the trained
    weights equals the port's. ``--load_checkpoint``: a run preempted after
    2 steps and resumed writes the uninterrupted run's weights, bitwise."""
    import logging

    from univl_tpu.cli import common as jax_common
    from univl_tpu_torch.cli import common

    out = str(tmp_path / "out")
    argv = _cli_argv(youcook_files, out, *extra)
    if extra == ["--load_checkpoint"]:
        assert task_retrieval.main(_cli_argv(youcook_files, out,
                                             "--inject_preempt_after", "2"))[0] == 2
    assert task_retrieval.main(argv)[0] == 3
    path = os.path.join(out, "pytorch_model.bin.0")
    if extra == ["--load_checkpoint"]:
        full = str(tmp_path / "full")
        task_retrieval.main(_cli_argv(youcook_files, full))
        want = load_reference_bin(os.path.join(full, "pytorch_model.bin.0"))
        got = load_reference_bin(path)
        assert all(torch.equal(got[k], want[k]) for k in want)
        return
    i = argv.index("--device")
    jargs = jax_common.finalize_args(jax_common.base_parser("test").parse_args(
        argv[:i] + argv[i + 2:] + ["--output_dir", str(tmp_path / "jax"), "--n_gpu", "1"]))
    args = task_retrieval.parse_args(argv)
    args = common.finalize_args(args)
    vocab = WordPieceTokenizer(youcook_files[3])
    jcfg = jax_common.build_config(jargs, task_type="retrieval", vocab_size=len(vocab))
    cfg = common.build_config(args, torch.device("cpu"), vocab_size=len(vocab))
    assert jcfg.use_mil and cfg.use_mil and cfg.batch_size_per_device == jcfg.batch_size_per_device
    ds = youcook.YoucookRetrievalDataset(*youcook_files[:3], vocab, max_words=12, max_frames=6)
    batch = next(batching.Batcher(ds, cfg.batch_size_per_device, shuffle=False).epoch(0))
    jm = JaxUniVL(jcfg)
    jargs.init_model = path
    params = jax_common.load_init_params(jargs, jm, batch, logging.getLogger("test"))
    want = jm.apply({"params": params}, batch, deterministic=True)["loss"]
    model = UniVL(cfg)
    model.load_state_dict(load_reference_bin(path), strict=True)
    got = model.eval()({k: torch.from_numpy(v) for k, v in batch.items()})["loss"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)


@pytest.mark.parametrize("extra", [
    ["--do_pretrain"], ["--zero1"], ["--remat"], ["--do_pretrain", "--stage_two"],
    ["--n_gpu", "2"], ["--tensor_parallel", "2"], ["--datatype", "howto100m"],
    ["--fused_ffn", "auto"], ["--fused_ffn", "auto_block"],  # TPU-measured row thresholds
    ["--train_attention", "pallas"],  # a TPU-only knob: not a flag of the port
])
def test_cli_refuses_what_it_does_not_run(youcook_files, tmp_path, extra, capsys):
    with pytest.raises(SystemExit) as e:
        task_retrieval.main(_cli_argv(youcook_files, str(tmp_path / "out"), *extra))
    assert e.value.code == 2
    assert extra[0] in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_cli_needs_do_train(youcook_files, tmp_path):
    """Neither --do_train nor --do_eval: nothing to run."""
    argv = [a for a in _cli_argv(youcook_files, str(tmp_path / "out")) if a != "--do_train"]
    with pytest.raises(SystemExit):
        task_retrieval.main(argv)


class _StubTrainer:
    """One step per batch, a fixed loss; the model, and with the optimizer
    the train state, are saved each epoch."""

    def __init__(self):
        self.model = torch.nn.Linear(1, 1)
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=0.0)

    def train_step(self, batch, global_step):
        return {"loss": torch.tensor(1.0)}


class _StubBatcher:
    def epoch(self, epoch, start_batch=0):
        yield {"x": np.zeros((1, 1), np.float32)}


@pytest.mark.parametrize("select_sign", [1.0, -1.0])
def test_best_epoch_skips_a_nan_metric(tmp_path, select_sign):
    """As JAX's run_train_epochs: the best starts at -inf and a NaN metric
    never beats it, so the first epoch's NaN is not kept as the best; with
    select_sign -1 the smaller value wins."""
    from types import SimpleNamespace

    from univl_tpu_torch.cli import common

    scores = iter([float("nan"), 0.25, 0.5])
    args = SimpleNamespace(epochs=3, gradient_accumulation_steps=1, batch_size=1,
                           n_display=1, output_dir=str(tmp_path), load_checkpoint=False,
                           no_preempt_checkpoint=False)
    steps, best = common.run_train_epochs(
        args, _StubTrainer(), _StubBatcher(), common.get_logger(None), torch.device("cpu"),
        eval_fn=lambda epoch: {"R1": next(scores)}, select_key="R1", select_sign=select_sign)
    assert steps == 3
    assert best == ({"R1": 0.5, "epoch": 2} if select_sign > 0 else {"R1": 0.25, "epoch": 1})
