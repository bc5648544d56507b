"""The port's pretraining slice against the JAX package, on the CPU in f32 at
the tiny config: the HowTo100M fixtures, the masking, the HowTo100M reader,
MIL-NCE and the masked-frame NCE, the stage I (MIL) and stage II (five
losses) training forward with every gradient, the parameter sets, the
pretraining heads' conversion both ways, and a two-stage run of
``univl_tpu_torch.cli.pretrain`` whose files the JAX package reads.

With every dropout rate 0 the two compute the same function; the JAX
model's XLA attention (-10000 key bias) and the port's training attention
(-1e9) agree wherever a query has a valid key, and every row here has one.
"""

import filecmp
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from univl_tpu import config as jax_config
from univl_tpu.checkpoint.torch_convert import (
    convert_torch_state_dict,
    export_torch_state_dict,
    load_torch_bin,
)
from univl_tpu.data import fixtures as jax_fixtures
from univl_tpu.data import howto100m as jax_howto100m
from univl_tpu.data import text_encoding as jax_te
from univl_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from univl_tpu.models import losses as jax_losses
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import (
    jax_path,
    load_reference_bin,
    state_dict_from_jax_params,
)
from univl_tpu_torch.cli import pretrain
from univl_tpu_torch.data import fixtures, howto100m
from univl_tpu_torch.data import text_encoding as te
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.models import losses
from univl_tpu_torch.models.univl import UniVL

B, P = 3, 2  # clips a micro-batch, pairs a clip
STAGE_ONE_KEYS = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")


def _no_dropout(cfg):
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return cfg.replace(bert=cfg.bert.replace(**off), visual=cfg.visual.replace(**off),
                       cross=cfg.cross.replace(**off), decoder=cfg.decoder.replace(**off))


def pretrain_batch(cfg, seed: int = 0, clips: int = B, pairs: int = P) -> dict:
    """A stage-II batch of [clips, pairs, ...] arrays: ragged text, video and
    caption lengths (two valid tokens and one valid frame at least), about
    30% of the valid tokens and frames masked with their labels."""
    rng = np.random.RandomState(seed)
    Lw, Lv, D, V = cfg.max_words, cfg.max_frames, cfg.video_dim, cfg.bert.vocab_size
    s = (clips, pairs)
    am = (np.arange(Lw) < rng.randint(3, Lw + 1, s + (1,))).astype(np.int32)
    vm = (np.arange(Lv) < rng.randint(1, Lv + 1, s + (1,))).astype(np.int32)
    ids = rng.randint(5, V, s + (Lw,)).astype(np.int32) * am
    video = rng.randn(*s, Lv, D).astype(np.float32) * vm[..., None]
    labels = np.where((rng.rand(*s, Lw) < 0.3) & (am == 1), ids, -1).astype(np.int32)
    frames = np.where((rng.rand(*s, Lv) < 0.3) & (vm == 1), np.arange(Lv), -1).astype(np.int32)
    dec = np.arange(Lw) < rng.randint(1, Lw + 1, s + (1,))
    return {
        "input_ids": ids, "token_type_ids": np.zeros(s + (Lw,), np.int32),
        "attention_mask": am, "video": video, "video_mask": vm,
        "masked_text": np.where(labels >= 0, 4, ids).astype(np.int32), "token_labels": labels,
        "masked_video": np.where(frames[..., None] >= 0, 0.0, video).astype(np.float32),
        "video_labels_index": frames,
        "input_caption_ids": np.where(dec, rng.randint(1, V, s + (Lw,)), 0).astype(np.int32),
        "output_caption_ids": np.where(dec, rng.randint(1, V, s + (Lw,)), 0).astype(np.int32),
        "decoder_mask": dec.astype(np.int32),
    }


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# zero in exact arithmetic: a per-query constant added to every score leaves
# the softmax unchanged, and CrossEn's gradients over a row of scores sum to 0
ZERO_GRADS = ("attention.self.key.bias", "att.key.bias", "similarity_dense.bias")


def check_route_against_jax(kw: dict, batch: dict, spread_cross: bool = False) -> dict:
    """The training forward of the tiny config ``kw`` at dropout 0 on
    ``batch``, port against JAX: each loss within 1e-5 rel, every gradient
    within 1e-4 of its norm (of the largest gradient's norm where the cross
    similarity's CrossEn makes the cross tower's gradients differences of
    near-equal sums; the zero-gradient parameters absolutely); the parameter
    sets equal. ``spread_cross`` scales the similarity head so the pairs'
    scores differ. Returns the port's losses."""
    jcfg = _no_dropout(jax_config.UniVLConfig.tiny(**kw))
    cfg = _no_dropout(config.UniVLConfig.tiny(**kw))
    jm = JaxUniVL(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(k, batch, deterministic=True))(
        jax.random.key(0))["params"])
    if spread_cross:
        params["similarity_dense"]["kernel"] = params["similarity_dense"]["kernel"] * 300.0

    def loss_fn(p):
        out = jm.apply({"params": p}, batch, deterministic=False,
                       rngs={"dropout": jax.random.key(1)})
        return out["loss"], out

    (_, jout), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = UniVL(cfg)
    sd = state_dict_from_jax_params(params)
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd, strict=True)
    out = model.train()(_t(batch), torch.Generator().manual_seed(0))
    out["loss"].backward()
    assert set(out) == set(jout)
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-5, atol=0, err_msg=k)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    floor = max(float(w.norm()) for w in want.values()) if spread_cross else 0.0
    for name, g in got.items():
        if name.endswith(ZERO_GRADS):
            assert max(float(g.norm()), float(want[name].norm())) < 1e-6 * max(floor, 1.0), name
            continue
        if float(want[name].norm()) == 0.0:  # off the loss's path (the cross pooler)
            assert float(g.norm()) == 0.0, name
            continue
        rel = float((g - want[name]).norm()) / max(float(want[name].norm()), floor)
        assert rel <= 1e-4, (name, rel)
    return {k: v.item() for k, v in out.items()}


@pytest.mark.parametrize("stage", ["stage_one_mil", "stage_one_max_margin", "stage_two"])
def test_pretrain_forward_and_gradients_match_jax(stage):
    """Stage I (MIL-NCE, and the max-margin loss without MIL) and stage II
    (the five losses, MIL-NCE on the joint similarity)."""
    kw = dict(do_pretrain=True, n_pair=P, batch_size_per_device=B,
              use_mil=stage != "stage_one_max_margin", stage_two=stage == "stage_two")
    batch = pretrain_batch(config.UniVLConfig.tiny())
    if stage != "stage_two":
        batch = {k: batch[k] for k in STAGE_ONE_KEYS}
    out = check_route_against_jax(kw, batch, spread_cross=stage == "stage_two")
    want = ({"alm_loss", "nce_loss", "sim_loss_joint", "decoder_loss", "sim_loss_text_visual"}
            if stage == "stage_two" else {"sim_loss"})
    assert set(out) == want | {"loss"}


@pytest.mark.parametrize("flags", [
    dict(do_pretrain=True, use_mil=True, n_pair=P),  # stage I
    dict(do_pretrain=True, use_mil=True, n_pair=P, stage_two=True),  # stage II
    dict(train_sim_after_cross=True),  # FT-Align fine-tuning
    dict(stage_two=True, use_mil=True, task_type="caption"),  # --use_mil, ignored there
], ids=["stage_one", "stage_two", "ft_align", "caption_use_mil"])
def test_parameter_sets_match_jax(flags):
    """The port builds the parameters JAX's init makes, under the converted
    names: the heads only in stage II of pretraining. (JAX's init makes only
    what its forward reads: the caption route's lacks the similarity head,
    which the port builds with the cross tower.)"""
    jcfg = jax_config.UniVLConfig.tiny(batch_size_per_device=B, **flags)
    batch = pretrain_batch(jcfg)
    if not (flags.get("stage_two") and flags.get("do_pretrain")):
        batch = {k: v for k, v in batch.items() if k in STAGE_ONE_KEYS or "caption" in k
                 or k == "decoder_mask"}
    shapes = jax.eval_shape(lambda k: JaxUniVL(jcfg).init(k, batch, deterministic=True),
                            jax.random.key(0))["params"]
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax_params(tree).items()}
    model = UniVL(config.UniVLConfig.tiny(batch_size_per_device=B, **flags), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    idle = set(got) - set(want)
    assert idle == ({"similarity_dense.weight", "similarity_dense.bias"}
                    if flags.get("task_type") == "caption" else set())
    assert {k: got[k] for k in want} == want
    heads = any(k.startswith(("cls.", "cls_visual.")) for k in got)
    assert heads == bool(flags.get("do_pretrain") and flags.get("stage_two"))


def test_heads_convert_both_ways():
    """A stage-II tree through the port's converter equals JAX's export on
    every name the port holds; the export's tied copies (the decoder's
    tables, the masked-language head's weight, the masked-frame head's
    feature projection) are what load_reference_bin checks and drops; the
    port's names map back to JAX's paths."""
    jcfg = jax_config.UniVLConfig.tiny(do_pretrain=True, use_mil=True, n_pair=P, stage_two=True,
                                       batch_size_per_device=B)
    batch = pretrain_batch(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: JaxUniVL(jcfg).init(k, batch, deterministic=True))(jax.random.key(3))["params"])
    ours = state_dict_from_jax_params(params)
    theirs = export_torch_state_dict(params)
    tied = {"decoder.embeddings.word_embeddings.weight",
            "decoder.embeddings.position_embeddings.weight",
            "decoder.classifier.cls.predictions.decoder.weight",
            "cls.predictions.decoder.weight", "cls_visual.predictions.weight"}
    assert set(theirs) - set(ours) == tied
    assert set(ours) == set(theirs) - tied
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    for k in ours:
        if k.startswith(("cls.", "cls_visual.")):
            path = jax_path(k).split("/")
            leaf = params
            for p in path:
                leaf = leaf[p]
            want = leaf.T if path[-1] == "kernel" else leaf
            np.testing.assert_array_equal(ours[k].numpy(), want, err_msg=k)
    tree, report = convert_torch_state_dict({k: v.numpy() for k, v in ours.items()})
    assert report["unknown"] == [] and {"mlm_head", "mfm_head"} <= set(tree)


def test_reference_bin_heads_round_trip(tmp_path):
    """JAX's stage-II export as a reference .bin, tied copies and all: the
    port reads it with the heads (the tied copies checked and dropped), and
    a copy whose tied masked-frame weight differs is refused."""
    jcfg = jax_config.UniVLConfig.tiny(do_pretrain=True, use_mil=True, n_pair=P, stage_two=True,
                                       batch_size_per_device=B)
    batch = pretrain_batch(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: JaxUniVL(jcfg).init(k, batch, deterministic=True))(jax.random.key(4))["params"])
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(params).items()}
    path = str(tmp_path / "stage2.bin")
    torch.save(sd, path)
    got = load_reference_bin(path)
    want = state_dict_from_jax_params(params)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    sd["cls_visual.predictions.weight"] = sd["cls_visual.predictions.weight"] + 1.0
    torch.save(sd, path)
    with pytest.raises(ValueError, match="cls_visual.predictions.weight"):
        load_reference_bin(path)


def test_milnce_and_mfm_nce_match_jax():
    rng = np.random.RandomState(5)
    sim = rng.randn(B * 3, B * 3).astype(np.float32)
    for n_pair, s in ((3, sim), (1, sim[:B, :B])):
        want = jax_losses.milnce_loss(jax.numpy.asarray(s), B, n_pair)
        got = losses.milnce_loss(torch.from_numpy(s), B, n_pair)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)
    scores = rng.randn(B, 7, 16).astype(np.float32)
    video = rng.randn(B, 7, 16).astype(np.float32)
    mask = (np.arange(7) < rng.randint(1, 8, (B, 1))).astype(np.int32)
    for rate in (0.3, 0.0):  # some frames masked; none (the loss is 0, not NaN)
        labels = np.where((rng.rand(B, 7) < rate) & (mask == 1), np.arange(7), -1)
        labels = labels.astype(np.int32)
        want = jax_losses.mfm_nce_loss(*map(jax.numpy.asarray, (scores, video, mask, labels)))
        got = losses.mfm_nce_loss(*map(torch.from_numpy, (scores, video, mask, labels)))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def howto_files(tmp_path_factory):
    """JAX's and the port's HowTo100M fixtures (the last video's file
    corrupt) and the vocab."""
    d = tmp_path_factory.mktemp("howto")
    kw = dict(n_videos=5, clips_per_video=5, video_dim=16, seconds_per_video=60, seed=2)
    theirs = jax_fixtures.make_howto100m(str(d / "jax"), **kw)
    ours = fixtures.make_howto100m(str(d / "port"), **kw)
    return theirs, ours, fixtures.make_vocab(str(d / "vocab.txt"))


def test_make_howto100m_matches_jax(howto_files):
    """The csv, the caption pickle and every feature file, byte for byte."""
    theirs, ours, _ = howto_files
    for a, b in zip(theirs, ours):
        if os.path.isdir(a):
            assert sorted(os.listdir(a)) == sorted(os.listdir(b))
            for f in os.listdir(a):
                assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
        else:
            assert filecmp.cmp(a, b, shallow=False), a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masking_matches_jax(howto_files, seed):
    """mask_tokens, mask_frames, encode_text with the masked-language fields
    and encode_caption with a masked input: equal outputs, and the same
    draws left in the generator afterwards."""
    vocab = howto_files[2]
    jt, pt = JaxTokenizer(vocab), WordPieceTokenizer(vocab)
    words = pt.tokenize("add the chopped onions and stir well then pour some olive oil into pan "
                        "heat salt pepper garlic butter mix flour")
    video = np.random.RandomState(seed).randn(10, 4).astype(np.float32)
    for length in (3, len(words)):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        w = ["[CLS]"] + words[:length] + ["[SEP]"]
        assert jax_te.mask_tokens(w, jt, rj) == te.mask_tokens(w, pt, rp)
        for a, b in zip(jax_te.mask_frames(video, 7, rj), te.mask_frames(video, 7, rp)):
            np.testing.assert_array_equal(a, b)
        want = jax_te.encode_text(words[:length], jt, 12, rj, with_mlm=True)
        got = te.encode_text(words[:length], pt, 12, rp, with_mlm=True)
        want.update(jax_te.encode_caption(words[:length], jt, 12, rj, mask_input=True))
        got.update(te.encode_caption(words[:length], pt, 12, rp, mask_input=True))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
        assert rj.random_sample() == rp.random_sample()


@pytest.mark.parametrize("kw", [
    dict(only_sim=True, n_pair=3, sampled_use_mil=True),
    dict(n_pair=3, use_mil=True),
    dict(n_pair=3, sampled_use_mil=True, pretrain_enhance_vmodal=True),
    dict(n_pair=-1),
    dict(n_pair=1, pretrain_enhance_vmodal=True),
    dict(n_pair=3),
    dict(n_pair=7, min_words=12),  # more pairs than clips: drawn with replacement
], ids=["only_sim", "use_mil", "sampled_use_mil_vmodal", "n_pair_all", "n_pair_1", "n_pair_3",
        "n_pair_7_min_words"])
def test_howto100m_dataset_matches_jax(howto_files, kw):
    """Every sample of two epochs equal to JAX's, array by array, the corrupt
    file's zero video included."""
    theirs, _, vocab = howto_files
    csv, data, feats = theirs
    with open(data, "rb") as f:
        data_dict = pickle.load(f)
    common = dict(max_words=16, max_frames=12, video_dim=16, min_time=5.0, seed=3, **kw)
    jds = jax_howto100m.HowTo100MPretrainDataset(csv, data_dict, feats, JaxTokenizer(vocab),
                                                 **common)
    ds = howto100m.HowTo100MPretrainDataset(csv, data_dict, feats, WordPieceTokenizer(vocab),
                                            **common)
    assert len(ds) == len(jds)
    corrupt = 0
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        ds.set_epoch(epoch)
        for i in range(len(ds)):
            want, got = jds[i], ds[i]
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(want[k], got[k], err_msg=f"{epoch} {i} {k}")
            corrupt += int(got["video_mask"].sum() == 0)
    assert corrupt > 0 and ds._video_err_count == jds._video_err_count


@pytest.fixture(scope="module")
def two_stage_run(tmp_path_factory, howto_files):
    """Stage I (MIL) for 2 epochs, then stage II from its last .bin, through
    the CLI on the CPU."""
    _, (csv, data, feats), vocab = howto_files
    d = tmp_path_factory.mktemp("pretrain")
    argv = ["--device", "cpu", "--vocab_file", vocab, "--train_csv", csv, "--data_path", data,
            "--features_path", feats, "--max_words", "16", "--max_frames", "12",
            "--video_dim", "16", "--hidden_size", "32", "--num_attention_heads", "4",
            "--intermediate_size", "64", "--text_num_hidden_layers", "1",
            "--visual_num_hidden_layers", "1", "--cross_num_hidden_layers", "1",
            "--decoder_num_hidden_layers", "1", "--batch_size", "2", "--n_pair", "2",
            "--sampled_use_mil", "--epochs", "2", "--n_display", "1", "--lr", "1e-3",
            "--num_thread_reader", "2", "--seed", "0"]
    s1, s2 = str(d / "s1"), str(d / "s2")
    steps1, _ = pretrain.main(argv + ["--output_dir", s1])
    steps2, _ = pretrain.main(argv + ["--output_dir", s2, "--stage_two",
                                      "--pretrain_enhance_vmodal", "--init_model",
                                      os.path.join(s1, "pytorch_model.bin.1")])
    return argv, (s1, steps1), (s2, steps2)


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_stage_cli_run(two_stage_run):
    """Stage I's losses are sim_loss, stage II's the five, all finite, at
    every step; both write a per-epoch .bin and the train state; stage II's
    .bin carries both heads and stage I's none."""
    _, (s1, steps1), (s2, steps2) = two_stage_run
    assert steps1 == steps2 == 4  # 5 videos in batches of 2, 2 epochs
    for out, keys in ((s1, {"sim_loss"}), (s2, {"alm_loss", "nce_loss", "sim_loss_joint",
                                                "decoder_loss", "sim_loss_text_visual"})):
        train = [r for r in _records(out) if r["kind"] == "train"]
        assert [r["step"] for r in train] == [1, 2, 3, 4]
        for r in train:
            assert keys <= set(r) and all(np.isfinite(r[k]) for k in keys | {"loss"})
        meta = json.load(open(os.path.join(out, "train_state.pt.json")))
        assert meta["epoch"] == 1 and meta["global_step"] == 4 and meta["in_epoch_step"] == 0
    heads = [k for k in load_reference_bin(os.path.join(s2, "pytorch_model.bin.1"))
             if k.startswith(("cls.predictions.", "cls_visual.predictions."))]
    assert len(heads) == 10
    assert not any(k.startswith("cls") for k in load_reference_bin(
        os.path.join(s1, "pytorch_model.bin.1")))


@pytest.mark.parametrize("stage", ["stage_one", "stage_two"])
def test_jax_reads_the_pretrain_bins(two_stage_run, stage):
    """JAX's converter reads each stage's .bin with no unknown key: stage
    I's towers, stage II's heads too (the tied copies are not written)."""
    _, (s1, _), (s2, _) = two_stage_run
    path = os.path.join(s1 if stage == "stage_one" else s2, "pytorch_model.bin.1")
    tree, report = convert_torch_state_dict(load_torch_bin(path))
    assert report["unknown"] == [] and report["skipped"] == []
    assert ({"mlm_head", "mfm_head"} <= set(tree)) == (stage == "stage_two")
    back = state_dict_from_jax_params(tree)
    saved = load_reference_bin(path)
    assert sorted(back) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(back[k], v), k


def test_jax_load_init_params_reads_the_stage_one_bin(two_stage_run, tmp_path):
    """The JAX package's --init_model starts stage II from the port's stage-I
    file (its own parser and config for the same flags): every leaf the file
    holds equal, the cross tower, decoder and heads at JAX's init."""
    import logging

    from univl_tpu.cli import common as jax_common
    from univl_tpu.cli import pretrain as jax_pretrain

    argv, (s1, _), _ = two_stage_run
    path = os.path.join(s1, "pytorch_model.bin.1")
    i = argv.index("--device")
    jargv = argv[:i] + argv[i + 2:] + ["--output_dir", str(tmp_path), "--do_pretrain",
                                       "--stage_two", "--init_model", path]
    args = jax_common.finalize_args(jax_pretrain.add_pretrain_args(
        jax_common.base_parser("test")).parse_args(jargv))
    vocab = JaxTokenizer(args.vocab_file)
    jcfg = jax_common.build_config(args, task_type="retrieval", vocab_size=len(vocab))
    batch = pretrain_batch(jcfg, clips=jcfg.batch_size_per_device, pairs=args.n_pair)
    params = jax_common.load_init_params(args, JaxUniVL(jcfg), batch, logging.getLogger("test"))
    got = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    saved = load_reference_bin(path)
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    rest = set(got) - set(saved)
    assert {"cls.predictions.bias", "cls_visual.predictions.bias"} <= rest
    assert all(k.startswith(("cross.", "decoder.", "cls", "similarity_dense.")) for k in rest)
