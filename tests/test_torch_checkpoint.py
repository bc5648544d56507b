"""The port's train-state checkpoints, preemption and exact resume, on the
CPU at tiny sizes: BertAdam's state with its step count, the train-state
file and the rotating manager (synchronous and asynchronous), the batcher's
skip, ``--init_model`` from a flax params file, preempt-then-resume of
``task_retrieval`` and ``cli.pretrain`` (also with
``--async_checkpointing``) against uninterrupted runs, bit for bit, and the
JAX-free checkpoint converter against the JAX package's. These mirror the
JAX package's ``tests/test_cli.py`` and ``tests/test_checkpoint_manager.py``
on the port; the flax files, the batcher's order and the converter's
reference outputs come from JAX.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from univl_tpu import config as jax_config
from univl_tpu.checkpoint.io import save_checkpoint as jax_save_checkpoint
from univl_tpu.data import batching as jax_batching
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.io import (
    TRAIN_STATE,
    CheckpointWriter,
    read_flax_params,
    restore_checkpoint,
    save_checkpoint,
)
from univl_tpu_torch.checkpoint.manager import RotatingCheckpointManager
from univl_tpu_torch.cli import common, pretrain, task_retrieval
from univl_tpu_torch.data import batching, fixtures
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer

B = 4


def _batch(cfg, seed: int):
    rng = np.random.RandomState(seed)
    Lw, Lv = cfg.max_words, cfg.max_frames
    return {
        "input_ids": rng.randint(1, cfg.bert.vocab_size, (1, B, Lw)).astype(np.int32),
        "token_type_ids": np.zeros((1, B, Lw), np.int32),
        "attention_mask": (np.arange(Lw) < rng.randint(2, Lw + 1, (1, B, 1))).astype(np.int32),
        "video": rng.randn(1, B, Lv, cfg.video_dim).astype(np.float32),
        "video_mask": (np.arange(Lv) < rng.randint(1, Lv + 1, (1, B, 1))).astype(np.int32),
    }


def _trainer(cfg, state_dtype):
    model = UniVL(cfg)
    model.load_state_dict(common.init_state_dict(cfg, 0), strict=True)
    opt = make_univl_optimizer(model, lr=1e-3, t_total=10, warmup_proportion=0.2, coef_lr=0.1,
                               state_dtype=state_dtype)
    return Trainer(model, opt, seed=5)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"], ids=["f32", "bf16_moments"])
def test_train_state_round_trip_gives_the_same_next_step(tmp_path, state_dtype):
    """Three steps mid-schedule, a save, a fresh trainer restored from the
    file: the fourth step's loss, parameters, moments (in their dtype) and
    BertAdam's step count equal the uninterrupted trainer's, bitwise."""
    cfg = config.UniVLConfig.tiny(batch_size_per_device=B)
    batches = [{k: torch.from_numpy(v) for k, v in _batch(cfg, s).items()} for s in range(4)]
    a = _trainer(cfg, state_dtype)
    for i in range(3):
        a.train_step(batches[i], i)
    path = str(tmp_path / TRAIN_STATE)
    save_checkpoint(path, common.train_state(a), metadata={"epoch": 0, "global_step": 3})
    b = _trainer(cfg, state_dtype)
    state, meta = restore_checkpoint(path)
    common.load_train_state(b, state)
    assert meta == {"epoch": 0, "global_step": 3} and b.optimizer.steps == 3
    la, lb = a.train_step(batches[3], 3), b.train_step(batches[3], 3)
    assert torch.equal(la["loss"], lb["loss"]) and a.optimizer.steps == b.optimizer.steps == 4
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
        for key in ("m", "v"):
            ma, mb = a.optimizer.state[p][key], b.optimizer.state[q][key]
            assert ma.dtype == mb.dtype == (torch.bfloat16 if state_dtype else torch.float32)
            assert torch.equal(ma, mb), (n, key)


def test_partial_restore_leaves_what_the_file_lacks_at_init(tmp_path):
    """A stage-I file restored into a stage-II model's seeded init: the
    towers come from the file, the cross tower, decoder and heads stay at
    the init and are reported; a key the model lacks is an error."""
    kw = dict(do_pretrain=True, use_mil=True, batch_size_per_device=B)
    stage_one = common.init_state_dict(config.UniVLConfig.tiny(**kw), 1)
    template = common.init_state_dict(config.UniVLConfig.tiny(stage_two=True, **kw), 2)
    path = str(tmp_path / "pytorch_model.bin.0")
    save_checkpoint(path, stage_one, metadata={"epoch": 0})
    merged, meta, missing = restore_checkpoint(path, template, partial=True)
    assert meta == {"epoch": 0} and missing == sorted(set(template) - set(stage_one))
    assert any(k.startswith("cls_visual.") for k in missing)
    assert all(torch.equal(merged[k], stage_one[k]) for k in stage_one)
    assert all(torch.equal(merged[k], template[k]) for k in missing)
    with pytest.raises(ValueError, match="keys the model does not have"):
        restore_checkpoint(path, {k: v for k, v in template.items()
                                  if not k.startswith("visual.")}, partial=True)


def test_bert_adam_state_dict_carries_the_step_count():
    """The schedule reads the step count: without it a restored optimizer
    would take warmup's first (lr 0) update again."""
    cfg = config.UniVLConfig.tiny(batch_size_per_device=B)
    t = _trainer(cfg, None)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    t.train_step(batch, 0)
    t.train_step(batch, 1)
    sd = t.optimizer.state_dict()
    assert sd["steps"] == 2
    fresh = _trainer(cfg, None).optimizer
    fresh.load_state_dict(sd)
    assert fresh.steps == 2 and fresh.lr_at(fresh.steps) == t.optimizer.lr_at(2) > 0.0


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_batcher_skip_equals_the_tail_and_jax(grad_accum):
    """epoch(e, start_batch=k): the unskipped epoch's batches after the
    k-th, and JAX's skipped batches, array by array; the skipped samples
    are not read."""

    class Samples:
        def __init__(self):
            self.read = []

        def __len__(self):
            return 19

        def __getitem__(self, i):
            self.read.append(i)
            return {"x": np.full((2,), i, np.int32)}

    ours = batching.Batcher(Samples(), 3, seed=4, grad_accum=grad_accum, num_workers=2)
    theirs = jax_batching.Batcher(Samples(), 3, seed=4, grad_accum=grad_accum, num_workers=2)
    full = list(ours.epoch(1))
    ours.dataset.read.clear()
    tail = list(ours.epoch(1, start_batch=2))
    assert len(ours.dataset.read) == 3 * grad_accum * (len(full) - 2)
    want = list(theirs.epoch(1, start_batch=2))
    assert len(tail) == len(want) == len(full) - 2
    for a, b, c in zip(tail, full[2:], want):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["x"], c["x"])


def test_init_model_reads_a_flax_params_file(tmp_path):
    """--init_model params.msgpack.0 written by flax (the JAX package's
    save_checkpoint): the port's model gives JAX's eval forward."""
    import argparse
    import logging

    jcfg = jax_config.UniVLConfig.tiny(batch_size_per_device=B, train_sim_after_cross=True)
    batch = {k: v[0] for k, v in _batch(jcfg, 1).items()}
    jm = JaxUniVL(jcfg)
    params = jax.jit(lambda k: jm.init(k, batch, deterministic=True))(jax.random.key(7))["params"]
    path = str(tmp_path / "params.msgpack.0")
    jax_save_checkpoint(path, params, metadata={"epoch": 0})
    tree = read_flax_params(path)
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b), params,
                                     tree))
    want = jm.apply({"params": params}, batch, deterministic=True)["loss"]
    model = UniVL(config.UniVLConfig.tiny(batch_size_per_device=B, train_sim_after_cross=True))
    common.load_init_params(argparse.Namespace(seed=0, init_model=path), model,
                            logging.getLogger("test"))
    got = model.eval()({k: torch.from_numpy(v) for k, v in batch.items()})["loss"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def youcook_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("youcook")
    csv, data, feats = fixtures.make_youcook(str(d), n_videos=4, clips_per_video=4,
                                             video_dim=16, seed=1)
    return csv, data, feats, fixtures.make_vocab(str(d / "vocab.txt"))


def _retrieval_argv(files, out, *extra):
    csv, data, feats, vocab = files
    return ["--do_train", "--do_eval", "--device", "cpu", "--vocab_file", vocab,
            "--train_csv", csv, "--val_csv", csv, "--data_path", data, "--features_path", feats,
            "--output_dir", out, "--max_words", "12", "--max_frames", "6", "--video_dim", "16",
            "--hidden_size", "32", "--num_attention_heads", "4", "--intermediate_size", "64",
            "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
            "--batch_size", "4", "--batch_size_val", "8", "--epochs", "2", "--n_display", "1",
            "--lr", "1e-3", "--num_thread_reader", "2", "--seed", "0", *extra]


def _train_records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f) if r["kind"] == "train"]


def _same_train_state(a: str, b: str, path: str = TRAIN_STATE) -> None:
    """The parameters, the moments and BertAdam's step count in two train
    states, bitwise."""
    sa, _ = restore_checkpoint(os.path.join(a, path))
    sb, _ = restore_checkpoint(os.path.join(b, path))
    assert sa["optimizer"]["steps"] == sb["optimizer"]["steps"] > 0
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    for i, st in sa["optimizer"]["state"].items():
        for key in ("m", "v"):
            assert torch.equal(st[key], sb["optimizer"]["state"][i][key]), (i, key)


@pytest.fixture(scope="module")
def retrieval_uninterrupted(youcook_files, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("uninterrupted"))
    steps, best = task_retrieval.main(_retrieval_argv(youcook_files, out))
    return out, steps, best


@pytest.mark.parametrize("preempt_after", [2, 4, 5],
                         ids=["mid_epoch", "epoch_end", "after_an_eval"])
def test_retrieval_preempt_then_resume_is_bit_exact(youcook_files, retrieval_uninterrupted,
                                                    tmp_path, preempt_after):
    """--inject_preempt_after inside the first epoch, at its last step, and
    at the second epoch's first step (after an eval): the train state says
    preempted with the offset (and, after the eval, the best so far); the
    resumed run's per-step losses, per-epoch .bin files, best epoch and
    final train state equal the uninterrupted run's, bitwise."""
    full, steps, best = retrieval_uninterrupted
    assert steps == 8  # 16 clips in batches of 4, 2 epochs
    out = str(tmp_path / "out")
    got = task_retrieval.main(_retrieval_argv(youcook_files, out, "--inject_preempt_after",
                                              str(preempt_after)))
    assert got[0] == preempt_after
    meta = json.load(open(os.path.join(out, TRAIN_STATE + ".json")))
    assert meta["preempted"] is True and meta["global_step"] == preempt_after
    assert meta["in_epoch_step"] == (preempt_after - 1) % 4 + 1
    assert (meta["best"] is not None) == (preempt_after > 4)
    if preempt_after > 4:
        assert meta["best"]["epoch"] == 0 and meta["best_score"] == meta["best"]["R1"]
    steps2, best2 = task_retrieval.main(_retrieval_argv(youcook_files, out, "--load_checkpoint"))
    assert steps2 == steps and (best2["epoch"], best2["R1"]) == (best["epoch"], best["R1"])
    assert _train_records(out) == _train_records(full)
    for name in ("pytorch_model.bin.0", "pytorch_model.bin.1", common.BEST_BIN):
        a, b = (torch.load(os.path.join(d, name), weights_only=True) for d in (out, full))
        assert all(torch.equal(a[k], b[k]) for k in b), name
    _same_train_state(out, full)


def test_load_checkpoint_without_a_checkpoint_starts_from_scratch(youcook_files,
                                                                  retrieval_uninterrupted,
                                                                  tmp_path, caplog):
    full, steps, _ = retrieval_uninterrupted
    out = str(tmp_path / "out")
    assert task_retrieval.main(_retrieval_argv(youcook_files, out, "--load_checkpoint"))[0] == steps
    assert "starting from scratch" in caplog.text
    assert _train_records(out) == _train_records(full)


@pytest.fixture(scope="module")
def howto_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("howto")
    csv, data, feats = fixtures.make_howto100m(str(d), n_videos=16, clips_per_video=4,
                                               video_dim=16, seconds_per_video=40,
                                               corrupt_last=False)
    return csv, data, feats, fixtures.make_vocab(str(d / "vocab.txt"))


def _pretrain_argv(files, out, *extra):
    csv, data, feats, vocab = files
    return ["--device", "cpu", "--vocab_file", vocab, "--train_csv", csv, "--data_path", data,
            "--features_path", feats, "--output_dir", out, "--max_words", "12",
            "--max_frames", "8", "--video_dim", "16", "--hidden_size", "32",
            "--num_attention_heads", "4", "--intermediate_size", "64",
            "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
            "--batch_size", "4", "--gradient_accumulation_steps", "2", "--n_pair", "2",
            "--sampled_use_mil", "--epochs", "3", "--n_display", "1", "--lr", "1e-3",
            "--num_thread_reader", "2", "--seed", "0", *extra]


@pytest.fixture(scope="module")
def pretrain_uninterrupted(howto_files, tmp_path_factory):
    """Two uninterrupted runs, one per checkpoint backend."""
    outs = {}
    for backend in ("msgpack", "orbax"):
        out = str(tmp_path_factory.mktemp(f"pre_{backend}"))
        steps, _ = pretrain.main(_pretrain_argv(howto_files, out, "--checkpoint_backend",
                                                backend))
        assert steps == 12  # 16 videos, update-batches of 2 x 2: 4 an epoch, 3 epochs
        outs[backend] = out
    return outs


def _latest(out: str) -> str:
    """The train state's directory, relative to ``out``: the single file's,
    or the manager's latest step's."""
    ckpt = os.path.join(out, "checkpoints")
    if not os.path.isdir(ckpt):
        return ""
    return os.path.join("checkpoints", str(RotatingCheckpointManager(ckpt).latest_step()))


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_pretrain_preempt_then_resume_is_bit_exact(howto_files, pretrain_uninterrupted,
                                                   tmp_path, backend):
    """Preempted at step 3 (mid-epoch, with gradient accumulation) and at 4
    (the epoch's end), resumed twice: the losses, the per-epoch .bin files
    and the final train state equal the uninterrupted run's, bitwise."""
    full = pretrain_uninterrupted[backend]
    out = str(tmp_path / "out")
    argv = _pretrain_argv(howto_files, out, "--checkpoint_backend", backend)
    assert pretrain.main(argv + ["--inject_preempt_after", "3"])[0] == 3
    assert pretrain.main(argv + ["--load_checkpoint", "--inject_preempt_after", "1"])[0] == 4
    assert pretrain.main(argv + ["--load_checkpoint"])[0] == 12
    assert _train_records(out) == _train_records(full)
    for e in range(3):
        a, b = (torch.load(os.path.join(d, f"pytorch_model.bin.{e}"), weights_only=True)
                for d in (out, full))
        assert all(torch.equal(a[k], b[k]) for k in b), e
    assert _latest(out) == _latest(full)
    _same_train_state(out, full, os.path.join(_latest(out), TRAIN_STATE))


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_pretrain_async_preempt_then_resume_is_bit_exact(howto_files, pretrain_uninterrupted,
                                                         tmp_path, backend):
    """As above with --async_checkpointing: each save returns after the
    copy to the host and writes on a thread; the preempted runs wait for
    their writes before they return, so the resumes read them whole; the
    result is the synchronous uninterrupted run's, bitwise. Every save
    logged the seconds it held the loop."""
    full = pretrain_uninterrupted[backend]
    out = str(tmp_path / "out")
    argv = _pretrain_argv(howto_files, out, "--checkpoint_backend", backend,
                          "--async_checkpointing", "--checkpoint_every_steps", "2")
    assert pretrain.main(argv + ["--inject_preempt_after", "3"])[0] == 3
    assert pretrain.main(argv + ["--load_checkpoint", "--inject_preempt_after", "1"])[0] == 4
    assert pretrain.main(argv + ["--load_checkpoint"])[0] == 12
    assert _train_records(out) == _train_records(full)
    for e in range(3):
        a, b = (torch.load(os.path.join(d, f"pytorch_model.bin.{e}"), weights_only=True)
                for d in (out, full))
        assert all(torch.equal(a[k], b[k]) for k in b), e
    _same_train_state(out, full, os.path.join(_latest(out), TRAIN_STATE))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        saves = [r for r in map(json.loads, f) if r["kind"] == "checkpoint"]
    assert len(saves) >= 6 and all(r["blocked_seconds"] >= 0 for r in saves)


def test_pretrain_periodic_checkpoint_survives_a_crash(howto_files, pretrain_uninterrupted,
                                                       tmp_path):
    """--checkpoint_every_steps 2 with --inject_crash_after 3: the crash
    (with no checkpoint) loses step 3, the resume replays it from step 2's
    checkpoint (its loss displayed twice, the same), and the run ends equal
    to the uninterrupted one."""
    full = pretrain_uninterrupted["msgpack"]
    out = str(tmp_path / "out")
    argv = _pretrain_argv(howto_files, out, "--checkpoint_every_steps", "2")
    with pytest.raises(RuntimeError, match="injected crash"):
        pretrain.main(argv + ["--inject_crash_after", "3"])
    meta = json.load(open(os.path.join(out, TRAIN_STATE + ".json")))
    assert meta["global_step"] == 2 and meta["in_epoch_step"] == 2 and not meta["preempted"]
    assert pretrain.main(argv + ["--load_checkpoint"])[0] == 12
    records = _train_records(out)
    assert records[2] == records[3] and records[:3] + records[4:] == _train_records(full)
    _same_train_state(out, full)


def test_pretrain_refuses_what_it_does_not_run(howto_files, tmp_path, capsys):
    for extra in (["--zero1"], ["--n_gpu", "2"]):
        with pytest.raises(SystemExit) as e:
            pretrain.main(_pretrain_argv(howto_files, str(tmp_path / "out"), *extra))
        assert e.value.code == 2 and extra[0] in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------- the rotating manager


def _state(v: float):
    return {"model": {"w": torch.full((4, 4), v)}}


def test_rotation_keeps_the_last_n(tmp_path):
    mgr = RotatingCheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in range(5):
        mgr.save(s, _state(float(s)), metrics={"loss": 5.0 - s})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    state, meta = mgr.restore(4)
    assert float(state["model"]["w"][0, 0]) == 4.0 and meta["loss"] == 1.0


@pytest.mark.parametrize("mode", ["max", "min"])
def test_rotation_keeps_the_best_too(tmp_path, mode):
    """The best step by the metric survives rotation, in either direction; a
    save without the metric ranks last."""
    mgr = RotatingCheckpointManager(str(tmp_path / "ck"), max_to_keep=2, best_metric="r1",
                                    best_mode=mode)
    r1 = [0.1, 0.9, 0.3, None, 0.2, 0.25] if mode == "max" else [0.5, 0.05, 0.3, None, 0.2, 0.25]
    for s, r in enumerate(r1):
        mgr.save(s, _state(float(s)), metrics=None if r is None else {"r1": r})
    assert mgr.best_step() == 1 and mgr.all_steps() == [1, 4, 5]


def test_same_step_overwrites_and_empty_restores_none(tmp_path):
    mgr = RotatingCheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.restore_latest() == (None, None, None)
    mgr.save(5, _state(1.0), metrics={"epoch": 0, "preempted": True})
    mgr.save(5, _state(2.0), metrics={"epoch": 1, "preempted": False})
    state, meta, step = mgr.restore_latest()
    assert step == 5 and float(state["model"]["w"][0, 0]) == 2.0
    assert meta == {"epoch": 1, "preempted": False}


def test_numpy_scalar_metrics_are_written_as_json(tmp_path):
    mgr = RotatingCheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    mgr.save(1, _state(1.0), metrics={"r1": np.float32(0.41), "n": np.int32(7),
                                      "j": np.asarray(0.5), "flag": np.bool_(True), "name": "x"})
    _, meta = mgr.restore(1)
    assert abs(meta["r1"] - 0.41) < 1e-6 and meta["n"] == 7.0 and meta["j"] == 0.5
    assert meta["flag"] is True and meta["name"] == "x"


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_manager_round_trip_and_same_step(tmp_path, async_save):
    """Save and restore, the rotation, and a second save at a step whose
    first save may still be in flight (the preemption at an epoch's last
    step): the second replaces the first."""
    mgr = RotatingCheckpointManager(str(tmp_path / "ck"), max_to_keep=2, async_save=async_save)
    for s in range(4):
        mgr.save(s, _state(float(s)), metrics={"loss": 4.0 - s})
    mgr.save(3, _state(7.0), metrics={"loss": 0.5})
    state, meta, step = mgr.restore_latest()
    assert step == 3 and float(state["model"]["w"][0, 0]) == 7.0 and meta == {"loss": 0.5}
    assert mgr.all_steps() == [2, 3]


def test_async_save_copies_the_state_before_it_returns(tmp_path):
    """The optimizer updates the parameters in place right after a save:
    the write holds the values at the save."""
    writer = CheckpointWriter(async_save=True)
    w = torch.full((256, 256), 1.0)
    writer.save(str(tmp_path / "a.pt"), {"model": {"w": w}}, metadata={"step": 1})
    w.add_(1.0)
    writer.wait()
    state, meta = restore_checkpoint(str(tmp_path / "a.pt"))
    assert torch.equal(state["model"]["w"], torch.full((256, 256), 1.0)) and meta == {"step": 1}


def test_a_failed_async_write_raises_at_the_next_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = CheckpointWriter(async_save=True)
    writer.save(str(blocker / "sub" / "a.pt"), _state(1.0))  # returns; the write fails
    with pytest.raises(RuntimeError, match="asynchronous checkpoint write failed"):
        writer.wait()
    writer.wait()  # reported once


# ------------------------------------------------------------- the converter


CONVERT_FLAGS = ["--stage_two", "--do_pretrain", "--text_num_hidden_layers", "1",
                 "--visual_num_hidden_layers", "1", "--cross_num_hidden_layers", "1",
                 "--decoder_num_hidden_layers", "1", "--max_words", "8", "--max_frames", "6",
                 "--video_dim", "32", "--hidden_size", "64", "--num_attention_heads", "4",
                 "--intermediate_size", "128", "--vocab_size", "96"]


@pytest.fixture(scope="module")
def reference_bin(tmp_path_factory):
    """A .bin in the reference layout from the port's seeded init (the tied
    duplicates written out), with an unused pooler and a name no converter
    knows."""
    from univl_tpu_torch.checkpoint.convert import reference_state_dict
    from univl_tpu_torch.cli.convert_checkpoint import build_config, parse_args

    cfg = build_config(parse_args(CONVERT_FLAGS + ["--torch_bin", "x", "--output", "y"]))
    sd = reference_state_dict(common.init_state_dict(cfg, 3))
    sd["bert.pooler.dense.weight"] = torch.ones(64, 64)
    sd["bert.encoder.layer.0.adapter.weight"] = torch.ones(2)
    path = str(tmp_path_factory.mktemp("convert") / "ref.bin")
    torch.save(sd, path)
    return path


def test_converter_writes_the_flax_file_jax_writes(reference_bin, tmp_path, capsys):
    """The port's .bin -> flax conversion against JAX's on the same file:
    the same report, the same tree (read by flax's msgpack_restore), and
    every converted leaf bitwise JAX's; the sidecar names the source."""
    from flax import serialization

    from univl_tpu.cli import convert_checkpoint as jax_convert
    from univl_tpu_torch.cli import convert_checkpoint

    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    convert_checkpoint.main(CONVERT_FLAGS + ["--torch_bin", reference_bin, "--output", ours])
    port_out = capsys.readouterr().out
    jax_convert.main(CONVERT_FLAGS + ["--torch_bin", reference_bin, "--output", theirs])
    jax_out = capsys.readouterr().out
    assert port_out.splitlines()[0] == jax_out.splitlines()[0]
    assert "unknown=1" in port_out and "left-at-init=0" in port_out
    with open(ours, "rb") as f:
        got = serialization.msgpack_restore(f.read())
    with open(theirs, "rb") as f:
        want = serialization.msgpack_restore(f.read())

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.float32 and np.array_equal(got[k], v), k
    assert json.load(open(ours + ".json")) == {"source": reference_bin}


def test_converter_exports_the_bin_jax_exports(reference_bin, tmp_path):
    """--export_torch of one flax file by both packages: the same names in
    the same order, every tensor bitwise equal, the tied duplicates
    included; and a .bin -> flax -> .bin round trip gives back the .bin's
    converted tensors bitwise."""
    from univl_tpu.checkpoint.torch_convert import save_torch_bin
    from univl_tpu_torch.cli import convert_checkpoint

    flax_file = str(tmp_path / "p.msgpack")
    convert_checkpoint.main(CONVERT_FLAGS + ["--torch_bin", reference_bin, "--output", flax_file])
    ours, theirs = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    convert_checkpoint.main(["--export_torch", "--flax_params", flax_file, "--output", ours])
    save_torch_bin(theirs, read_flax_params(flax_file))
    got, want = (torch.load(p, weights_only=True) for p in (ours, theirs))
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
    original = torch.load(reference_bin, weights_only=True)
    assert sorted(got) == sorted(k for k in original if not k.startswith(
        ("bert.pooler.", "bert.encoder.layer.0.adapter.")))
    assert all(torch.equal(got[k], original[k]) for k in got)


@pytest.mark.parametrize("chunk", [None, 1000], ids=["whole", "chunked"])
def test_write_flax_params_writes_flaxs_bytes(tmp_path, monkeypatch, chunk):
    """write_flax_params gives the bytes of flax's serialization.to_bytes
    of the same tree, also where arrays are chunked (the limit lowered to
    1,000 bytes here); both packages' readers read it back."""
    from flax import serialization

    from univl_tpu_torch.checkpoint import io

    rng = np.random.RandomState(0)
    tree = {"a": {"kernel": rng.randn(30, 20).astype(np.float32),
                  "bias": np.zeros(20, np.float32)},
            "b": rng.randint(0, 9, (5,)).astype(np.int32), "c": np.float32(2.5)}
    if chunk:
        monkeypatch.setattr(io, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    path = io.write_flax_params(str(tmp_path / "t.msgpack"), tree)
    with open(path, "rb") as f:
        data = f.read()
    assert data == serialization.to_bytes(tree)
    back = read_flax_params(path)
    assert np.array_equal(back["a"]["kernel"], tree["a"]["kernel"]) and back["c"] == 2.5
