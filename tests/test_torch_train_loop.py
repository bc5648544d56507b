"""The trainers' epoch loop (``univl_tpu_torch/cli/common.py:run_train_epochs``)
on its step routes, and the switches of the port's graph routes, on the CPU
at tiny sizes.

FT-Joint and caption fine-tuning through their CLIs and pretraining stage I
through ``cli.pretrain`` step once through ``Trainer.train_steps`` an
update-batch, and give the losses, every ``pytorch_model.bin.<epoch>`` and
the train state of a direct ``Trainer.train_step`` loop over the same
batches from the same trainer, bitwise; ``step_route`` in metrics.jsonl
reads ``cpu``, and ``eager: <the reason>`` for a trainer whose
``graph_refusal`` names one (the loop then calls ``train_step``).
``graph=True`` off the card raises, in ``Trainer`` and in
``RetrievalEvaluator``; the functions the evaluator's graphs capture read
nothing back to the host. The evaluator's eager route against its default
and against JAX's is in ``tests/test_torch_eval.py``.

``--profile_dir`` traces the steps JAX's loop traces: one Chrome trace a
process with one range for each of global steps 2-6 (an 8-batch epoch of
``task_retrieval``, and of ``task_caption --fused_ln``), the run's losses
and ``.bin`` bitwise the run without it; on a preemption after 4 steps the
trace of steps 2-3 is on disk before the train state, and the resumed run
traces from index 2 of its part of the epoch; a raise writes the steps so
far, and a directory that cannot be written raises; two ranks write a
trace each; a 2-batch epoch and ``cli.pretrain`` write no trace.
"""

import contextlib
import copy
import glob
import json
import os
import types

import numpy as np
import pytest
import torch

from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import init_state_dict
from univl_tpu_torch.checkpoint.io import TRAIN_STATE, restore_checkpoint
from univl_tpu_torch.cli import common, pretrain, task_caption, task_retrieval
from univl_tpu_torch.data import fixtures
from univl_tpu_torch.evals.retrieval import RetrievalEvaluator
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.parallel.mesh import DP_AXIS, Mesh
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer
from univl_tpu_torch.utils import profiling
from univl_tpu_torch.utils.profiling import STEP_RANGE

TINY = ["--max_words", "12", "--video_dim", "16", "--hidden_size", "32",
        "--num_attention_heads", "4", "--intermediate_size", "64",
        "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
        "--n_display", "1", "--lr", "1e-3", "--num_thread_reader", "2", "--seed", "0"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    vocab = fixtures.make_vocab(str(d / "vocab.txt"))
    youcook = fixtures.make_youcook(str(d / "youcook"), n_videos=4, clips_per_video=3,
                                    video_dim=16, seed=5)
    howto = fixtures.make_howto100m(str(d / "howto"), n_videos=8, clips_per_video=4,
                                    video_dim=16, seconds_per_video=40, corrupt_last=False)
    return vocab, youcook, howto


def _argv(kind: str, files, out: str) -> list:
    vocab, (csv, data, feats), (h_csv, h_data, h_feats) = files
    if kind == "pretrain":
        return ["--device", "cpu", "--vocab_file", vocab, "--train_csv", h_csv,
                "--data_path", h_data, "--features_path", h_feats, "--output_dir", out,
                "--max_frames", "8", "--batch_size", "4", "--gradient_accumulation_steps", "2",
                "--n_pair", "2", "--sampled_use_mil", "--epochs", "2", *TINY]
    argv = ["--do_train", "--device", "cpu", "--vocab_file", vocab, "--train_csv", csv,
            "--data_path", data, "--features_path", feats, "--output_dir", out,
            "--max_frames", "6", "--batch_size", "4", "--epochs", "2", *TINY]
    if kind == "caption":  # one epoch: the slowest step of the three
        argv += ["--val_csv", csv, "--cross_num_hidden_layers", "1",
                 "--decoder_num_hidden_layers", "1", "--fused_ln", "--epochs", "1"]
    return argv


MAINS = {"ft_joint": task_retrieval.main, "caption": task_caption.main,
         "pretrain": pretrain.main}


def _spy(monkeypatch) -> dict:
    """``run_train_epochs`` with a twin of the trainer (``make_trainer`` of a
    copy of the model before its first step), the args and the batcher
    kept, and the trainer's ``train_steps`` and ``train_step`` calls
    counted."""
    seen = {"train_steps": 0, "train_step": 0}
    real = common.run_train_epochs

    def spy(args, trainer, batcher, logger, device, **kw):
        twin = common.make_trainer(args, copy.deepcopy(trainer.model), len(batcher), logger)
        seen.update(args=args, batcher=batcher, twin=twin)
        for name in ("train_steps", "train_step"):
            def counted(*a, _inner=getattr(trainer, name), _name=name):
                seen[_name] += 1
                return _inner(*a)
            setattr(trainer, name, counted)
        return real(args, trainer, batcher, logger, device, **kw)

    monkeypatch.setattr(common, "run_train_epochs", spy)
    return seen


def _direct_loop(seen: dict):
    """The twin trainer through ``train_step`` over the batcher's
    update-batches of every epoch: each step's metrics and each epoch's
    weights."""
    args, batcher, twin = seen["args"], seen["batcher"], seen["twin"]
    accum = args.gradient_accumulation_steps
    metrics, weights, step = [], [], 0
    for epoch in range(args.epochs):
        for b in batcher.epoch(epoch):
            metrics.append(twin.train_step(
                {k: torch.from_numpy(v if accum > 1 else v[None]) for k, v in b.items()}, step))
            step += 1
        weights.append({k: v.clone() for k, v in twin.model.state_dict().items()})
    return metrics, weights, twin


def _records(out: str, kind: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _assert_same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k, v in want.items():
        assert torch.equal(got[k], v), f"{what}: {k}"


@pytest.mark.parametrize("kind", list(MAINS))
def test_loop_steps_through_train_steps_as_the_direct_loop(kind, files, tmp_path,
                                                           monkeypatch):
    """Through the CLI (two epochs; caption's one): one ``train_steps`` call (and no
    ``train_step`` call of the loop's own) an update-batch; every step's
    displayed metrics, each epoch's ``.bin`` and the final train state
    (parameters, both moments, BertAdam's step count) bitwise the direct
    ``train_step`` loop's; ``step_route`` ``cpu``."""
    seen = _spy(monkeypatch)
    out = str(tmp_path / kind)
    steps = MAINS[kind](_argv(kind, files, out))[0]
    metrics, weights, twin = _direct_loop(seen)
    assert steps == len(metrics) == seen["train_steps"] == twin.optimizer.steps > 2
    assert seen["train_step"] == steps  # the CPU's train_steps is the train_step loop
    assert [r["step_route"] for r in _records(out, "mesh")] == ["cpu"]
    shown = _records(out, "train")
    assert [r["step"] for r in shown] == list(range(1, steps + 1))
    for r, m in zip(shown, metrics):
        assert {k: r[k] for k in m} == {k: float(v) for k, v in m.items()}, r["step"]
    for epoch, want in enumerate(weights):
        got = torch.load(os.path.join(out, f"pytorch_model.bin.{epoch}"), weights_only=True)
        _assert_same(got, want, f"pytorch_model.bin.{epoch}")
    state, _ = restore_checkpoint(os.path.join(out, TRAIN_STATE))
    _assert_same(state["model"], twin.model.state_dict(), "train state")
    want = twin.optimizer.state_dict()
    assert state["optimizer"]["steps"] == want["steps"] == steps
    for i, st in want["state"].items():
        _assert_same(state["optimizer"]["state"][i], st, f"moments of parameter {i}")


class _TwoRanksOneProcess(Mesh):
    """A mesh of two ranks to the trainer's refusal, one process to the loop:
    its control collectives are this rank's own values, its dp view one rank."""

    def barrier(self) -> None:
        pass

    def any(self, flag: bool) -> bool:
        return flag

    def broadcast(self, value):
        return value


def _tiny_batcher(cfg, n: int, B: int = 4):
    rng = np.random.RandomState(7)
    Lw, Lv = cfg.max_words, cfg.max_frames
    batches = [{
        "input_ids": rng.randint(1, cfg.bert.vocab_size, (B, Lw)).astype(np.int32),
        "token_type_ids": np.zeros((B, Lw), np.int32),
        "attention_mask": (np.arange(Lw) < rng.randint(2, Lw + 1, (B, 1))).astype(np.int32),
        "video": rng.randn(B, Lv, cfg.video_dim).astype(np.float32),
        "video_mask": (np.arange(Lv) < rng.randint(1, Lv + 1, (B, 1))).astype(np.int32),
    } for _ in range(n)]
    return types.SimpleNamespace(epoch=lambda epoch, start_batch=0: iter(batches[start_batch:]),
                                 batches=batches)


def _loop_args(out: str, **kw):
    return types.SimpleNamespace(**{
        "output_dir": out, "load_checkpoint": False, "async_checkpointing": False,
        "gradient_accumulation_steps": 1, "batch_size": 4, "epochs": 1, "n_display": 1,
        "no_preempt_checkpoint": True, "no_prefetch": True, **kw})


def test_refused_trainer_steps_eagerly_and_says_why(tmp_path, monkeypatch):
    """A trainer whose ``graph_refusal`` names a reason (a two-rank mesh):
    the loop calls ``train_step`` an update-batch and never ``train_steps``,
    logs the route as ``eager: <the reason>``, and its losses are a direct
    loop's."""
    layers = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                  intermediate_size=64)
    cfg = config.UniVLConfig.tiny(bert=config.BertConfig(vocab_size=64, **layers),
                                  visual=config.VisualConfig(vocab_size=32, **layers),
                                  max_words=8, max_frames=6, video_dim=16)
    mesh = _TwoRanksOneProcess(size=2, views={DP_AXIS: Mesh()})

    def trainer(m):
        model = UniVL(cfg)
        model.load_state_dict(init_state_dict(cfg, 0), strict=True)
        return Trainer(model, make_univl_optimizer(model, lr=1e-3, t_total=10), seed=3, mesh=m)

    loop, direct = trainer(mesh), trainer(None)
    refusal = loop.graph_refusal()
    assert refusal is not None and "a mesh of 2 ranks" in refusal
    assert loop.step_route() == f"eager: {refusal}"
    calls = {"train_steps": 0}
    monkeypatch.setattr(loop, "train_steps", lambda *a: calls.__setitem__("train_steps", 1))
    batcher = _tiny_batcher(cfg, 3)
    out = str(tmp_path)
    steps, _ = common.run_train_epochs(_loop_args(out), loop, batcher, common.get_logger(out),
                                       torch.device("cpu"))
    assert steps == 3 and calls["train_steps"] == 0
    assert [r["step_route"] for r in _records(out, "mesh")] == [f"eager: {refusal}"]
    want = [float(direct.train_step({k: torch.from_numpy(v[None]) for k, v in b.items()},
                                    i)["loss"]) for i, b in enumerate(batcher.batches)]
    assert [r["loss"] for r in _records(out, "train")] == want


def test_graph_true_off_the_card_raises():
    """``graph=True`` asks for CUDA graphs, which a CPU model cannot replay:
    the trainer and the evaluator refuse it at construction; ``graph=False``
    and the default take the eager route there."""
    cfg = config.UniVLConfig.tiny(train_sim_after_cross=True)
    model = UniVL(cfg)
    opt = make_univl_optimizer(model, lr=1e-3, t_total=10)
    with pytest.raises(ValueError, match="CUDA"):
        Trainer(model, opt, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        RetrievalEvaluator(model, graph=True)
    assert Trainer(model, opt).step_route() == Trainer(model, opt, graph=False).step_route() \
        == "cpu"
    assert not RetrievalEvaluator(model).graph and not RetrievalEvaluator(model, graph=False).graph


HOST_READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__", "cpu", "numpy")


def test_evaluator_graph_functions_make_no_host_read(monkeypatch):
    """The three functions the evaluator's graphs capture (the encode and
    pooling of a batch, a stripe's rescoring against every video block, a
    host tile's cross block), run eagerly with every way of reading a
    tensor's value on the host patched to raise: their shapes, finite, the
    pooled rows of unit norm, and the stripe the tiles' scores."""
    cfg = config.UniVLConfig.tiny(train_sim_after_cross=True)
    model = UniVL(cfg).eval()
    model.load_state_dict(init_state_dict(cfg, 1), strict=True)
    ev = RetrievalEvaluator(model, batch_size=6, cross_text_block=2, cross_video_block=3)
    b = _tiny_batcher(cfg, 1, B=6).batches[0]
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.inference_mode(), monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, lambda *a, **k: pytest.fail("a host read"))
        seq, vis, text, video = ev._encode_fn(t["input_ids"], t["token_type_ids"],
                                              t["attention_mask"], t["video"], t["video_mask"])
        stripe = ev._stripe_fn(seq[:2], t["attention_mask"][:2], vis, t["video_mask"])
        tiles = [ev._block_fn(seq[:2].float(), vis[j:j + 3].float(), t["attention_mask"][:2],
                              t["video_mask"][j:j + 3]) for j in (0, 3)]
    assert seq.shape[:2] == (6, cfg.max_words) and vis.shape[:2] == (6, cfg.max_frames)
    assert text.shape == video.shape == (6, cfg.bert.hidden_size)
    torch.testing.assert_close(text.norm(dim=-1), torch.ones(6))
    assert stripe.shape == (2, 6) and torch.isfinite(stripe).all()
    torch.testing.assert_close(stripe, torch.cat(tiles, dim=1), rtol=0, atol=0)


@pytest.fixture(scope="module")
def epoch8(tmp_path_factory):
    """YouCook2-format fixtures of 8 videos x 4 clips: an epoch of 8
    update-batches of 4 clips."""
    d = tmp_path_factory.mktemp("epoch8")
    return fixtures.make_youcook(str(d), n_videos=8, clips_per_video=4, video_dim=16, seed=9)


def _epoch8_argv(kind: str, files, epoch8, out: str, *extra) -> list:
    vocab, _, howto = files
    argv = _argv(kind, (vocab, epoch8, howto), out)
    return argv + ["--epochs", "1", *extra]


def _traces(profile_dir: str) -> list:
    return sorted(glob.glob(os.path.join(profile_dir, "*.pt.trace.json")))


def _traced_steps(path: str) -> list:
    """The global steps of the trace's step ranges, in order."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(int(e["name"][len(STEP_RANGE):]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith(STEP_RANGE))


def _run_record(out: str) -> tuple:
    """The run's displayed metrics (without the clock's) and its .bin."""
    shown = [{k: v for k, v in r.items() if k not in ("ts", "clips_per_sec")}
             for r in _records(out, "train")]
    return shown, torch.load(os.path.join(out, "pytorch_model.bin.0"), weights_only=True)


@pytest.mark.parametrize("kind", ["ft_joint", "caption"])
def test_profile_dir_traces_jax_steps_and_changes_nothing(kind, files, epoch8, tmp_path,
                                                          caplog):
    """One epoch of 8 update-batches with ``--profile_dir``: one trace,
    ``rank0.<ms>.pt.trace.json``, with a range for each of global steps 2-6
    and none for any other; every displayed metric and the ``.bin``
    bitwise the run without the flag."""
    prof = str(tmp_path / "prof")
    traced, plain = str(tmp_path / "traced"), str(tmp_path / "plain")
    assert MAINS[kind](_epoch8_argv(kind, files, epoch8, traced, "--profile_dir", prof))[0] == 8
    MAINS[kind](_epoch8_argv(kind, files, epoch8, plain))
    [path] = _traces(prof)
    assert os.path.basename(path).startswith("rank0.")
    assert _traced_steps(path) == [2, 3, 4, 5, 6]
    (got, got_bin), (want, want_bin) = _run_record(traced), _run_record(plain)
    assert len(got) == 8 and got == want
    _assert_same(got_bin, want_bin, "pytorch_model.bin.0")
    written = f"profiler trace written to {prof} ({os.path.basename(path)}, exported in "
    assert sum(m.startswith(written) for m in caplog.messages) == 1


def test_profile_dir_traces_every_rank(files, epoch8, tmp_path):
    """``--n_gpu 2`` (two gloo ranks the CLI spawns, the eager route): each
    rank writes its own trace of global steps 2-6, named by its rank."""
    out, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    argv = _epoch8_argv("ft_joint", files, epoch8, out, "--n_gpu", "2", "--profile_dir", prof)
    assert task_retrieval.main(argv)[0] == 8
    traces = _traces(prof)
    assert [os.path.basename(p).split(".")[0] for p in traces] == ["rank0", "rank1"]
    assert [_traced_steps(p) for p in traces] == [[2, 3, 4, 5, 6]] * 2


def test_profile_dir_on_preemption_writes_before_the_train_state(files, epoch8, tmp_path,
                                                                 monkeypatch):
    """``--inject_preempt_after 4``: the trace of steps 2-3 is on disk when
    the train state is taken; ``--load_checkpoint`` then traces from index 2
    of the resumed part of the epoch (JAX's ``step``): global steps 6-7."""
    out, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    on_disk = []
    real = common.train_state

    def spied(trainer):
        on_disk.append([_traced_steps(p) for p in _traces(prof)])
        return real(trainer)

    monkeypatch.setattr(common, "train_state", spied)
    argv = _epoch8_argv("ft_joint", files, epoch8, out, "--profile_dir", prof)
    assert task_retrieval.main(argv + ["--inject_preempt_after", "4"])[0] == 4
    assert on_disk == [[[2, 3]]]
    resumed = str(tmp_path / "resumed")
    assert task_retrieval.main(argv[:-1] + [resumed, "--load_checkpoint"])[0] == 8
    assert [_traced_steps(p) for p in _traces(resumed)] == [[6, 7]]


def _tiny_loop(tmp_path, profile_dir: str, **kw):
    """``run_train_epochs`` over 8 batches of a tiny FT-Joint trainer."""
    layers = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                  intermediate_size=64)
    cfg = config.UniVLConfig.tiny(bert=config.BertConfig(vocab_size=64, **layers),
                                  visual=config.VisualConfig(vocab_size=32, **layers),
                                  max_words=8, max_frames=6, video_dim=16)
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    trainer = Trainer(model, make_univl_optimizer(model, lr=1e-3, t_total=10), seed=3)
    out = str(tmp_path / "run")
    return common.run_train_epochs(_loop_args(out, **kw), trainer, _tiny_batcher(cfg, 8),
                                   common.get_logger(out), torch.device("cpu"),
                                   profile_dir=profile_dir)


def test_profile_dir_on_a_raise_writes_the_steps_so_far(tmp_path):
    """The loop raises after 4 steps (``--inject_crash_after``): its
    ``finally`` writes the trace of steps 2-3."""
    prof = str(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="injected crash"):
        _tiny_loop(tmp_path, prof, inject_crash_after=4)
    assert [_traced_steps(p) for p in _traces(prof)] == [[2, 3]]


def test_profile_dir_that_cannot_be_written_raises(tmp_path):
    """A ``--profile_dir`` under a file: the run raises, nothing swallows it."""
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with pytest.raises(OSError):
        _tiny_loop(tmp_path, str(blocker / "prof"))


@pytest.mark.parametrize("kind", ["two_batches", "pretrain"])
def test_profile_dir_writes_nothing(kind, files, tmp_path):
    """An epoch of 2 update-batches never reaches index 2, and pretraining
    traces nothing (JAX's pretraining loop has no trace): no trace file."""
    out, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    if kind == "pretrain":
        argv = _argv("pretrain", files, out) + ["--epochs", "1"]
    else:  # the module's 12 clips in batches of 6
        argv = _argv("ft_joint", files, out) + ["--batch_size", "6", "--epochs", "1"]
    steps = MAINS["pretrain" if kind == "pretrain" else "ft_joint"](
        argv + ["--profile_dir", prof])[0]
    assert steps == 2 and not _traces(prof)


@pytest.mark.parametrize("raises", [False, True])
def test_trace_writes_one_file_for_the_rank(raises, tmp_path):
    """``utils/profiling.py:trace``, JAX's ``trace`` on ``torch.profiler``:
    one Chrome trace named by the rank, holding the block's ranges, written
    also when the block raises."""
    prof = str(tmp_path / "prof")
    with pytest.raises(ValueError) if raises else contextlib.nullcontext():
        with profiling.trace(prof, "cpu", rank=3):
            with torch.profiler.record_function(f"{STEP_RANGE}7"):
                torch.ones(4) @ torch.ones(4)
            if raises:
                raise ValueError("the block raised")
    [path] = _traces(prof)
    assert os.path.basename(path).startswith("rank3.") and _traced_steps(path) == [7]
