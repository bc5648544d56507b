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
"""

import copy
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
