"""The port's input pipeline and local configs on the CPU: ``cast_floats``,
``prefetch_to_device`` (order, both ``put_in_worker`` modes, errors, an
early close), ``DeviceTransfer`` and ``common.make_input_iter`` against the
synchronous copy, ``--no_prefetch`` and ``--transfer_dtype`` through the
retrieval CLI, eval batches through the prefetch, ``cached_path``, and
``build_config`` from ``--bert_model`` and the other config directories
against the JAX package's. The counterparts of tests/test_data.py's
prefetch tests and tests/test_utils.py's.
"""

import dataclasses
import json
import os
import tarfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from univl_tpu.cli import common as jax_common
from univl_tpu_torch.cli import common, task_retrieval
from univl_tpu_torch.data import batching, fixtures
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.data.youcook import YoucookRetrievalDataset
from univl_tpu_torch.utils.file_utils import cached_path


@pytest.fixture(scope="module")
def youcook_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("youcook_pipeline")
    csv, data, feats = fixtures.make_youcook(str(d), n_videos=5, clips_per_video=3,
                                             video_dim=16, seed=2)
    return csv, data, feats, fixtures.make_vocab(str(d / "vocab.txt"))


@pytest.fixture(scope="module")
def dataset(youcook_files):
    csv, data, feats, vocab = youcook_files
    return YoucookRetrievalDataset(csv, data, feats, WordPieceTokenizer(vocab), max_words=12,
                                   max_frames=6)


def _same(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)


def test_cast_floats_touches_float32_only():
    batch = {"video": np.random.RandomState(0).randn(2, 3, 4).astype(np.float32),
             "ids": np.ones((2, 3), np.int32), "f64": np.ones(2, np.float64)}
    out = batching.cast_floats(batch, "bfloat16")
    assert out["video"].dtype == torch.bfloat16
    assert out["ids"] is batch["ids"] and out["f64"] is batch["f64"]
    np.testing.assert_allclose(out["video"].float().numpy(), batch["video"], rtol=8e-3)
    assert batching.cast_floats(batch, "float32") is batch


@pytest.mark.parametrize("put_in_worker", [True, False])
def test_prefetch_gives_the_same_batches_in_order(dataset, put_in_worker):
    b = batching.Batcher(dataset, batch_size=4, shuffle=True, seed=3)
    want = list(b.epoch(1))
    got = list(batching.prefetch_to_device(b.epoch(1), put_in_worker=put_in_worker))
    assert len(got) == len(want) == len(dataset) // 4
    assert all(_same(x, y) for x, y in zip(got, want))
    doubled = batching.prefetch_to_device(iter(range(7)), put=lambda x: x * 2,
                                          put_in_worker=put_in_worker, ready=lambda x: x + 1)
    assert list(doubled) == [1, 3, 5, 7, 9, 11, 13]


@pytest.mark.parametrize("put_in_worker", [True, False])
def test_prefetch_raises_the_workers_error(put_in_worker):
    def reader():
        yield {"a": np.zeros(1)}
        raise RuntimeError("reader died")

    it = batching.prefetch_to_device(reader(), put_in_worker=put_in_worker)
    next(it)
    with pytest.raises(RuntimeError, match="reader died"):
        list(it)


def test_prefetch_early_close_stops_the_worker(dataset):
    """Closing the generator after one batch (a preemption's return) ends
    the worker thread and closes the source, whose batcher stops fetching."""
    closed = []

    def source():
        try:
            yield from batching.Batcher(dataset, batch_size=2, shuffle=False).epoch(0)
        finally:
            closed.append(True)

    it = batching.prefetch_to_device(source(), size=1)
    next(it)
    it.close()
    deadline = time.time() + 10
    while time.time() < deadline and any(t.name == "prefetch_to_device" and t.is_alive()
                                         for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "prefetch_to_device" and t.is_alive()
                   for t in threading.enumerate())
    assert closed == [True]


def _args(**kw):
    return SimpleNamespace(**{"gradient_accumulation_steps": 1, "transfer_dtype": "float32",
                              "no_prefetch": False, **kw})


@pytest.mark.parametrize("accum", [1, 2])
def test_make_input_iter_prefetched_equals_the_synchronous_copy(dataset, accum):
    """The prefetched batches (DeviceTransfer in the worker) are the
    --no_prefetch ones, tensor for tensor, each with the micro-batch axis
    the trainer reads; with --transfer_dtype bfloat16 only the float arrays
    change, to their bf16 rounding."""
    b = batching.Batcher(dataset, batch_size=2, shuffle=True, seed=1, grad_accum=accum)
    cpu = torch.device("cpu")
    fast = list(common.make_input_iter(_args(gradient_accumulation_steps=accum), b, 0, cpu,
                                       start_batch=1))
    slow = list(common.make_input_iter(_args(gradient_accumulation_steps=accum,
                                             no_prefetch=True), b, 0, cpu, start_batch=1))
    assert len(fast) == len(slow) == len(b) - 1
    assert all(_same(x, y) for x, y in zip(fast, slow))
    assert all(v.shape[:2] == (accum, 2) for v in fast[0].values())
    bf16 = list(common.make_input_iter(_args(gradient_accumulation_steps=accum,
                                             transfer_dtype="bfloat16"), b, 0, cpu,
                                       start_batch=1))
    for x, y in zip(bf16, slow):
        assert x["video"].dtype == torch.bfloat16
        assert torch.equal(x["video"], y["video"].to(torch.bfloat16))
        assert _same({k: v for k, v in x.items() if k != "video"},
                     {k: v for k, v in y.items() if k != "video"})


def _cli_argv(files, out, *extra):
    csv, data, feats, vocab = files
    return ["--do_train", "--device", "cpu", "--vocab_file", vocab, "--train_csv", csv,
            "--val_csv", csv, "--data_path", data, "--features_path", feats,
            "--output_dir", out, "--max_words", "12", "--max_frames", "6", "--video_dim", "16",
            "--hidden_size", "32", "--num_attention_heads", "4", "--intermediate_size", "64",
            "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
            "--batch_size", "4", "--batch_size_val", "5", "--epochs", "1", "--n_display", "1",
            "--lr", "1e-3", "--num_thread_reader", "2", *extra]


def _train_losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f) if r["kind"] == "train"]


@pytest.fixture(scope="module")
def prefetched_run(youcook_files, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("prefetched"))
    steps, metrics = task_retrieval.main(_cli_argv(youcook_files, out, "--do_eval"))
    return out, steps, metrics


def test_no_prefetch_trains_and_evaluates_bitwise_alike(youcook_files, prefetched_run,
                                                        tmp_path):
    """The retrieval CLI with --do_train --do_eval: its default (training
    and eval batches through the prefetch) and --no_prefetch give the same
    losses, weights and eval metrics, bitwise."""
    out, steps, metrics = prefetched_run
    sync = str(tmp_path / "sync")
    steps2, metrics2 = task_retrieval.main(_cli_argv(youcook_files, sync, "--do_eval",
                                                     "--no_prefetch"))
    assert steps == steps2 == 3 and _train_losses(out) == _train_losses(sync)
    want, got = (torch.load(os.path.join(d, "pytorch_model.bin.0"), weights_only=True)
                 for d in (sync, out))
    assert all(torch.equal(got[k], want[k]) for k in want)
    keys = ("R1", "R5", "R10", "MR", "MeanR")
    assert {k: metrics[k] for k in keys} == {k: metrics2[k] for k in keys}


def test_transfer_dtype_bfloat16_trains(youcook_files, prefetched_run, tmp_path):
    """--transfer_dtype bfloat16: the features cross over in bf16, the model
    takes them to f32 before its feature LayerNorm; the losses stay finite
    and within 1e-2 of the f32 transfer's."""
    out = str(tmp_path / "bf16")
    assert task_retrieval.main(_cli_argv(youcook_files, out, "--transfer_dtype",
                                         "bfloat16"))[0] == 3
    got, want = _train_losses(out), _train_losses(prefetched_run[0])
    assert [s for s, _ in got] == [s for s, _ in want]
    assert all(np.isfinite(a) and abs(a - b) <= 1e-2 * abs(b)
               for (_, a), (_, b) in zip(got, want))


# ----------------------------------------------------------- cached_path


def test_cached_path_local(tmp_path):
    f = tmp_path / "x.txt"
    f.write_text("hi")
    assert cached_path(str(f)) == str(f)
    assert cached_path(f"file://{f}") == str(f)


def test_cached_path_remote_raises():
    for url in ("https://example.com/model.tar.gz", "http://example.com/v.txt",
                "s3://bucket/model.tar.gz"):
        with pytest.raises(OSError, match="zero-egress"):
            cached_path(url)


def test_cached_path_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        cached_path(str(tmp_path / "nope"))


def test_cached_path_extracts_an_archive_once(tmp_path):
    src = tmp_path / "m"
    src.mkdir()
    (src / "config.json").write_text("{}")
    tar_path = tmp_path / "model.tar.gz"
    with tarfile.open(tar_path, "w:gz") as t:
        t.add(src / "config.json", arcname="config.json")
    out1 = cached_path(str(tar_path), cache_dir=str(tmp_path / "cache"))
    assert os.path.exists(os.path.join(out1, "config.json"))
    os.remove(os.path.join(out1, "config.json"))  # a second call does not extract again
    assert cached_path(str(tar_path), cache_dir=str(tmp_path / "cache")) == out1
    assert not os.path.exists(os.path.join(out1, "config.json"))


# ---------------------------------------------------------- local configs


def _write_configs(d):
    configs = {
        "bert": {"vocab_size": 999, "hidden_size": 96, "num_hidden_layers": 7,
                 "num_attention_heads": 4, "intermediate_size": 222,
                 "max_position_embeddings": 512, "type_vocab_size": 2, "unused_key": 1},
        "visual": {"vocab_size": 16, "hidden_size": 96, "num_hidden_layers": 5,
                   "num_attention_heads": 4, "intermediate_size": 200,
                   "hidden_dropout_prob": 0.2},
        "cross": {"hidden_size": 96, "num_hidden_layers": 4, "num_attention_heads": 4,
                  "intermediate_size": 200, "max_position_embeddings": 256},
        "decoder": {"hidden_size": 96, "num_attention_heads": 4, "intermediate_size": 200,
                    "max_target_embeddings": 64, "num_decoder_layers": 9},
    }
    dirs = {}
    for kind, fields in configs.items():
        p = d / f"{kind}-local"
        p.mkdir()
        (p / f"{kind}_config.json").write_text(json.dumps(fields))
        dirs[kind] = str(p)
    return dirs


@pytest.mark.parametrize("extra", [[], ["--hidden_size", "64", "--remat", "--remat_policy",
                                        "dots"]])
def test_build_config_from_local_configs_equals_jax(tmp_path, extra):
    """``--bert_model`` and the other three directories, with the CLI's
    layer counts on top (and with width flags after them): the port's
    build_config equals JAX's for the same argv, field by field."""
    dirs = _write_configs(tmp_path)
    argv = ["--do_train", "--output_dir", str(tmp_path / "o"), "--max_words", "16",
            "--max_frames", "12", "--video_dim", "16", "--text_num_hidden_layers", "3",
            "--visual_num_hidden_layers", "2", "--cross_num_hidden_layers", "1",
            "--decoder_num_hidden_layers", "2", "--bert_model", dirs["bert"],
            "--visual_model", dirs["visual"], "--cross_model", dirs["cross"],
            "--decoder_model", dirs["decoder"], "--vocab_file", "v.txt", *extra]
    jargs = jax_common.finalize_args(jax_common.base_parser("t").parse_args(argv + [
        "--n_gpu", "1"]))
    args = common.finalize_args(task_retrieval.parse_args(argv))
    for vocab_size in (None, 777):
        want = dataclasses.asdict(jax_common.build_config(jargs, vocab_size=vocab_size))
        got = dataclasses.asdict(common.build_config(args, torch.device("cpu"),
                                                     vocab_size=vocab_size))
        assert got == want
    assert got["bert"]["num_hidden_layers"] == 3 and got["decoder"]["num_decoder_layers"] == 2


def test_build_config_reads_a_config_archive(tmp_path):
    """A ``--bert_model`` .tar.gz is extracted under ``--cache_dir`` and read
    as its directory would be."""
    dirs = _write_configs(tmp_path)
    tar_path = tmp_path / "bert.tar.gz"
    with tarfile.open(tar_path, "w:gz") as t:
        t.add(os.path.join(dirs["bert"], "bert_config.json"), arcname="bert_config.json")
    base = ["--do_train", "--output_dir", str(tmp_path / "o"), "--vocab_file", "v.txt"]
    from_dir = common.build_config(task_retrieval.parse_args(
        base + ["--bert_model", dirs["bert"]]), torch.device("cpu"))
    from_tar = common.build_config(task_retrieval.parse_args(
        base + ["--bert_model", str(tar_path), "--cache_dir", str(tmp_path / "cache")]),
        torch.device("cpu"))
    assert from_tar == from_dir and from_tar.bert.intermediate_size == 222
    assert os.listdir(tmp_path / "cache")
