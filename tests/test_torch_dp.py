"""The port's data parallelism and ZeRO-1 on the CPU, at the tiny config in
f32: against the JAX package's dp mesh of 2 (conftest's virtual CPU
devices), against the port's own one-process runs, and through the CLI.

Every run on two ranks is spawned through a port entry point
(``univl_tpu_torch.parallel.replay``, ``probes/zero1_ab`` or a CLI), with
gloo over a FileStore in a temporary directory; the children import the
port, never JAX. Two ranks at a global micro-batch of 2b compute what one
process computes with two accumulated micro-batches of b: each rank's loss
is over its own rows (the reference's per-device negatives), and rank r's
micro-batch draws the key of micro-batch r of the accumulated run.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from univl_tpu import config as jax_config
from univl_tpu.data import batching as jax_batching
from univl_tpu.data import youcook as jax_youcook
from univl_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.parallel.mesh import make_mesh
from univl_tpu.train import optimization as jax_opt
from univl_tpu.train.trainer import Trainer as JaxTrainer
from univl_tpu.train.zero1 import make_univl_zero1_optimizer as jax_zero1_optimizer
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import (
    init_state_dict,
    jax_params_from_state_dict,
    load_reference_bin,
    state_dict_from_jax_params,
)
from univl_tpu_torch.cli import task_retrieval
from univl_tpu_torch.data import batching, fixtures, youcook
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.parallel import mesh as dp_mesh
from univl_tpu_torch.parallel import replay
from univl_tpu_torch.probes import zero1_ab
from univl_tpu_torch.train.trainer import Trainer
from univl_tpu_torch.train.zero1 import make_univl_zero1_optimizer

RANKS = 2
B = 8  # FT-Joint's global micro-batch: 4 rows a rank
CLIPS, P = 4, 3  # stage I's global micro-batch of clips, and pairs a clip
STEPS = 2
KW = dict(lr=1e-3, t_total=4, warmup_proportion=0.0, coef_lr=0.1)  # every step updates
ROUTES = {"ft_joint": {}, "stage_one": dict(do_pretrain=True, use_mil=True, n_pair=P)}
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "univl_tpu"}
# zero in exact arithmetic (a per-query constant added to every score leaves the
# softmax unchanged): both sides' gradients are rounding noise, held absolutely
ZERO_GRADS = ("attention.self.key.bias",)


def _no_dropout(cfg):
    """Dropout 0, and one text and one visual layer (the JAX mesh's compiles)."""
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return cfg.replace(bert=cfg.bert.replace(num_hidden_layers=1, **off),
                       visual=cfg.visual.replace(num_hidden_layers=1, **off),
                       cross=cfg.cross.replace(**off), decoder=cfg.decoder.replace(**off))


def _batch(cfg, rng, rows: int, pairs: int = 0):
    """One global micro-batch ``[1, rows, (pairs,) ...]`` of the five stage-one
    keys, ragged lengths (two valid tokens and one valid frame at least)."""
    s = (rows, pairs) if pairs else (rows,)
    Lw, Lv = cfg.max_words, cfg.max_frames
    am = (np.arange(Lw) < rng.randint(2, Lw + 1, s + (1,))).astype(np.int32)
    vm = (np.arange(Lv) < rng.randint(1, Lv + 1, s + (1,))).astype(np.int32)
    batch = {"input_ids": rng.randint(1, cfg.bert.vocab_size, s + (Lw,)).astype(np.int32) * am,
             "token_type_ids": np.zeros(s + (Lw,), np.int32), "attention_mask": am,
             "video": rng.randn(*s, Lv, cfg.video_dim).astype(np.float32) * vm[..., None],
             "video_mask": vm}
    return {k: v[None] for k, v in batch.items()}


def _cfgs(route: str, ranks: int = RANKS):
    """(JAX config, port config) of a route at dropout 0, a rank's batch."""
    rows = CLIPS if route == "stage_one" else B
    kw = dict(batch_size_per_device=rows // ranks, **ROUTES[route])
    return (_no_dropout(jax_config.UniVLConfig.tiny(**kw)),
            _no_dropout(config.UniVLConfig.tiny(**kw)))


def _batches(route: str, n: int, seed: int):
    jcfg, _ = _cfgs(route)
    rng = np.random.RandomState(seed)
    if route == "stage_one":
        return [_batch(jcfg, rng, CLIPS, P) for _ in range(n)]
    return [_batch(jcfg, rng, B) for _ in range(n)]


def _init(route: str):
    """The port's seeded init of a route's model (both sides start from it)."""
    return init_state_dict(_cfgs(route)[1], 5)


def _jax_mesh_runs(route: str):
    """JAX's trainer on a dp mesh of 2, replicated and ZeRO-1, from the port's
    init: {zero1: (losses, final params)}."""
    jcfg, _ = _cfgs(route)
    batches = _batches(route, STEPS, seed=1)
    jm = JaxUniVL(jcfg)
    params = jax.tree.map(jax.numpy.asarray, jax_params_from_state_dict(_init(route)))
    out = {}
    for zero1 in (False, True):
        tx = jax_zero1_optimizer(dp=RANKS, **KW) if zero1 else jax_opt.make_univl_optimizer(**KW)
        jt = JaxTrainer(jm, tx, make_mesh(RANKS), zero1=zero1, donate=False)
        state = jt.init_state(jax.random.key(0), None, params=params)
        losses = []
        for step, batch in enumerate(batches):
            state, metrics = jt.train_step(state, jt.shard_batch(batch), jax.random.key(step))
            losses.append(float(metrics["loss"]))
        out[zero1] = (losses, state_dict_from_jax_params(jax.tree.map(np.asarray, state.params)))
    return out




def _as_accum(batch, accum: int = RANKS):
    """A global micro-batch ``[1, B, ...]`` as ``accum`` micro-batches of one
    process, ``[accum, B / accum, ...]``: rank r's rows are micro-batch r."""
    return {k: v.reshape(accum, v.shape[1] // accum, *v.shape[2:]) for k, v in batch.items()}


def _own_run(zero1: bool, switch_at=None, accum: bool = False) -> dict:
    """A replay run of 3 FT-Joint steps at the tiny config's dropout 0.1, from
    the port's seeded init."""
    cfg = config.UniVLConfig.tiny(batch_size_per_device=B // RANKS)
    batches = _batches("ft_joint", 3, seed=7)
    run = {"config": cfg, "state_dict": init_state_dict(cfg, 3), "optimizer": KW,
           "batches": [_as_accum(b) for b in batches] if accum else batches, "zero1": zero1,
           "seed": 11}
    if switch_at is not None:
        run["switch_at"] = switch_at
    return run


JAX_RUNS = [(route, zero1) for route in ROUTES for zero1 in (False, True)]
OWN = {"replicated": dict(zero1=False), "zero1": dict(zero1=True),
       "zero1_then_replicated": dict(zero1=True, switch_at=2),
       "replicated_then_zero1": dict(zero1=False, switch_at=2)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every two-rank replay of this file in one spawn, started in the
    background (its ranks run beside JAX's compiles): the JAX comparisons
    (dropout 0), then the runs of ``OWN``. A future of ({name: result}, the
    ranks' reports)."""
    runs = [{"config": _cfgs(route)[1], "state_dict": _init(route), "optimizer": KW,
             "batches": _batches(route, STEPS, seed=1), "zero1": zero1}
            for route, zero1 in JAX_RUNS]
    runs += [_own_run(**kw) for kw in OWN.values()]
    spec = str(tmp_path_factory.mktemp("replay") / "spec.pt")
    torch.save(runs, spec)

    def go():
        results = replay.main(["--spec", spec, "--device", "cpu", "--n_gpu", str(RANKS)])
        return dict(zip(JAX_RUNS + list(OWN), results)), list(dp_mesh.spawn.ranks)

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(go)


@pytest.fixture(scope="module")
def jax_runs(spawned):
    return {(route, zero1): run for route in ROUTES
            for zero1, run in _jax_mesh_runs(route).items()}


@pytest.fixture(scope="module")
def two_ranks(spawned):
    return spawned.result()


def _rel(got: dict, want: dict, skip=()) -> float:
    """The largest norm-relative difference over the tensors of ``want``;
    those named in ``skip`` within 1e-8 absolutely."""
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k in want:
        diff = float((got[k].float() - want[k].float()).norm())
        if k.endswith(skip):
            assert diff < 1e-8, k
            continue
        worst = max(worst, diff / max(float(want[k].float().norm()), 1e-30))
    return worst


@pytest.mark.parametrize("zero1", [False, True], ids=["replicated", "zero1"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_dp_step_matches_jax_mesh(jax_runs, two_ranks, route, zero1):
    """Two gloo ranks of the port against JAX's trainer on a dp mesh of 2,
    from the same weights and global batches at dropout 0, 2 steps: losses
    and parameters within 1e-5 relative (JAX's own ZeRO-1 tolerance). The
    DP loss is not the one-device full-batch loss: each rank's similarity
    loss is over its own rows (stage I's MIL-NCE mask is built from
    ``batch_size_per_device``)."""
    want_losses, want = jax_runs[(route, zero1)]
    got = two_ranks[0][(route, zero1)]
    losses = [m["loss"] for m in got["metrics"]]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
    assert _rel(got["state_dict"], want, skip=ZERO_GRADS) <= 1e-5
    # the one-device full batch, through the port in this process
    _, cfg = _cfgs(route, ranks=1)
    model = UniVL(cfg).eval()
    model.load_state_dict(_init(route), strict=True)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batches(route, 1, seed=1)[0].items()}
    with torch.no_grad():
        one_device = float(model(batch)["loss"])
    assert abs(losses[0] - one_device) > 1e-3 * abs(one_device), (losses[0], one_device)


def test_children_import_only_the_port(two_ranks):
    """Each spawned rank reports the packages it imported: no JAX."""
    reports = two_ranks[1]
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert not FORBIDDEN & set(r["modules"]), r["rank"]
        assert "univl_tpu_torch" in r["modules"]


def _one_process(spec_runs, tmp_path):
    """Replay runs in this process at a rank's thread count."""
    spec = str(tmp_path / "spec.pt")
    torch.save(spec_runs, spec)
    threads = torch.get_num_threads()
    torch.set_num_threads(dp_mesh.CPU_THREADS)
    try:
        return replay.main(["--spec", spec, "--device", "cpu", "--n_gpu", "1"])
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ["replicated", "zero1"])
def test_dp_equals_accum(two_ranks, tmp_path, mode):
    """Two ranks at dropout 0.1 against one process with 2 accumulated
    micro-batches (the plain BertAdam), 3 steps: bitwise without ZeRO-1,
    within 1e-6 relative with it (the norms' sums in another order)."""
    want = _one_process([_own_run(zero1=False, accum=True)], tmp_path)[0]
    got = two_ranks[0][mode]
    if mode == "replicated":
        assert got["metrics"] == want["metrics"]
        assert all(torch.equal(got["state_dict"][k], v) for k, v in want["state_dict"].items())
        for i, st in want["optimizer"]["state"].items():
            assert all(torch.equal(got["optimizer"]["state"][i][k], st[k]) for k in st)
    else:
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   [m["loss"] for m in want["metrics"]], rtol=1e-6, atol=0)
        assert _rel(got["state_dict"], want["state_dict"], skip=ZERO_GRADS) <= 1e-6
    assert got["optimizer"]["steps"] == 3


@pytest.mark.parametrize("mode", ["zero1_then_replicated", "replicated_then_zero1"])
def test_zero1_state_crosses_layouts(two_ranks, mode):
    """After 2 steps the train state (the replicated layout, gathered from
    the shards under ZeRO-1) goes to a trainer of the other layout, which
    takes step 3: within 1e-6 relative of the run that kept its layout."""
    results = two_ranks[0]
    got = results[mode]
    want = results["zero1" if mode.startswith("zero1") else "replicated"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               [m["loss"] for m in want["metrics"]], rtol=1e-6, atol=0)
    assert _rel(got["state_dict"], want["state_dict"], skip=ZERO_GRADS) <= 1e-6
    moments = {f"{i}.{k}": t for i, st in got["optimizer"]["state"].items()
               for k, t in st.items()}
    assert _rel(moments, {f"{i}.{k}": t for i, st in want["optimizer"]["state"].items()
                          for k, t in st.items()}) <= 1e-6


def test_zero1_matches_bert_adam(tmp_path):
    """ZeRO-1 against the replicated BertAdam on the tiny model's parameters,
    on 1 rank (a gloo group of one, in this process) and 2 (spawned), 3
    steps of unit-entry gradients with the global clip at 5: both clips act.
    f32 moments: within 1e-5 of each tensor's largest magnitude (JAX's
    tolerance). bf16 moments: a gradient one ulp apart (the norms summed in
    another order) may round a moment to its neighbouring bf16 value, which
    moves an update by a bf16 ulp of m/sqrt(v) (at most ~3.2 at these
    steps): each step's difference stays within lr * 2^-7 * 3.2 of it."""
    for ranks in (1, 2):
        reports = zero1_ab.main(["--device", "cpu", "--tiny", "--n_gpu", str(ranks),
                                 "--adam_state_dtype", "float32", "bfloat16", "--steps", "3"])
        assert [r["state_dtype"] for r in reports] == ["float32", "bfloat16"]
        for rep in reports:
            assert rep["ranks"] == ranks and len(rep["steps"]) == 3
            for i, step in enumerate(rep["steps"]):
                assert step["global_clip_acted"] and step["tensors_clipped"] > 0
                if rep["state_dtype"] == "float32":
                    assert step["max_rel_diff"] <= 1e-5, (ranks, step)
                else:
                    assert step["max_abs_diff"] <= i * 1e-3 * 2 ** -7 * 3.2, (ranks, step)


def test_zero1_step_leaves_no_stale_grad():
    """The trainer takes ZeRO-1 from the optimizer's type. Its step gathers
    the new parameters into the gradient buffer, whose views are the
    parameters' ``.grad``: after each step every ``.grad`` is None, not a
    view holding parameter values; the next step's gradients are fresh."""
    cfg = config.UniVLConfig.tiny(batch_size_per_device=B)
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 3))
    trainer = Trainer(model, make_univl_zero1_optimizer(model, None, **KW), seed=11)
    assert trainer.zero1
    for step, batch in enumerate(_batches("ft_joint", 2, seed=7)):
        before = [p.detach().clone() for p in model.parameters()]
        loss = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, step)
        assert np.isfinite(float(loss["loss"]))
        assert all(p.grad is None for p in model.parameters())
        assert any(not torch.equal(p, b) for p, b in zip(model.parameters(), before))


@pytest.fixture(scope="module")
def youcook_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("youcook_dp")
    csv, data, feats = fixtures.make_youcook(str(d), n_videos=5, clips_per_video=3,
                                             video_dim=16, seed=3)
    return csv, data, feats, fixtures.make_vocab(str(d / "vocab.txt"))


@pytest.mark.parametrize("accum", [1, 2])
def test_batcher_process_slices(youcook_files, accum):
    """Each rank's slice of every update-batch (the last one wrap-padded)
    equals JAX's ``process_index`` slice, and the slices joined equal JAX's
    global batch (the padding past a short last one aside)."""
    csv, data, feats, vocab = youcook_files
    kw = dict(max_words=12, max_frames=6, seed=9)
    ds = youcook.YoucookRetrievalDataset(csv, data, feats, WordPieceTokenizer(vocab), **kw)
    jds = jax_youcook.YoucookRetrievalDataset(csv, data, feats, JaxTokenizer(vocab), **kw)
    bkw = dict(shuffle=True, seed=5, drop_last=False, grad_accum=accum, num_workers=2)
    keys = ds[0].keys()
    glob = list(jax_batching.Batcher(jds, 4, **bkw).epoch(1))
    ranks = [list(batching.Batcher(ds, 4, process_index=r, process_count=2, **bkw).epoch(1))
             for r in range(2)]
    jranks = [list(jax_batching.Batcher(jds, 4, process_index=r, process_count=2, **bkw)
                   .epoch(1)) for r in range(2)]
    assert len(glob) == len(ranks[0]) == len(ranks[1]) == 4 // accum
    axis = 1 if accum > 1 else 0
    for i, want in enumerate(glob):
        for k in keys:
            joined = np.concatenate([ranks[0][i][k], ranks[1][i][k]], axis=axis)
            # JAX pads a short last batch only when it splits it
            full = want[k].shape[axis] == joined.shape[axis]
            assert np.array_equal(joined if full else joined[:len(want[k])], want[k]), k
            for r in range(2):
                assert np.array_equal(ranks[r][i][k], jranks[r][i][k]), (r, k)


def _cli_argv(files, out, *extra):
    csv, data, feats, vocab = files
    return ["--do_train", "--device", "cpu", "--vocab_file", vocab, "--train_csv", csv,
            "--data_path", data, "--features_path", feats, "--output_dir", out,
            "--max_words", "12", "--max_frames", "6", "--video_dim", "16", "--hidden_size", "32",
            "--num_attention_heads", "4", "--intermediate_size", "64",
            "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
            "--batch_size", "6", "--epochs", "1", "--n_display", "1", "--lr", "1e-3",
            "--num_thread_reader", "2", *extra]


def test_cli_zero1_on_two_ranks_resumes(youcook_files, tmp_path):
    """``task_retrieval --n_gpu 2 --zero1`` starts its two ranks itself: 2
    steps, then the same run preempted after step 1 and resumed. Rank 0
    alone writes: one metrics.jsonl, one log, one set of .bin files. The
    resumed run's weights, moments and losses are the uninterrupted run's,
    bitwise."""
    full, out = str(tmp_path / "full"), str(tmp_path / "out")
    dp = ["--n_gpu", "2", "--zero1"]
    assert task_retrieval.main(_cli_argv(youcook_files, full, *dp)) == (2, None)
    for r in dp_mesh.spawn.ranks:
        assert not FORBIDDEN & set(r["modules"])
    assert task_retrieval.main(_cli_argv(youcook_files, out, *dp,
                                         "--inject_preempt_after", "1"))[0] == 1
    meta = json.load(open(os.path.join(out, "train_state.pt.json")))
    assert meta["preempted"] and meta["global_step"] == 1
    assert task_retrieval.main(_cli_argv(youcook_files, out, *dp, "--load_checkpoint"))[0] == 2
    for d in (full, out):
        assert sorted(os.listdir(d)) == ["args.json", "log.txt", "metrics.jsonl",
                                         "pytorch_model.bin.0", "train_state.pt",
                                         "train_state.pt.json"]
    want, got = (load_reference_bin(os.path.join(d, "pytorch_model.bin.0")) for d in (full, out))
    assert all(torch.equal(got[k], want[k]) for k in want)
    states = [torch.load(os.path.join(d, "train_state.pt"), weights_only=True)["optimizer"]
              for d in (full, out)]
    assert states[0]["steps"] == states[1]["steps"] == 2
    for i, st in states[0]["state"].items():
        assert all(torch.equal(states[1]["state"][i][k], st[k]) for k in st)

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [(r["step"], r["loss"]) for r in map(json.loads, f) if r["kind"] == "train"]

    assert losses(full) == [(1, losses(out)[0][1]), (2, losses(out)[1][1])]


@pytest.mark.parametrize("extra", [
    ["--tensor_parallel", "3", "--n_gpu", "2", "--zero1"],  # tp must divide the ranks
    ["--tensor_parallel", "3", "--n_gpu", "2", "--sequence_parallel"],
    ["--n_gpu", "-1"],
])
def test_cli_refuses_across_ranks(youcook_files, tmp_path, extra, capsys):
    with pytest.raises(SystemExit) as e:
        task_retrieval.main(_cli_argv(youcook_files, str(tmp_path / "out"), *extra))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert extra[0] in err and ("must divide mesh size 2" in err or extra[0] == "--n_gpu")
    assert not (tmp_path / "out").exists()


def test_cli_refuses_more_ranks_than_cards(youcook_files, tmp_path, capsys, monkeypatch):
    """Two NCCL ranks on one card: refused unless --dist_backend gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = [a if a != "cpu" else "cuda" for a in _cli_argv(youcook_files,
                                                             str(tmp_path / "out"))]
    with pytest.raises(SystemExit) as e:
        task_retrieval.main(argv + ["--n_gpu", "2"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--n_gpu 2" in err and "1 CUDA card" in err and "--dist_backend gloo" in err
    assert not (tmp_path / "out").exists()
