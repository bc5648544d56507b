"""The port's tensor and sequence parallelism and ZeRO-1 under them, on the
CPU, at a tiny config in f32: against the JAX package's (dp, tp) mesh
(``make_mesh_2d``, conftest's virtual CPU devices), against the port's own
dp-only runs, and through the three CLIs.

The contract is JAX's (``tests/test_tp.py``): a (dp, tp) run computes what a
dp-only run of the same dp size computes; tp and sp only partition the
math. Every multi-rank run is spawned through a port entry point
(``univl_tpu_torch.parallel.replay`` or a CLI) with gloo over a FileStore;
the children import the port, never JAX. The FFN takes the block route
(#4 and #5 split at the row-parallel product; their plain versions here), at
hidden 128, the kernels' gate. Against JAX the dropout is 0 (the TPU's
dropout bits cannot be reproduced); against the port's dp-only runs it is the
config's 0.1, so the full-shape draws, #2's head offset and #4's and #5's row
offset are held to the unsplit run's masks.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from univl_tpu import config as jax_config
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.parallel.mesh import make_mesh
from univl_tpu.parallel.tp import make_mesh_2d, param_pspecs
from univl_tpu.train import optimization as jax_opt
from univl_tpu.train.trainer import Trainer as JaxTrainer
from univl_tpu.train.zero1_tp import make_univl_zero1_tp_optimizer as jax_zero1_tp_optimizer
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import (
    init_state_dict,
    jax_params_from_state_dict,
    jax_path,
    load_reference_bin,
    state_dict_from_jax_params,
)
from univl_tpu_torch.cli import pretrain, task_caption, task_retrieval
from univl_tpu_torch.data import fixtures
from univl_tpu_torch.kernels import ffn
from univl_tpu_torch.kernels import train_attention as ta
from univl_tpu_torch.kernels.philox import DENSE_BLOCK_TAG, FFN_BLOCK_TAG, row_dropout_keep
from univl_tpu_torch.parallel import mesh as dp_mesh
from univl_tpu_torch.parallel import replay
from univl_tpu_torch.parallel.tp import param_layout

STEPS = 2
KW = dict(lr=1e-3, t_total=4, warmup_proportion=0.0, coef_lr=0.1)  # every step updates
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "univl_tpu"}
# zero in exact arithmetic (a per-query constant added to every score leaves the
# softmax unchanged): both sides' gradients are rounding noise, held absolutely
ZERO_GRADS = ("attention.self.key.bias", "att.key.bias")
ROUTES = ("ft_joint", "ft_align")
B = 8  # the global micro-batch: 4 rows a dp rank at dp 2


def _cfg(mod, route: str, dp: int, dropout: bool = False, rows: int = B):
    """JAX's or the port's tiny config at hidden 128 (the fused FFN's gate),
    one layer a tower; FT-Align on the block route; dropout 0 unless asked."""
    kw = dict(batch_size_per_device=rows // dp)
    if route == "ft_align":
        kw.update(train_sim_after_cross=True, use_fused_ffn="block")
    elif route == "caption":
        kw.update(stage_two=True, task_type="caption")
    elif route == "stage_two":
        kw.update(stage_two=True, do_pretrain=True, use_mil=True)
    cfg = mod.UniVLConfig.tiny(**kw)
    arch = dict(hidden_size=128, intermediate_size=256)
    if not dropout:
        arch.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return cfg.replace(bert=cfg.bert.replace(num_hidden_layers=1, **arch),
                       visual=cfg.visual.replace(num_hidden_layers=1, **arch),
                       cross=cfg.cross.replace(num_hidden_layers=1, **arch),
                       decoder=cfg.decoder.replace(num_decoder_layers=1, **arch))


def _batch(cfg, rng, rows: int, route: str):
    """One global micro-batch ``[1, rows, ...]``, ragged lengths; the
    caption and pretraining keys where the route reads them."""
    Lw, Lv = cfg.max_words, cfg.max_frames
    am = (np.arange(Lw) < rng.randint(2, Lw + 1, (rows, 1))).astype(np.int32)
    vm = (np.arange(Lv) < rng.randint(1, Lv + 1, (rows, 1))).astype(np.int32)
    V = cfg.bert.vocab_size
    batch = {"input_ids": rng.randint(1, V, (rows, Lw)).astype(np.int32) * am,
             "token_type_ids": np.zeros((rows, Lw), np.int32), "attention_mask": am,
             "video": rng.randn(rows, Lv, cfg.video_dim).astype(np.float32) * vm[..., None],
             "video_mask": vm}
    if route in ("caption", "stage_two"):
        batch.update(input_caption_ids=rng.randint(1, V, (rows, Lw)).astype(np.int32) * am,
                     output_caption_ids=rng.randint(1, V, (rows, Lw)).astype(np.int32) * am,
                     decoder_mask=am.copy())
    if route == "stage_two":
        batch.update(masked_text=batch["input_ids"].copy(),
                     token_labels=np.where(rng.rand(rows, Lw) < 0.3, batch["input_ids"],
                                           -1).astype(np.int32),
                     masked_video=batch["video"].copy(),
                     video_labels_index=np.where(rng.rand(rows, Lv) < 0.3, np.arange(Lv),
                                                 -1).astype(np.int32))
    return {k: v[None] for k, v in batch.items()}


def _batches(route: str, seed: int = 1):
    rng = np.random.RandomState(seed)
    rows = 4 if route in ("caption", "stage_two") else B
    cfg = _cfg(config, route, 1, rows=rows)
    return [_batch(cfg, rng, rows, route) for _ in range(STEPS)]


def _init(route: str, rows: int = B):
    return init_state_dict(_cfg(config, route, 1, rows=rows), 5)


def _run(route: str, dp: int, dropout: bool = False, zero1: bool = False) -> dict:
    rows = 4 if route in ("caption", "stage_two") else B
    return {"config": _cfg(config, route, dp, dropout, rows), "state_dict": _init(route, rows),
            "optimizer": KW, "batches": _batches(route), "zero1": zero1, "seed": 11}


# the port's runs, by spawn: (n_gpu, tp, sp) -> [(name, route, dropout, zero1)]
SPAWNS = {
    (2, 1, False): [(f"{r}_dp", r, True, False) for r in ROUTES],
    (2, 2, False): ([(f"{r}_jax", r, False, False) for r in ROUTES]
                    + [(f"{r}_own", r, True, False) for r in ROUTES]),
    (2, 2, True): ([(f"{r}_jax", r, False, False) for r in ROUTES]
                   + [(f"{r}_own", r, True, False) for r in ROUTES]),
    (4, 2, False): ([(f"{r}_jax", r, False, False) for r in ROUTES]
                    + [(f"{r}_own", r, True, False) for r in ROUTES]
                    + [("ft_align_zero1", "ft_align", False, True),
                       ("caption_jax", "caption", False, False),
                       ("stage_two_jax", "stage_two", False, False)]),
    (4, 2, True): ([(f"{r}_jax", r, False, False) for r in ROUTES]
                   + [(f"{r}_own", r, True, False) for r in ROUTES]
                   + [("ft_align_zero1", "ft_align", False, True)]),
}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every multi-rank replay of this file, one spawn a layout, in the
    background (beside JAX's compiles): {(n_gpu, tp, sp): ({name: result},
    the ranks' reports)}."""
    d = tmp_path_factory.mktemp("tp_replay")

    def go():
        out = {}
        for (n, tp, sp), runs in SPAWNS.items():
            dp = n // tp
            spec = str(d / f"spec_{n}_{tp}_{int(sp)}.pt")
            torch.save([_run(route, dp, dropout, zero1) for _, route, dropout, zero1 in runs],
                       spec)
            argv = ["--spec", spec, "--device", "cpu", "--n_gpu", str(n),
                    "--tensor_parallel", str(tp)] + (["--sequence_parallel"] if sp else [])
            results = replay.main(argv)
            out[n, tp, sp] = (dict(zip([r[0] for r in runs], results)),
                              list(dp_mesh.spawn.ranks))
        return out

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(go)


@pytest.fixture(scope="module")
def runs(spawned):
    return spawned.result()


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The dp-1 runs at dropout 0.1 in this process (a rank's threads)."""
    spec = str(tmp_path_factory.mktemp("tp_one") / "spec.pt")
    torch.save([_run(r, 1, True) for r in ROUTES], spec)
    threads = torch.get_num_threads()
    torch.set_num_threads(dp_mesh.CPU_THREADS)
    try:
        return dict(zip(ROUTES, replay.main(["--spec", spec, "--device", "cpu", "--n_gpu", "1"])))
    finally:
        torch.set_num_threads(threads)


def _jax_run(route: str, dp: int, tp: int, zero1: bool = False):
    """JAX's trainer on a (dp, tp) mesh from the port's init, dropout 0:
    (losses, final state dict). At dp 1 on one device: JAX's trainer on a
    (1, 2) mesh stops in XLA's SPMD partitioner here ("Cross-partition
    allreduce must be in (partial) manual partitioning mode"), and JAX's
    contract (``tests/test_tp.py``) is that dp x tp computes what dp does."""
    rows = 4 if route in ("caption", "stage_two") else B
    jcfg = _cfg(jax_config, route, dp, rows=rows)
    params = jax.tree.map(jax.numpy.asarray, jax_params_from_state_dict(_init(route, rows)))
    tx = (jax_zero1_tp_optimizer(dp=dp, tp=tp, **KW) if zero1
          else jax_opt.make_univl_optimizer(**KW))
    mesh = make_mesh_2d(dp, tp) if dp > 1 else make_mesh(1)
    jt = JaxTrainer(JaxUniVL(jcfg), tx, mesh, zero1=zero1, donate=False)
    state = jt.init_state(jax.random.key(0), None, params=params)
    losses = []
    for step, batch in enumerate(_batches(route)):
        state, metrics = jt.train_step(state, jt.shard_batch(batch), jax.random.key(step))
        losses.append(float(metrics["loss"]))
    return losses, state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))


def _same_trajectory(p0: dict, want: dict, got: dict) -> None:
    """``tests/test_tp.py:_assert_same_trajectory``'s rule: each tensor's
    difference within 5% of how far it moved in the reference run (floor
    1e-7); the cancelling gradients' tensors within 1e-7 absolutely. The slow
    text group (coef_lr 0.1) must have moved."""
    assert sorted(got) == sorted(want)
    bad, text_moved = [], 0.0
    for k, w in want.items():
        diff = float((got[k] - w).abs().max())
        if k.endswith(ZERO_GRADS):
            if diff > 1e-7:
                bad.append((k, diff, 0.0))
            continue
        moved = float((w - p0[k]).abs().max())
        if diff > max(1e-7, 0.05 * moved):
            bad.append((k, diff, moved))
        if k.startswith("bert."):
            text_moved = max(text_moved, moved)
    assert not bad, sorted(bad, key=lambda kv: -kv[1])[:5]
    assert text_moved > 1e-6, text_moved


JAX_MESHES = [(route, n, sp) for route in ROUTES for n in (2, 4) for sp in (False, True)]


@pytest.fixture(scope="module")
def jax_runs(spawned):
    out = {(route, dp): _jax_run(route, dp, 2) for route in ROUTES for dp in (1, 2)}
    out["ft_align", 2, "zero1"] = _jax_run("ft_align", 2, 2, zero1=True)
    out["caption", 2] = _jax_run("caption", 2, 2)
    out["stage_two", 2] = _jax_run("stage_two", 2, 2)
    return out


@pytest.mark.parametrize("route,n,sp", JAX_MESHES,
                         ids=[f"{r}-dp{n // 2}xtp2{'-sp' if s else ''}" for r, n, s in JAX_MESHES])
def test_tp_matches_jax_mesh(jax_runs, runs, route, n, sp):
    """dp x tp 2 of the port (gloo ranks) against JAX's trainer on the same
    (dp, tp) mesh (at dp 1 on one device, ``_jax_run``), from the same
    weights and batches at dropout 0, 2 steps: losses within 1e-5 relative,
    the parameters by the trajectory rule. With --sequence_parallel against
    the same JAX run (SP changes no number)."""
    want_losses, want = jax_runs[route, n // 2]
    got = runs[n, 2, sp][0][f"{route}_jax"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], want_losses, rtol=1e-5)
    _same_trajectory(_init(route), want, got["state_dict"])


@pytest.mark.parametrize("route,n,sp", JAX_MESHES,
                         ids=[f"{r}-dp{n // 2}xtp2{'-sp' if s else ''}" for r, n, s in JAX_MESHES])
def test_tp_follows_dp_only(one_rank, runs, route, n, sp):
    """dp x tp 2 against the port's dp-only run of the same dp size at the
    config's dropout 0.1: the tp ranks draw the unsplit run's masks (full-shape
    draws, #2's head offset, #4's and #5's row offset), so the losses agree
    within 1e-5 and the parameters by the trajectory rule."""
    want = one_rank[route] if n == 2 else runs[2, 1, False][0][f"{route}_dp"]
    got = runs[n, 2, sp][0][f"{route}_own"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               [m["loss"] for m in want["metrics"]], rtol=1e-5)
    _same_trajectory(_init(route), want["state_dict"], got["state_dict"])


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_zero1_tp_matches_jax(jax_runs, runs, sp):
    """--zero1 on (dp 2, tp 2) against JAX's ``make_univl_zero1_tp_optimizer``
    on the same mesh (FT-Align, dropout 0): losses within 1e-5, parameters by
    the trajectory rule, the moments gathered into the tp=1 layout."""
    want_losses, want = jax_runs["ft_align", 2, "zero1"]
    got = runs[4, 2, sp][0]["ft_align_zero1"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], want_losses, rtol=1e-5)
    _same_trajectory(_init("ft_align"), want, got["state_dict"])
    replicated = runs[4, 2, sp][0]["ft_align_jax"]["optimizer"]["state"]
    assert got["optimizer"]["steps"] == STEPS
    for i, st in replicated.items():
        for k in ("m", "v"):
            assert got["optimizer"]["state"][i][k].shape == st[k].shape


@pytest.mark.parametrize("route", ["caption", "stage_two"])
def test_vocab_parallel_paths_match_jax(jax_runs, runs, route):
    """Stage-two caption fine-tuning (the decoder's split attention and FFN,
    the vocab-parallel lookup, logits and cross entropy) and pretraining stage
    II (the vocab-sharded masked-language head) on (dp 2, tp 2) against
    JAX's mesh of that shape, dropout 0: losses within 1e-5, parameters by
    the trajectory rule."""
    want_losses, want = jax_runs[route, 2]
    got = runs[4, 2, False][0][f"{route}_jax"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], want_losses, rtol=1e-5)
    _same_trajectory(_init(route, 4), want, got["state_dict"])


def test_children_import_only_the_port(runs):
    """Each spawned rank reports the packages it imported: no JAX."""
    for _, reports in runs.values():
        for r in reports:
            assert not FORBIDDEN & set(r["modules"]), r["rank"]
            assert "univl_tpu_torch" in r["modules"]


@pytest.mark.parametrize("tp", [2, 4])
def test_param_layout_matches_jax_pspecs(tp):
    """``param_layout`` at tp 2 and 4 against JAX's ``param_pspecs`` through
    the converter's name map, stage II with the decoder (every kind of
    split), at a vocab of 514: split at tp 2, indivisible (replicated) at 4."""
    jcfg = jax_config.UniVLConfig.tiny(stage_two=True, do_pretrain=True, use_mil=True)
    V = 514
    jcfg = jcfg.replace(bert=jcfg.bert.replace(vocab_size=V),
                        decoder=jcfg.decoder.replace(vocab_size=V))
    cfg = config.UniVLConfig.tiny(stage_two=True, do_pretrain=True, use_mil=True)
    cfg = cfg.replace(bert=cfg.bert.replace(vocab_size=V),
                      decoder=cfg.decoder.replace(vocab_size=V))
    sd = init_state_dict(cfg, 0)
    specs = param_pspecs(jax_params_from_state_dict(sd), tp)
    layout = param_layout(cfg, {k: tuple(v.shape) for k, v in sd.items()}, tp)
    split = 0
    for name, dim in layout.items():
        node = specs
        for key in jax_path(name).split("/"):
            node = node[key]
        jdim = next((i for i, a in enumerate(node) if a is not None), None)
        if jdim is not None and jax_path(name).endswith("kernel"):
            jdim = 1 - jdim  # nn.Linear's weight is the kernel transposed
        assert dim == jdim, (name, dim, node)
        split += dim is not None
    assert split > 0
    vocab = layout["bert.embeddings.word_embeddings.weight"]
    assert vocab == (0 if tp == 2 else None)
    assert layout["cls.predictions.bias"] == vocab
    assert layout["decoder.classifier.cls.predictions.bias"] == vocab
    assert layout["bert.encoder.layer.0.attention.output.dense.weight"] == 1
    assert layout["bert.encoder.layer.0.output.LayerNorm.weight"] is None


# ------------------------------------------------------------ the plain versions


def test_attention_head0_mask_is_the_calls_slice():
    """#2's keep mask of heads [h0, h0 + h) equals those heads of the whole
    call's mask, and so do the forward's output and the backward's gradients
    of a call on those heads."""
    torch.manual_seed(0)
    Bn, H, L, D = 2, 4, 12, 8
    full = ta.dropout_keep(99, Bn, H, L, L, 0.3)
    for h0 in (0, 2):
        assert torch.equal(ta.dropout_keep(99, Bn, 2, L, L, 0.3, head0=h0),
                           full[:, h0:h0 + 2])
    q, k, v, g = (torch.randn(Bn, L, H * D) for _ in range(4))
    mask = (torch.arange(L) < torch.tensor([[9], [12]])).float()
    out, m, l = ta.train_attention_fwd(q, k, v, mask, 99, 0.3, H)
    dq, dk, dv = ta.train_attention_bwd(q, k, v, mask, 99, 0.3, H, m, l, g)
    cols = slice(2 * D, 4 * D)
    args = [t[..., cols].contiguous() for t in (q, k, v)]
    o2, m2, l2 = ta.train_attention_fwd(*args, mask, 99, 0.3, 2, head0=2)
    grads = ta.train_attention_bwd(*args, mask, 99, 0.3, 2, m2, l2, g[..., cols].contiguous(),
                                   head0=2)
    assert torch.equal(o2, out[..., cols]) and torch.equal(m2, m[:, 2:]) and torch.equal(l2, l[:, 2:])
    for got, want in zip(grads, (dq, dk, dv)):
        assert torch.equal(got, want[..., cols])


@pytest.mark.parametrize("tag", [FFN_BLOCK_TAG, DENSE_BLOCK_TAG])
def test_row_offset_mask_is_the_calls_slice(tag):
    """#4's and #5's keep mask over rows [row0, row0 + n) equals those rows
    of the whole call's."""
    full = row_dropout_keep(7, 48, 128, tag, 0.2)
    for row0 in (0, 16, 32):
        assert torch.equal(row_dropout_keep(7, 16, 128, tag, 0.2, row0=row0),
                           full[row0:row0 + 16])


def _ffn_weights(N, H, F, dtype=torch.float32):
    g = torch.Generator().manual_seed(3)

    def r(*s, scale=0.05):
        return (torch.randn(*s, generator=g) * scale).to(dtype)

    return dict(x=r(N, H, scale=1.0), w1=r(H, F), b1=r(F), w2=r(F, H), b2=r(H), r=r(N, H, scale=1.0),
                w=r(H, H), b=r(H), scale=1.0 + torch.randn(H, generator=g) * 0.1,
                bias=torch.randn(H, generator=g) * 0.1, g=r(N, H, scale=1.0))


@pytest.mark.parametrize("tp", [2, 4])
def test_split_ffn_block_equals_unsplit(tp):
    """#4 cut at the row-parallel product: the ranks' partials over F / tp
    summed, then the rows at each rank's row offset (as under sequence
    parallelism), against the unsplit plain version, forward and backward,
    within f32 rounding."""
    N, H, F, rate = 32, 128, 256, 0.2
    t = _ffn_weights(N, H, F)
    out, pre, s = ffn.ffn_block_reference_fwd(t["x"], t["w1"], t["b1"], t["w2"], t["b2"],
                                              t["scale"], t["bias"], 5, rate)
    dx, _, _, dffn, dscale, dbias = ffn.ffn_block_reference_bwd(s, t["g"], pre, t["w1"],
                                                                t["w2"], t["scale"], 5, rate)
    f = F // tp
    shares = [(t["w1"][:, i * f:(i + 1) * f], t["b1"][i * f:(i + 1) * f],
               t["w2"][i * f:(i + 1) * f]) for i in range(tp)]
    parts = [ffn.ffn_part(t["x"], *share) for share in shares]
    part = sum(p for p, _ in parts)
    n = N // tp
    rows = [ffn.split_rows(part[i * n:(i + 1) * n], t["b2"], t["x"][i * n:(i + 1) * n],
                           t["scale"], t["bias"], 5, rate, 1e-12, 4, row0=i * n) for i in range(tp)]
    torch.testing.assert_close(torch.cat([o for o, _ in rows]), out, rtol=1e-5, atol=1e-5)
    heads = [ffn.block_bwd_ln(4, rows[i][1], t["g"][i * n:(i + 1) * n], t["scale"], 5, rate,
                              1e-12, row0=i * n) for i in range(tp)]
    dffn_all = torch.cat([h[0] for h in heads])
    torch.testing.assert_close(dffn_all, dffn, rtol=1e-5, atol=1e-6)
    dpart = sum(ffn.ffn_bwd_part(p, dffn_all, w1, w2)[0]
                for (_, p), (w1, _, w2) in zip(parts, shares))
    got = torch.cat([ffn.ffn_bwd_rows(dpart[i * n:(i + 1) * n], None, None, None, heads[i][2],
                                      torch.float32) for i in range(tp)])
    torch.testing.assert_close(got, dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(h[3] for h in heads), dscale, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(h[4] for h in heads), dbias, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tp", [2, 4])
def test_split_dense_block_equals_unsplit(tp):
    """#5 cut at the row-parallel product over K / tp (the rank's heads):
    the partials summed, the rows at each rank's offset, the LayerNorm head on
    them and dx on the rank's columns, against the unsplit plain version."""
    N, H, rate = 32, 128, 0.2
    t = _ffn_weights(N, H, 256)
    out, s = ffn.dense_block_reference_fwd(t["x"], t["r"], t["w"], t["b"], t["scale"],
                                           t["bias"], 9, rate)
    dx, dy, dr, dscale, dbias = ffn.dense_block_reference_bwd(s, t["g"], t["w"], t["scale"], 9,
                                                              rate)
    k = H // tp
    part = sum(ffn.dense_part(t["x"][:, i * k:(i + 1) * k], t["w"][i * k:(i + 1) * k])
               for i in range(tp))
    n = N // tp
    rows = [ffn.split_rows(part[i * n:(i + 1) * n], t["b"], t["r"][i * n:(i + 1) * n],
                           t["scale"], t["bias"], 9, rate, 1e-12, 5, row0=i * n)
            for i in range(tp)]
    torch.testing.assert_close(torch.cat([o for o, _ in rows]), out, rtol=1e-5, atol=1e-5)
    heads = [ffn.block_bwd_ln(5, rows[i][1], t["g"][i * n:(i + 1) * n], t["scale"], 9, rate,
                              1e-12, row0=i * n) for i in range(tp)]
    dy_all = torch.cat([h[0] for h in heads])
    torch.testing.assert_close(dy_all, dy, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([h[1] for h in heads]), dr, rtol=1e-5, atol=1e-6)
    got = torch.cat([ffn.dense_bwd_dx(dy_all, t["w"][i * k:(i + 1) * k]) for i in range(tp)],
                    dim=1)
    torch.testing.assert_close(got, dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(h[3] for h in heads), dscale, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(h[4] for h in heads), dbias, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def youcook_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("youcook_tp")
    csv, data, feats = fixtures.make_youcook(str(d), n_videos=4, clips_per_video=3,
                                             video_dim=16, seed=5)
    return csv, data, feats, fixtures.make_vocab(str(d / "vocab.txt"))


def _cli_argv(files, out, *extra):
    csv, data, feats, vocab = files
    return ["--device", "cpu", "--vocab_file", vocab, "--train_csv", csv, "--val_csv", csv,
            "--data_path", data, "--features_path", feats, "--output_dir", out,
            "--max_words", "12", "--max_frames", "6", "--video_dim", "16", "--hidden_size", "32",
            "--num_attention_heads", "4", "--intermediate_size", "64",
            "--text_num_hidden_layers", "1", "--visual_num_hidden_layers", "1",
            "--cross_num_hidden_layers", "1", "--decoder_num_hidden_layers", "1",
            "--batch_size", "6", "--epochs", "1", "--n_display", "1", "--lr", "1e-3",
            "--num_thread_reader", "2", "--batch_size_val", "8", "--do_train", *extra]


def _losses(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f) if r["kind"] == "train"]


TP2 = ["--n_gpu", "2", "--tensor_parallel", "2"]
CLI_RUNS = {
    "retrieval-sp-zero1": (task_retrieval, ["--train_sim_after_cross", "--do_eval",
                                            "--sequence_parallel", "--zero1"]),
    "caption": (task_caption, ["--do_eval"]),
}


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_runs_tensor_parallel(youcook_files, tmp_path, name):
    """``--n_gpu 2 --tensor_parallel 2`` through the retrieval (with
    --sequence_parallel --zero1) and caption CLIs, each with its per-epoch
    eval on rank 0's gathered model: the losses of one process (tp 1), within
    1e-5, the eval's metrics the same, a .bin of the tp=1 layout."""
    cli, extra = CLI_RUNS[name]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    flags = [f for f in extra if f not in ("--sequence_parallel", "--zero1")]
    threads = torch.get_num_threads()
    torch.set_num_threads(dp_mesh.CPU_THREADS)
    try:
        _, want = cli.main(_cli_argv(youcook_files, one, *flags))
    finally:
        torch.set_num_threads(threads)
    _, got = cli.main(_cli_argv(youcook_files, two, *extra, *TP2))
    for r in dp_mesh.spawn.ranks:
        assert not FORBIDDEN & set(r["modules"])
    np.testing.assert_allclose(np.array(_losses(two)), np.array(_losses(one)), rtol=1e-5)
    keys = [k for k in want if k not in ("encode_s", "similarity_s", "epoch")]
    assert {k: got[k] for k in keys} == pytest.approx({k: want[k] for k in keys}, rel=1e-4)
    a, b = (load_reference_bin(os.path.join(d, "pytorch_model.bin.0")) for d in (one, two))
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}


@pytest.fixture(scope="module")
def howto_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("howto_tp")
    csv, data, feats = fixtures.make_howto100m(str(d), n_videos=6, clips_per_video=4,
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
            "--cross_num_hidden_layers", "1", "--decoder_num_hidden_layers", "1",
            "--batch_size", "2", "--n_pair", "2", "--sampled_use_mil", "--epochs", "1",
            "--n_display", "1", "--lr", "1e-3", "--num_thread_reader", "2", "--seed", "0",
            *extra]


def _state(out):
    return torch.load(os.path.join(out, "train_state.pt"), weights_only=True)


def _close(got: dict, want: dict, rtol: float) -> None:
    """Each tensor within ``rtol`` of its norm, or 1e-8 absolutely (a bias
    that started at zero has a norm near the f32 noise of its sums; the
    cancelling gradients' tensors are that noise)."""
    for k, w in want.items():
        diff = float((got[k].float() - w.float()).norm())
        assert diff <= max(rtol * float(w.float().norm()), 1e-8), (k, diff)


@pytest.mark.parametrize("first,then", [(TP2 + ["--zero1"], []), ([], TP2 + ["--zero1"])],
                         ids=["tp2_zero1_to_tp1", "tp1_to_tp2_zero1"])
def test_pretrain_resumes_across_tp(howto_files, tmp_path, first, then):
    """Stage II pretraining (the vocab-sharded masked-language head):
    preempted after its first step at one layout, resumed with
    --load_checkpoint at the other (tp 2 --zero1 and tp 1): the weights, the
    moments and the losses within 1e-6 of an uninterrupted tp 1 run (each
    tensor of its norm, or 1e-8 absolutely: ``_close``)."""
    full, out = str(tmp_path / "full"), str(tmp_path / "out")
    stage2 = ["--stage_two", "--pretrain_enhance_vmodal"]
    threads = torch.get_num_threads()
    torch.set_num_threads(dp_mesh.CPU_THREADS)
    try:
        n = pretrain.main(_pretrain_argv(howto_files, full, *stage2))[0]
        pretrain.main(_pretrain_argv(howto_files, out, *stage2, *first,
                                     "--inject_preempt_after", "1"))
        assert pretrain.main(_pretrain_argv(howto_files, out, *stage2, *then,
                                            "--load_checkpoint"))[0] == n
    finally:
        torch.set_num_threads(threads)
    want, got = _state(full), _state(out)
    _close(got["model"], want["model"], 1e-6)
    assert got["optimizer"]["steps"] == want["optimizer"]["steps"] == n
    for i, st in want["optimizer"]["state"].items():
        _close({f"{i}.{k}": got["optimizer"]["state"][i][k] for k in ("m", "v")},
               {f"{i}.{k}": st[k] for k in ("m", "v")}, 1e-6)
    np.testing.assert_allclose(np.array(_losses(out)), np.array(_losses(full)), rtol=1e-6)
