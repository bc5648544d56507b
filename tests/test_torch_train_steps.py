"""The port's ``Trainer.train_steps`` (K optimizer steps in one call) on the
CPU at the tiny config: against JAX's ``Trainer.train_steps`` at dropout 0
(FT-Joint without remat, with remat and "dots", with ZeRO-1, and pretraining
stages I and II); bitwise the loop of K ``train_step`` calls at dropout 0.1
on FT-Joint, FT-Align's block route (also under remat, "dots" and ZeRO-1),
caption fine-tuning with ``--fused_ln`` and two accumulated micro-batches,
and pretraining stages I and II, the optimizer's state included; the step's
key table (``nn/layers.py:StepKeys``, ``layout_keys``) against the keys the
eager ``Randomness`` folds, a rematerialized layer's second pass drawing its
first pass's keys; BertAdam's device learning-rate factors against JAX's
optimizer; and what the card's graph route takes and what it refuses,
raised before any device work. On the card the steps replay a captured CUDA
graph, which ``chip_smoke.py`` (K1, K2) holds bitwise to the eager loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_captioning_train import _batch as caption_batch
from test_torch_pretrain import STAGE_ONE_KEYS, pretrain_batch
from test_torch_training import _batch, _cfgs, _no_dropout, _port_model, _t
from univl_tpu import config as jax_config
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.parallel.mesh import make_mesh
from univl_tpu.train import optimization as jax_opt
from univl_tpu.train.trainer import Trainer as JaxTrainer
from univl_tpu.train.zero1 import make_univl_zero1_optimizer as jax_zero1_optimizer
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import (
    init_state_dict,
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers
from univl_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, Mesh
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer, step_generator
from univl_tpu_torch.train.zero1 import make_univl_zero1_optimizer

K = 3
KW = dict(lr=1e-3, t_total=10, warmup_proportion=0.1, coef_lr=0.1)
# the fused FFN block route needs widths that are multiples of 128
WIDE = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4)
ALIGN = dict(train_sim_after_cross=True, use_fused_ffn="block")
CLIPS, PAIRS = 2, 2  # a pretraining micro-batch: clips, pairs a clip
STAGE_ONE = dict(do_pretrain=True, use_mil=True, n_pair=PAIRS)
STAGE_TWO = dict(STAGE_ONE, stage_two=True)
ROUTES = {  # route -> (config flags, accumulated micro-batches)
    "ft_joint": (dict(), 1),
    "ft_align_block": (ALIGN, 1),
    "caption_fused_ln": (dict(stage_two=True, task_type="caption"), 2),
    "ft_align_remat": (dict(ALIGN, remat=True), 1),
    "ft_align_dots": (dict(ALIGN, remat="dots"), 1),
    "ft_align_zero1": (ALIGN, 1),  # make_univl_zero1_optimizer(model, None)
    "stage_one": (STAGE_ONE, 1),
    "stage_two": (dict(STAGE_TWO, use_fused_ffn="block"), 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny steps, restored after: the
    plain kernels' small tensors gain nothing from more, and the suite's
    workers would oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _route_cfg(route: str):
    flags, _ = ROUTES[route]
    clips = CLIPS if flags.get("do_pretrain") else 4
    cfg = config.UniVLConfig.tiny(batch_size_per_device=clips, **flags)
    if cfg.use_fused_ffn:
        cfg = cfg.replace(bert=cfg.bert.replace(**WIDE), visual=cfg.visual.replace(**WIDE),
                          cross=cfg.cross.replace(**WIDE), decoder=cfg.decoder.replace(**WIDE))
    return cfg.validate()


def _route_trainer(route: str, cfg):
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    layers.set_fused_layer_norm(model, route == "caption_fused_ln")
    opt = (make_univl_zero1_optimizer(model, None, **KW) if route.endswith("zero1")
           else make_univl_optimizer(model, **KW))
    return Trainer(model, opt, grad_accum_steps=ROUTES[route][1], seed=3)


def _stack(parts: list, steps: int, accum: int) -> dict:
    """Per-micro-batch host arrays stacked into [steps, accum, ...]."""
    stacked = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    return {k: v.reshape(steps, accum, *v.shape[1:]) for k, v in stacked.items()}


def _pretrain_batches(cfg, steps: int, accum: int, seed: int = 0) -> dict:
    """[steps, accum, clips, pairs, ...] pretraining arrays; stage I's keys
    without stage two."""
    parts = [pretrain_batch(cfg, seed=seed + i, clips=CLIPS, pairs=PAIRS)
             for i in range(steps * accum)]
    if not cfg.stage_two:
        parts = [{k: p[k] for k in STAGE_ONE_KEYS} for p in parts]
    return _stack(parts, steps, accum)


def _route_batches(route: str, cfg, steps: int = K):
    """[steps, accum, B, ...] host arrays."""
    accum = ROUTES[route][1]
    if route == "caption_fused_ln":
        return _stack([caption_batch(cfg, seed=i) for i in range(steps * accum)], steps, accum)
    if cfg.do_pretrain:
        return _pretrain_batches(cfg, steps, accum)
    return _batch(cfg, np.random.RandomState(1), lead=(steps, accum))


# JAX compiles every layer of a step, so the cases past "plain" run one-layer
# towers (stage II runs the text and visual towers twice, the cross three times)
ONE_LAYER = dict(num_hidden_layers=1)


def _one_layer(cfg):
    return cfg.replace(bert=cfg.bert.replace(**ONE_LAYER), visual=cfg.visual.replace(**ONE_LAYER),
                       cross=cfg.cross.replace(**ONE_LAYER),
                       decoder=cfg.decoder.replace(num_decoder_layers=1))
JAX_CASES = {  # case -> (config flags, accumulated micro-batches, ZeRO-1)
    "plain": (dict(), 1, False),
    "remat": (dict(remat=True), 1, False),
    "dots": (dict(remat="dots"), 1, False),
    "zero1": (dict(), 1, True),
    "stage_one": (STAGE_ONE, 1, False),
    "stage_two": (STAGE_TWO, 2, False),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_train_steps_matches_jax_train_steps(case):
    """K = 3 steps in one call against JAX's train_steps (one dispatch, a
    lax.scan) from the same weights at dropout 0, as
    tests/test_trainer.py::test_train_steps_scan_matches_sequential builds
    it, on FT-Joint without remat, with remat and "dots", with ZeRO-1 (JAX's
    on a mesh of one device), and on pretraining stage I and stage II (two
    accumulated micro-batches): per-step losses within 1e-5, every parameter
    within 1e-4. All but "plain" at one layer a tower."""
    flags, accum, zero1 = JAX_CASES[case]
    if flags.get("do_pretrain"):
        kw = dict(flags, batch_size_per_device=CLIPS)
        jcfg, cfg = (_no_dropout(jax_config.UniVLConfig.tiny(**kw)),
                     _no_dropout(config.UniVLConfig.tiny(**kw)))
    else:
        jcfg, cfg = _cfgs(**flags)
    if case != "plain":
        jcfg, cfg = _one_layer(jcfg), _one_layer(cfg)
    if jcfg.do_pretrain:
        stacked = _pretrain_batches(jcfg, K, accum, seed=20)
    else:
        stacked = _batch(jcfg, np.random.RandomState(2), lead=(K, accum))
    jm = JaxUniVL(jcfg)
    params = jax.tree.map(np.asarray, jax_params_from_state_dict(init_state_dict(cfg, 0)))
    mesh = make_mesh(1)
    tx = jax_zero1_optimizer(dp=1, **KW) if zero1 else jax_opt.make_univl_optimizer(**KW)
    jt = JaxTrainer(jm, tx, mesh, grad_accum_steps=accum, zero1=zero1, donate=False)
    state = jt.init_state(jax.random.key(0), None, params=jax.tree.map(jnp.asarray, params))
    sharded = jax.tree.map(lambda x: jax.device_put(x, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, None, "dp"))), stacked)
    state, jmetrics = jt.train_steps(state, sharded, jax.random.key(7))
    model = _port_model(cfg, params)
    opt = (make_univl_zero1_optimizer(model, None, **KW) if zero1
           else make_univl_optimizer(model, **KW))
    trainer = Trainer(model, opt, grad_accum_steps=accum)
    metrics = trainer.train_steps(_t(stacked), 0)
    assert metrics["loss"].shape == (K,) and trainer.optimizer.steps == K
    assert sorted(metrics) == sorted(jmetrics)
    for name in metrics:
        np.testing.assert_allclose(metrics[name].numpy(), np.asarray(jmetrics[name]), rtol=1e-5,
                                   err_msg=name)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_steps_is_bitwise_the_train_step_loop(route):
    """At dropout 0.1 from the same weights: every step's metrics, every
    parameter and the optimizer's state dict (both moments, the step count;
    ZeRO-1's gathered from its shard, whose f32 master is compared too)
    bitwise what K train_step calls at first_step + i leave."""
    cfg = _route_cfg(route)
    assert cfg.bert.hidden_dropout_prob == 0.1 and cfg.bert.attention_probs_dropout_prob == 0.1
    batches = _t(_route_batches(route, cfg))
    stepped, looped = _route_trainer(route, cfg), _route_trainer(route, cfg)
    got = stepped.train_steps(batches, 5)
    want = [looped.train_step({k: v[i] for k, v in batches.items()}, 5 + i) for i in range(K)]
    assert sorted(got) == sorted(want[0])
    for name in got:
        assert torch.equal(got[name], torch.stack([m[name] for m in want])), name
    for (name, p), q in zip(stepped.model.named_parameters(), looped.model.parameters()):
        assert torch.equal(p, q), name
    sd, sd_want = stepped.optimizer.state_dict(), looped.optimizer.state_dict()
    assert sd["steps"] == sd_want["steps"] == K
    assert sorted(sd["state"]) == sorted(sd_want["state"])
    for i, st in sd["state"].items():
        assert all(torch.equal(st[k], sd_want["state"][i][k]) for k in ("m", "v")), i
    if route.endswith("zero1"):
        assert torch.equal(stepped.optimizer.master, looped.optimizer.master)
    # the dropout was on: from the same weights another first step draws other masks
    other = _route_trainer(route, cfg).train_steps({k: v[:1] for k, v in batches.items()}, 6)
    assert not torch.equal(other["loss"][0], got["loss"][0])


def _recording(monkeypatch):
    """Record every key the eager path hands out, in order: each device
    generator's seed (``Randomness.from_key``) and each kernel call's Philox
    key (the wrappers #2, #4 and #5 as nn/layers.py calls them)."""
    seen = []
    from_key = layers.Randomness.from_key.__func__

    def recorded_from_key(cls, key, device):
        seen.append((layers.GENERATOR, key))
        return from_key(cls, key, device)

    monkeypatch.setattr(layers.Randomness, "from_key", classmethod(recorded_from_key))
    for name, at in (("fused_train_attention", 4), ("fused_ffn_block", 7),
                     ("fused_dense_block", 6)):
        fn = getattr(layers, name)

        def wrapper(*args, _fn=fn, _at=at, **kw):
            if args[_at + 1] > 0.0:  # a kernel that drops reads its key
                seen.append((layers.KERNEL, args[_at]))
            return _fn(*args, **kw)

        monkeypatch.setattr(layers, name, wrapper)
    return seen


@pytest.mark.parametrize("route", ["ft_align_block", "caption_fused_ln", "ft_align_remat",
                                   "ft_align_dots"])
def test_step_key_table_is_the_eager_keys(route, monkeypatch):
    """The keys a step's recorded layout (StepKeys) derives from a step's
    roots (layout_keys, the table a replay writes), for the recorded step
    and another, are entry for entry the keys the eager path without a
    record hands each device generator and each dropping kernel. Under
    remat the layout is the forward's entries, then the recompute's: each
    a repeat of a forward entry, given the forward's key, as the eager
    recompute folds it. A step drawn through generators seeded from the
    layout (the capture's route; on the CPU the kernels take the key's host
    value) is bitwise the eager step."""
    cfg = _route_cfg(route)
    batch = {k: v[0] for k, v in _t(_route_batches(route, cfg, steps=1)).items()}
    trainer = _route_trainer(route, cfg)
    recorded = layers.StepKeys(step_generator(trainer.seed, 4))
    trainer._step(batch, recorded)
    kinds = {kind for kind, _, _ in recorded.layout}
    assert kinds == {layers.GENERATOR, layers.KERNEL}
    assert len(recorded.roots) == ROUTES[route][1]
    forward = len(recorded.layout)
    if cfg.remat:
        plain = layers.StepKeys(step_generator(trainer.seed, 4))
        _route_trainer("ft_align_block", _route_cfg("ft_align_block"))._step(batch, plain)
        forward = len(plain.layout)
        assert recorded.layout[:forward] == plain.layout
        assert len(recorded.layout) > forward
        assert set(recorded.layout[forward:]) <= set(plain.layout)
    for step in (4, 9):
        seen = _recording(monkeypatch)
        want = _route_trainer(route, cfg).train_step(batch, step)
        monkeypatch.undo()
        generator = step_generator(trainer.seed, step)
        roots = [layers.draw_key(generator) for _ in recorded.roots]
        table = layers.layout_keys(recorded.layout, roots)
        assert [(kind, key) for (kind, _, _), key in zip(recorded.layout, table)] == seen
        first = dict(zip(recorded.layout[:forward], seen[:forward]))
        assert [first[entry] for entry in recorded.layout[forward:]] == seen[forward:]
        pool = [torch.Generator().manual_seed(key) for (kind, _, _), key
                in zip(recorded.layout, table) if kind == layers.GENERATOR]
        slots = torch.zeros(len(table) - len(pool), dtype=torch.int64)
        keys = layers.StepKeys(step_generator(trainer.seed, step), slots, pool)
        got = _route_trainer(route, cfg)._step(batch, keys)
        assert keys.layout == recorded.layout
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("schedule", ["warmup_linear", "warmup_cosine"])
def test_bert_adam_device_factors_match_jax(schedule):
    """Four steps through warmup: each group's device factor is the host's
    ``factors_at`` at the step count, bit for bit, and JAX's ``-(lr_t * s)``
    within f32 rounding; the parameters after the steps are JAX's within
    rounding (2e-7), as tests/test_torch_training.py holds BertAdam."""
    jcfg, cfg = _cfgs()
    params = jax.tree.map(np.asarray, JaxUniVL(jcfg).init(
        jax.random.key(0), _batch(jcfg, np.random.RandomState(0)), deterministic=True)["params"])
    kw = dict(KW, t_total=8, warmup_proportion=0.25, schedule=schedule)
    tx = jax_opt.make_univl_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    model = _port_model(cfg, params)
    opt = make_univl_optimizer(model, **kw)
    rng = np.random.RandomState(3)
    for step in range(4):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
        upd, state = jax.jit(tx.update)(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        tgrads = state_dict_from_jax_params(grads)
        for name, p in model.named_parameters():
            p.grad = tgrads[name]
        opt.step()
        progress = np.float32(step) / np.float32(kw["t_total"])
        lr_t = np.float32(kw["lr"]) * np.float32(
            jax_opt.SCHEDULES[schedule](progress, np.float32(kw["warmup_proportion"])))
        want = [-(lr_t * np.float32(g["lr_scale"])) for g in opt.param_groups]
        assert opt._factors.dtype == torch.float32
        np.testing.assert_array_equal(opt._factors.numpy(), opt.factors_at(step))
        np.testing.assert_allclose(opt._factors.numpy(), np.array(want, np.float32), rtol=1e-6)
    got = state_dict_from_jax_params(jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), got[name].numpy(), rtol=0, atol=2e-7,
                                   err_msg=name)
    assert opt.steps == 4


def _graph_trainer(kind: str):
    """A trainer of each kind the card's graph route takes or refuses."""
    cfg = _route_cfg("ft_joint")
    if kind == "remat":
        cfg = cfg.replace(remat=True).validate()
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    if kind in ("zero1", "gloo"):
        mesh = Mesh(backend="gloo") if kind == "gloo" else None
        return Trainer(model, make_univl_zero1_optimizer(model, mesh, **KW), mesh=mesh)
    if kind == "sgd":
        return Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1))
    opt = make_univl_optimizer(model, **KW)
    if kind == "tensor_parallel":
        opt.set_tensor_parallel(Mesh(size=2), [])
    mesh = {"mesh": Mesh(size=2),
            "tp_view": Mesh(size=2, tp=2, views={DP_AXIS: Mesh(), TP_AXIS: Mesh(size=2)})}
    return Trainer(model, opt, mesh=mesh.get(kind))


TAKEN = ("zero1", "remat")  # once refused, now captured


@pytest.mark.parametrize("kind, says", [
    ("mesh", "a mesh of 2 ranks"), ("zero1", "ZeRO-1"),
    ("tensor_parallel", "tensor and sequence parallelism"), ("remat", "--remat"),
    ("sgd", "SGD"), ("gloo", "gloo process group"),
    ("tp_view", "tensor and sequence parallelism")])
def test_card_route_refuses_before_any_device_work(kind, says, monkeypatch):
    """The card's graph route takes ZeRO-1 on one rank and --remat
    (``graph_refusal`` None; ``says`` names them), and refuses the rest
    before it runs a step, each with its reason in ``says``: a mesh of
    several ranks, a gloo group, tensor parallelism (the optimizer's split
    norms, or the mesh's tp view) and optimizers other than BertAdam; the
    parameters and the step count stay as they were. On the CPU every
    trainer takes the loop."""
    trainer = _graph_trainer(kind)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    batches = _t(_route_batches("ft_joint", _route_cfg("ft_joint"), steps=2))
    if kind in TAKEN:
        assert trainer.graph_refusal() is None
        trainer.train_steps(batches, 0)
        assert trainer.optimizer.steps == 2
        if kind == "zero1":  # a graph is keyed on the shard's buffers and the flat gradient
            opt = trainer.optimizer
            assert {t.data_ptr() for t in (opt.m, opt.v, opt.master, opt.g, trainer._flat)} <= \
                set(trainer._addresses())
        assert not all(torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
        return
    assert says in trainer.graph_refusal()
    monkeypatch.setattr(Trainer, "_on_card", lambda self: True)
    with pytest.raises(NotImplementedError, match=says):
        trainer.train_steps(batches, 0)
    assert all(torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
    assert getattr(trainer.optimizer, "steps", 0) == 0
    assert _route_trainer("ft_joint", _route_cfg("ft_joint")).graph_refusal() is None
