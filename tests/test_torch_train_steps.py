"""The port's ``Trainer.train_steps`` (K optimizer steps in one call) on the
CPU at the tiny config: against JAX's ``Trainer.train_steps`` at dropout 0;
bitwise the loop of K ``train_step`` calls at dropout 0.1 on FT-Joint,
FT-Align's block route and caption fine-tuning with ``--fused_ln`` and two
accumulated micro-batches, BertAdam's state included; the step's key table
(``nn/layers.py:StepKeys``, ``layout_keys``) against the keys the eager
``Randomness`` folds; BertAdam's device learning-rate factors against JAX's
optimizer; and the refusals of the card's graph route, raised before any
device work. On the card the steps replay a captured CUDA graph, which
``chip_smoke.py`` (K1) holds bitwise to the eager loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_captioning_train import _batch as caption_batch
from test_torch_training import _batch, _cfgs, _port_model, _t
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu.parallel.mesh import make_mesh
from univl_tpu.train import optimization as jax_opt
from univl_tpu.train.trainer import Trainer as JaxTrainer
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers
from univl_tpu_torch.parallel.mesh import Mesh
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer, step_generator
from univl_tpu_torch.train.zero1 import make_univl_zero1_optimizer

K = 3
KW = dict(lr=1e-3, t_total=10, warmup_proportion=0.1, coef_lr=0.1)
# the fused FFN block route needs widths that are multiples of 128
WIDE = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4)
ROUTES = {  # route -> (config flags, accumulated micro-batches)
    "ft_joint": (dict(), 1),
    "ft_align_block": (dict(train_sim_after_cross=True, use_fused_ffn="block"), 1),
    "caption_fused_ln": (dict(stage_two=True, task_type="caption"), 2),
}


def _route_cfg(route: str):
    flags, _ = ROUTES[route]
    cfg = config.UniVLConfig.tiny(batch_size_per_device=4, **flags)
    if cfg.use_fused_ffn:
        cfg = cfg.replace(bert=cfg.bert.replace(**WIDE), visual=cfg.visual.replace(**WIDE),
                          cross=cfg.cross.replace(**WIDE), decoder=cfg.decoder.replace(**WIDE))
    return cfg.validate()


def _route_trainer(route: str, cfg):
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    layers.set_fused_layer_norm(model, route == "caption_fused_ln")
    return Trainer(model, make_univl_optimizer(model, **KW), grad_accum_steps=ROUTES[route][1],
                   seed=3)


def _route_batches(route: str, cfg, steps: int = K):
    """[steps, accum, B, ...] host arrays."""
    accum = ROUTES[route][1]
    if route == "caption_fused_ln":
        parts = [caption_batch(cfg, seed=i) for i in range(steps * accum)]
        stacked = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
        return {k: v.reshape(steps, accum, *v.shape[1:]) for k, v in stacked.items()}
    return _batch(cfg, np.random.RandomState(1), lead=(steps, accum))


def test_train_steps_matches_jax_train_steps():
    """K = 3 steps in one call against JAX's train_steps (one dispatch, a
    lax.scan) from the same weights at dropout 0, as
    tests/test_trainer.py::test_train_steps_scan_matches_sequential builds
    it: per-step losses within 1e-5, every parameter within 1e-4."""
    jcfg, cfg = _cfgs()
    stacked = _batch(jcfg, np.random.RandomState(2), lead=(K, 1))
    jm = JaxUniVL(jcfg)
    params = jax.jit(lambda k: jm.init(k, {n: v[0, 0] for n, v in stacked.items()},
                                       deterministic=True))(jax.random.key(0))["params"]
    params = jax.tree.map(np.asarray, params)
    mesh = make_mesh(1)
    jt = JaxTrainer(jm, jax_opt.make_univl_optimizer(**KW), mesh, donate=False)
    state = jt.init_state(jax.random.key(0), None, params=jax.tree.map(jnp.asarray, params))
    sharded = jax.tree.map(lambda x: jax.device_put(x, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, None, "dp"))), stacked)
    state, jmetrics = jt.train_steps(state, sharded, jax.random.key(7))
    model = _port_model(cfg, params)
    trainer = Trainer(model, make_univl_optimizer(model, **KW))
    metrics = trainer.train_steps(_t(stacked), 0)
    assert metrics["loss"].shape == (K,) and trainer.optimizer.steps == K
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]), rtol=1e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_steps_is_bitwise_the_train_step_loop(route):
    """At dropout 0.1 from the same weights: every step's metrics, every
    parameter and BertAdam's state dict (both moments, the step count)
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
    # the dropout was on: from the same weights another first step draws other masks
    other = _route_trainer(route, cfg).train_steps(batches, 6)
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


@pytest.mark.parametrize("route", ["ft_align_block", "caption_fused_ln"])
def test_step_key_table_is_the_eager_keys(route, monkeypatch):
    """The keys a step's recorded layout (StepKeys) derives from a step's
    roots (layout_keys, the table a replay writes), for the recorded step
    and another, are entry for entry the keys the eager path without a
    record hands each device generator and each dropping kernel."""
    cfg = _route_cfg(route)
    batch = {k: v[0] for k, v in _t(_route_batches(route, cfg, steps=1)).items()}
    trainer = _route_trainer(route, cfg)
    recorded = layers.StepKeys(step_generator(trainer.seed, 4))
    trainer._step(batch, recorded)
    kinds = {kind for kind, _, _ in recorded.layout}
    assert kinds == {layers.GENERATOR, layers.KERNEL}
    assert len(recorded.roots) == ROUTES[route][1]
    for step in (4, 9):
        seen = _recording(monkeypatch)
        _route_trainer(route, cfg).train_step(batch, step)
        monkeypatch.undo()
        generator = step_generator(trainer.seed, step)
        roots = [layers.draw_key(generator) for _ in recorded.roots]
        table = layers.layout_keys(recorded.layout, roots)
        assert [(kind, key) for (kind, _, _), key in zip(recorded.layout, table)] == seen


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


def _refused(kind: str):
    cfg = _route_cfg("ft_joint")
    if kind == "remat":
        cfg = cfg.replace(remat=True).validate()
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    if kind == "zero1":
        return Trainer(model, make_univl_zero1_optimizer(model, None, **KW))
    if kind == "sgd":
        return Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1))
    opt = make_univl_optimizer(model, **KW)
    if kind == "tensor_parallel":
        opt.set_tensor_parallel(Mesh(size=2), [])
    return Trainer(model, opt, mesh=Mesh(size=2) if kind == "mesh" else None)


@pytest.mark.parametrize("kind, says", [
    ("mesh", "a mesh of 2 ranks"), ("zero1", "ZeRO-1"),
    ("tensor_parallel", "tensor and sequence parallelism"), ("remat", "--remat"),
    ("sgd", "SGD")])
def test_card_route_refuses_before_any_device_work(kind, says, monkeypatch):
    """On the card (here: a trainer told it is on one) train_steps refuses
    meshes, ZeRO-1, tensor parallelism, remat and optimizers other than
    BertAdam, naming the later slice, before it runs a step: the
    parameters and the step count stay as they were. On the CPU the same
    trainers take the loop."""
    trainer = _refused(kind)
    assert says in trainer.graph_refusal() and "later slice" in trainer.graph_refusal()
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    batches = _t(_route_batches("ft_joint", _route_cfg("ft_joint"), steps=2))
    monkeypatch.setattr(Trainer, "_on_card", lambda self: True)
    with pytest.raises(NotImplementedError, match="later slice"):
        trainer.train_steps(batches, 0)
    assert all(torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
    assert getattr(trainer.optimizer, "steps", 0) == 0
    assert _route_trainer("ft_joint", _route_cfg("ft_joint")).graph_refusal() is None
