"""The port's activation checkpointing (``UniVLConfig.remat``: True, each
tower layer under ``torch.utils.checkpoint``; "dots", selective
checkpointing that keeps the 2-D weight products) on the CPU at small
sizes: a rematerialized run is bitwise the plain run at dropout 0.1 in
training mode (the layers' randomness is keyed, so the recompute draws the
first pass's masks), it does recompute, "dots" keeps the nn.Linear products
and nothing else, a stack run twice in one step draws fresh masks, and at dropout 0 it agrees with the JAX package's
``remat=True`` and ``"dots"``.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_pretrain import pretrain_batch
from test_torch_training import _batch, _no_dropout, _t
from univl_tpu import config as jax_config
from univl_tpu.models.univl import UniVL as JaxUniVL
from univl_tpu_torch import config
from univl_tpu_torch.checkpoint.convert import init_state_dict, state_dict_from_jax_params
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers

B = 4
# FT-Align's and stage II's FFN block route needs widths that are multiples of 128
WIDE = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4)
ROUTES = {
    "ft_joint": dict(),
    "ft_align_block": dict(train_sim_after_cross=True, use_fused_ffn="block"),
    "stage_two_pretrain": dict(stage_two=True, do_pretrain=True, use_mil=True, n_pair=2,
                               use_fused_ffn="block"),
}


def _cfg(route: str, remat=False):
    kw = dict(ROUTES[route], batch_size_per_device=B if route != "stage_two_pretrain" else 2)
    cfg = config.UniVLConfig.tiny(**kw)
    if cfg.use_fused_ffn:
        cfg = cfg.replace(bert=cfg.bert.replace(**WIDE), visual=cfg.visual.replace(**WIDE),
                          cross=cfg.cross.replace(**WIDE), decoder=cfg.decoder.replace(**WIDE))
    return cfg.replace(remat=remat).validate()


def _route_batch(route: str, cfg):
    if route == "stage_two_pretrain":
        return _t(pretrain_batch(cfg, seed=1, clips=2, pairs=2))
    return _t(_batch(cfg, np.random.RandomState(0)))


def _step(route: str, remat):
    """(losses, gradients, tower-layer forward calls) of one training
    forward and backward at the tiny config's dropout 0.1."""
    cfg = _cfg(route, remat)
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    calls = []
    for tower in (model.bert, model.visual, *([model.cross] if model.has_cross else [])):
        for layer in tower.encoder.layer:
            layer.register_forward_pre_hook(lambda *a: calls.append(1))
    out = model.train()(_route_batch(route, cfg), torch.Generator().manual_seed(7))
    forward_calls = len(calls)
    out["loss"].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return {k: v.detach() for k, v in out.items()}, grads, forward_calls, len(calls)


@pytest.fixture(scope="module")
def plain_runs():
    return {route: _step(route, False) for route in ROUTES}


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_is_bitwise_the_plain_run(plain_runs, route, remat):
    """Every loss and every gradient bitwise equal to the run without remat,
    at dropout 0.1 in training mode; the backward runs each tower layer a
    second time, and the plain run's does not."""
    losses, grads, fwd, total = _step(route, remat)
    want_losses, want_grads, want_fwd, want_total = plain_runs[route]
    assert want_fwd == want_total == fwd and total == 2 * fwd
    assert sorted(losses) == sorted(want_losses)
    assert all(torch.equal(losses[k], want_losses[k]) for k in losses)
    assert sorted(grads) == sorted(want_grads)
    assert all(torch.equal(grads[k], want_grads[k]) for k in grads), [
        k for k in grads if not torch.equal(grads[k], want_grads[k])]


def test_dropout_is_on_in_the_remat_runs(plain_runs):
    """The runs above draw dropout: another step seed gives another loss."""
    cfg = _cfg("ft_joint", True)
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    loss = model.train()(_route_batch("ft_joint", cfg), torch.Generator().manual_seed(8))["loss"]
    assert not torch.equal(loss.detach(), plain_runs["ft_joint"][0]["loss"])


def test_dots_saves_the_linear_products_and_nothing_else(monkeypatch):
    """Under "dots" the first pass saves one output for each nn.Linear call
    of the towers' layers (six a layer: q, k, v, the attention output's
    dense, the intermediate and the output dense), all 2-D weight products,
    and marks no other op to save."""
    saved, policy_of = [], layers.dots_policy

    def recording(ctx, op, *args, **kwargs):
        policy = policy_of(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and policy == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return policy

    monkeypatch.setattr(layers, "dots_policy", recording)
    cfg = _cfg("ft_joint", "dots")
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    linear_calls = []
    for tower in (model.bert, model.visual):
        for m in tower.encoder.modules():
            if isinstance(m, torch.nn.Linear):
                m.register_forward_hook(lambda *a: linear_calls.append(1))
    out = model.train()(_route_batch("ft_joint", cfg), torch.Generator().manual_seed(7))
    n_layers = cfg.bert.num_hidden_layers + cfg.visual.num_hidden_layers
    assert len(saved) == len(linear_calls) == 6 * n_layers
    assert set(saved) <= set(layers.DOTS_SAVED)
    out["loss"].backward()  # the recompute finds every saved product
    assert len(saved) == 6 * n_layers


def test_a_stack_run_twice_in_a_step_draws_fresh_masks():
    """Two runs of one tower's stack on the same input with the same step
    randomness draw other masks (flax counts a scope's rng calls), and the
    same run number from a fresh copy of that randomness draws the same
    ones: the difference is the keying, not a nondeterminism."""
    cfg = _cfg("ft_joint")
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    stack = model.bert.encoder.train()
    x = torch.from_numpy(np.random.RandomState(3).randn(B, 12, cfg.bert.hidden_size)
                         .astype(np.float32))
    mask = torch.ones(B, 12)
    rng = layers.Randomness.from_key(11, "cpu")
    first, second = stack(x, mask, rng), stack(x, mask, rng)
    assert not torch.equal(first, second)
    again = layers.Randomness.from_key(11, "cpu")
    assert torch.equal(stack(x, mask, again), first)
    assert torch.equal(stack(x, mask, again), second)


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_stage_two_runs_of_a_tower_draw_their_own_masks(remat):
    """Stage II pretraining runs the text and visual towers twice a step
    (unmasked and masked inputs) and the cross tower three times. With
    each stack's input pinned to one tensor, every run of a stack in the
    step gives another output at dropout 0.1: no two runs share masks."""
    cfg = _cfg("stage_two_pretrain", remat)
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    outputs = {}
    for name, tower in (("text", model.bert), ("visual", model.visual),
                        ("cross", model.cross)):
        pinned = {}

        def pin(module, args, pinned=pinned):
            x = pinned.setdefault(args[0].shape, args[0].detach().clone())
            return (x, *args[1:])

        tower.encoder.register_forward_pre_hook(pin)
        tower.encoder.register_forward_hook(
            lambda m, a, out, name=name: outputs.setdefault(name, []).append(
                (a[0].shape, out.detach())))
    model.train()(_route_batch("stage_two_pretrain", cfg), torch.Generator().manual_seed(7))
    assert [len(outputs[k]) for k in ("text", "visual", "cross")] == [2, 2, 3]
    for name, runs in outputs.items():
        for i in range(len(runs)):
            for j in range(i + 1, len(runs)):
                if runs[i][0] == runs[j][0]:  # the same pinned input
                    assert not torch.equal(runs[i][1], runs[j][1]), (name, i, j)
    assert outputs["text"][0][0] == outputs["text"][1][0]


def test_remat_outside_its_modes_is_refused():
    with pytest.raises(ValueError, match="remat"):
        config.UniVLConfig.tiny(remat="auto")


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_matches_jax_remat(remat):
    """At dropout 0, FT-Joint under remat against JAX's ``remat=True`` and
    ``"dots"`` (the counterpart of tests/test_trainer.py's
    test_remat_matches_no_remat): the loss within 1e-5 rel, every gradient
    within 1e-5 of its tensor's norm."""
    kw = dict(batch_size_per_device=B, remat=remat)
    jcfg = _no_dropout(jax_config.UniVLConfig.tiny(**kw))
    cfg = _no_dropout(config.UniVLConfig.tiny(**kw))
    batch = _batch(jcfg, np.random.RandomState(0))
    jm = JaxUniVL(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(k, batch, deterministic=True))(
        jax.random.key(0))["params"])

    def loss_fn(p):
        return jm.apply({"params": p}, batch, deterministic=False,
                        rngs={"dropout": jax.random.key(1)})["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = UniVL(cfg)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    out = model.train()(_t(batch), torch.Generator().manual_seed(0))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-5, atol=0)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    for name, p in model.named_parameters():
        if name.endswith("attention.self.key.bias"):  # zero in exact arithmetic
            assert max(float(p.grad.norm()), float(want[name].norm())) < 1e-8, name
            continue
        rel = float((p.grad - want[name]).norm() / want[name].norm())
        assert rel <= 1e-5, (name, rel)
