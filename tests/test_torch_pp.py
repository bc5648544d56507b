"""The port's GPipe pipeline parallelism (``univl_tpu_torch/parallel/pp.py``)
on the CPU in f32: against the JAX package's ``pipelined_stack_fn`` on
conftest's 8 virtual devices, against JAX's ``TransformerStack`` and the
port's own sequential stack.

JAX's contract (``tests/test_pp.py``): the pipelined stack is the same
function as the sequential layer loop, forward and every parameter gradient,
with stage s holding only layers [s*L/S, (s+1)*L/S). Every multi-rank case
runs in one spawn of ``univl_tpu_torch.parallel.pp_replay``: eight gloo
ranks as a (dp 2, pp 4) grid over a FileStore, whose children import the
port, never JAX, and whose group times out after two minutes, so a
point-to-point deadlock fails here instead of hanging the suite. Each rank
takes the loss from its copy of the delivered output (the toy's mean(y ** 2),
the transformer's mean(y * probe)), so the gradients also hold the "not S
times" rule of the delivery's backward.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from univl_tpu.nn.layers import TransformerStack as JaxStack
from univl_tpu.parallel.pp import make_mesh_pp, pipelined_stack_fn, place_stacked_params
from univl_tpu_torch.checkpoint.convert import state_dict_from_jax_params
from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.nn.layers import TransformerStack
from univl_tpu_torch.parallel import mesh as dp_mesh
from univl_tpu_torch.parallel import pp, pp_replay
from univl_tpu_torch.parallel.mesh import PP_AXIS, Mesh

DP, PP = 2, 4
TOY_L, TOY_H, TOY_B, TOY_M = 8, 16, 8, 2  # tests/test_pp.py's first case
L, H, HEADS, F, B, LEN, M = 4, 128, 4, 256, 8, 6, 4  # hidden 128: the block route's gate
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "univl_tpu"}


def _toy_params(seed=0):
    r = np.random.RandomState(seed)
    return {"w": (r.randn(TOY_L, TOY_H, TOY_H) * 0.3).astype(np.float32),
            "b": (r.randn(TOY_L, TOY_H) * 0.1).astype(np.float32)}


def _toy_x():
    return np.random.RandomState(1).randn(TOY_B, TOY_H).astype(np.float32)


def _tower(dropout: float = 0.0):
    bert = UniVLConfig.tiny().bert
    return bert.replace(num_hidden_layers=L, hidden_size=H, num_attention_heads=HEADS,
                        intermediate_size=F, hidden_dropout_prob=dropout,
                        attention_probs_dropout_prob=dropout)


def _bias(key_mask):
    """JAX's additive key bias ([B, 1, 1, L], -10000 on a masked key)."""
    return jnp.asarray((1.0 - key_mask[:, None, None, :]) * -10000.0, jnp.float32)


def _jax_stack():
    return JaxStack(num_layers=L, scan_layers=True, hidden_size=H, num_heads=HEADS,
                    intermediate_size=F, dropout_rate=0.0, attn_dropout_rate=0.0)


@pytest.fixture(scope="module")
def transformer():
    """(JAX's stacked variables, the port's stack state dict with the same
    weights, the input, the loss's probe)."""
    stack = _jax_stack()
    x = np.random.RandomState(0).randn(B, LEN, H).astype(np.float32)
    probe = np.random.RandomState(4).randn(B, LEN, H).astype(np.float32)
    key_mask = (np.arange(LEN) < np.random.RandomState(5).randint(1, LEN + 1, (B, 1)))
    variables = stack.init(jax.random.key(0), jnp.asarray(x), _bias(key_mask), True)
    stacked = jax.tree.map(np.asarray, variables["params"]["layers"])
    tree = {"text": {"encoder": {f"layer_{i}": jax.tree.map(lambda a: a[i], stacked)
                                 for i in range(L)}}}
    sd = {k[len("bert.encoder."):]: v for k, v in state_dict_from_jax_params(tree).items()}
    return variables, sd, x, probe, key_mask.astype(np.int32)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, transformer):
    """The eight ranks' results, started in the background (beside JAX's
    compiles): [rank r's results]."""
    _, sd, x, probe, key_mask = transformer
    d = tmp_path_factory.mktemp("pp_replay")
    torch.save(sd, str(d / "stack.pt"))
    tf = dict(kind="transformer", weights=str(d / "stack.pt"), x=x, probe=probe,
              key_mask=key_mask, compute_dtype="float32", microbatches=M)
    spec = {"pipelines": [
        dict(name="toy", kind="toy", params=_toy_params(), x=_toy_x(), microbatches=TOY_M),
        dict(name="transformer", config=_tower(), **tf),
        dict(name="dropout", config=_tower(0.1), repeat=2, **tf),
    ]}
    torch.save(spec, str(d / "spec.pt"))
    argv = ["--spec", str(d / "spec.pt"), "--output", str(d / "out"), "--device", "cpu",
            "--n_gpu", str(DP * PP), "--pipeline_parallel", str(PP)]

    def go():
        pp_replay.main(argv)
        reports = list(dp_mesh.spawn.ranks)
        ranks = [torch.load(str(d / "out" / f"rank{r}.pt"), weights_only=False)
                 for r in range(DP * PP)]
        return ranks, reports

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(go)


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned.result()[0]


def _grads(ranks, name):
    """Every layer's gradient, from the rank of dp group 0 that holds it."""
    out = {}
    for res in ranks[:PP]:
        out.update(res["pipelines"][name]["grads"])
    return out


def _toy_stacked(grads):
    return {k: np.stack([grads[f"layer.{i}.{k}"].numpy() for i in range(TOY_L)])
            for k in ("w", "b")}


def _jax_toy():
    def body(lp, h):
        return h + jnp.tanh(h @ lp["w"] + lp["b"])

    mesh = make_mesh_pp(DP, PP)
    params = jax.tree.map(jnp.asarray, _toy_params())
    fn = jax.jit(pipelined_stack_fn(body, mesh, n_microbatches=TOY_M))
    placed = place_stacked_params(params, mesh)
    x = jax.device_put(jnp.asarray(_toy_x()), NamedSharding(mesh, P("dp")))
    y = fn(placed, x)
    g = jax.jit(jax.grad(lambda p: jnp.mean(fn(p, x) ** 2)))(placed)
    return np.asarray(y), jax.tree.map(np.asarray, g)


def test_toy_pipeline_matches_jax(ranks):
    """(dp 2, pp 4), 8 layers, 2 microbatches: the delivered output on every
    rank and every gradient (summed over dp) against JAX's pipelined stack
    on its (2, 4) mesh, f32, rtol 1e-5 (atol 1e-5 on outputs of up to ~5:
    XLA's tanh and products against PyTorch's over 8 layers)."""
    y, g = _jax_toy()
    for res in ranks:
        np.testing.assert_allclose(res["pipelines"]["toy"]["y"].numpy(), y, rtol=1e-5,
                                   atol=1e-5)
    got = _toy_stacked(_grads(ranks, "toy"))
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], g[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for res in ranks[PP:]:  # dp group 1 holds the same sums
        for k, v in res["pipelines"]["toy"]["grads"].items():
            torch.testing.assert_close(v, _grads(ranks, "toy")[k], rtol=0, atol=0)


def _sequential(sd, x, probe, key_mask):
    stack = TransformerStack(_tower(), torch.float32, "cpu", use_fused_ffn="block")
    stack.load_state_dict(sd, strict=True)
    y = stack.train()(torch.from_numpy(x), torch.from_numpy(key_mask))
    (y * torch.from_numpy(probe)).mean().backward()
    return y.detach(), {k: p.grad for k, p in stack.named_parameters()}


def test_transformer_pipeline_matches_jax_stack(ranks, transformer):
    """The port's TransformerLayers (block route: #4 and #5's plain
    versions) pipelined over 4 stages against JAX's
    ``TransformerStack(scan_layers=True)`` forward on the same weights and
    ragged key masks (each microbatch's rows of the dp group's mask)."""
    variables, _, x, _, key_mask = transformer
    stack = _jax_stack()
    want = np.asarray(stack.apply(variables, jnp.asarray(x), _bias(key_mask), True))
    for res in ranks:
        np.testing.assert_allclose(res["pipelines"]["transformer"]["y"].numpy(), want,
                                   rtol=2e-5, atol=2e-5)


def test_transformer_pipeline_matches_sequential(ranks, transformer):
    """Against the port's sequential stack on the same rows, forward and every
    parameter's gradient of mean(y * probe), which every rank takes from its
    own copy of the output: the sequential gradient, not 4 times it."""
    _, sd, x, probe, key_mask = transformer
    y, grads = _sequential(sd, x, probe, key_mask)
    np.testing.assert_allclose(ranks[0]["pipelines"]["transformer"]["y"].numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)
    got = _grads(ranks, "transformer")
    assert sorted(got) == sorted(grads)
    for k, g in grads.items():
        scale = max(float(g.norm()), 1e-30)
        rel = float((got[k] - g).norm()) / scale
        # the key bias's gradient is zero in exact arithmetic: held absolutely
        assert rel <= 1e-5 or (k.endswith("key.bias") and float(got[k].abs().max()) < 1e-7), \
            (k, rel)


def test_stage_holds_only_its_layers(ranks):
    """Rank r (stage r mod 4) holds layers [s*L/S, (s+1)*L/S) and their
    parameters only: a quarter of the stack's bytes."""
    sd_bytes = None
    for r, res in enumerate(ranks):
        s = r % PP
        for name, per in (("toy", TOY_L // PP), ("transformer", L // PP)):
            run = res["pipelines"][name]
            assert run["layers"] == list(range(s * per, (s + 1) * per))
            assert {int(k.split(".")[1]) for k in run["grads"]} == set(run["layers"])
        run = res["pipelines"]["transformer"]
        sd_bytes = sd_bytes or run["param_bytes"]
        assert run["param_bytes"] == sd_bytes
    total = sum(p.numel() * 4 for p in TransformerStack(_tower(), torch.float32).parameters())
    assert sd_bytes * PP == total


def test_dropout_pipeline_repeats_bitwise(ranks):
    """At rate 0.1 (keyed by layer and microbatch) two runs of the same step
    give bitwise equal outputs and gradients, and dropout acts."""
    for res in ranks:
        run = res["pipelines"]["dropout"]
        assert run["repeat_equal"]
        assert not torch.equal(run["y"], res["pipelines"]["transformer"]["y"])
        assert torch.equal(run["y"], ranks[0]["pipelines"]["dropout"]["y"])


def test_children_import_only_the_port(spawned):
    """Each rank reports the packages it imported: no JAX."""
    for r in spawned.result()[1]:
        assert not FORBIDDEN & set(r["modules"]), r["rank"]
        assert "univl_tpu_torch" in r["modules"]


def _stage_mesh(stages: int) -> Mesh:
    return Mesh(pp=stages, size=stages, views={PP_AXIS: Mesh(rank=0, size=stages)})


@pytest.mark.parametrize("case", ["microbatches", "layers", "tp_and_pp", "pp_ranks"])
def test_refusals(case):
    """A batch the microbatch count does not divide, layers the stages do not
    divide, tp with pp in one grid, a pp that does not divide the ranks."""
    with pytest.raises(ValueError):
        if case == "microbatches":
            pp.pipeline_apply(pp_replay.toy_body, {}, torch.zeros(6, 4), 4, Mesh())
        elif case == "layers":
            pp.stage_range(6, _stage_mesh(4))
        elif case == "tp_and_pp":
            dp_mesh.init("cpu", tp=2, pp=2)
        else:
            dp_mesh.check_grid(6, 1, 4)


def test_one_stage_is_the_sequential_loop():
    """pp 1 (no group): the microbatches run through every layer in turn,
    no hop, and the output is the sequential loop's."""
    params = _toy_params()
    stack = torch.nn.Module()
    stack.layer = torch.nn.ModuleList(pp_replay.ToyLayer(params["w"][i], params["b"][i])
                                      for i in range(TOY_L))
    layers = pp.place_stacked_params(stack, Mesh())
    x = torch.from_numpy(_toy_x())
    y = pp.pipeline_apply(pp_replay.toy_body, layers, x, TOY_M, Mesh())
    want = x
    for i in range(TOY_L):
        want = pp_replay.toy_body(stack.layer[i], want, i, 0)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
