"""Run pipelines (``parallel/pp.py``) and the data-parallel fan-out of the
retrieval evaluator, the retrieval index and the caption generator on N
ranks, in one process group.

    python -m univl_tpu_torch.parallel.pp_replay --spec spec.pt --output DIR \\
        --n_gpu N [--pipeline_parallel P] [--dist_backend gloo] [--device cpu]

``spec.pt`` (``torch.save``) is a dict of lists; every rank runs every
entry, the pipelines on a (N / P, P) grid (``pp.make_mesh_pp``), the
others (``mesh=``) over all N ranks. Any collective or point-to-point call that
waits ``TIMEOUT`` raises, so a deadlock ends the run within two minutes.

``pipelines``: dicts with ``name``, ``microbatches``, ``x`` (the global
batch, numpy), ``repeat`` (runs of the same step; the first one's results
are kept, the others must be bitwise equal to it) and a stack:
  - ``kind`` "toy": ``params`` {"w": [L, H, H], "b": [L, H]}, the residual
    block h + tanh(h w_i + b_i) of ``tests/test_pp.py``;
  - ``kind`` "transformer": ``config`` (a tower's config), ``weights`` (a
    ``TransformerStack``'s state dict, ``torch.save``d), ``key_mask``
    [B, L] and ``compute_dtype``: the stack on the block route (#2, #4 and
    #5 in every layer), in training mode at the config's dropout, keyed by
    ``Randomness.from_key(SEED)``.
Each step takes the loss from the delivered output on every rank, mean(y *
``probe``) where the spec gives a ``probe`` of y's shape (a LayerNorm at its
init makes mean(y ** 2) a constant), else mean(y ** 2); runs the backward,
and sums the stage's gradients over dp.

``evals``: dicts with ``name``, ``config`` (a ``UniVLConfig``), ``weights``
(a reference-named state dict file), ``batches`` (numpy dicts), ``modes``,
``batch_size``, ``cross_text_block`` and ``cross_video_block``.

``indexes``: dicts with ``name``, ``config``, ``weights``, ``vocab`` (a
vocab file), ``batch_size``, ``videos`` (numpy clips), ``ids``, ``queries``,
``top_k`` and ``reranks``: a ``VideoRetrievalIndex(store_full=True)`` adds
the clips, then searches once for each ``rerank`` of ``reranks``.

``captions``: dicts with ``name``, ``config``, ``weights``, ``vocab``,
``batches`` (numpy dicts of the five encoder keys) and ``options``
(``CaptionGenerator``'s keyword arguments): the generator decodes each batch.

Rank r writes ``DIR/rank{r}.pt``: for each pipeline the delivered output,
its stage's gradients under the stack's parameter names, its layers, its
parameter bytes, each step's seconds (host clock, synchronized), peak device
memory, and the kernel launches of all its steps; for each evaluation and mode
the metrics, the similarity matrix and the launches; for each index the
store (``video_emb``, ``vis_full``, ``vm_full``), each search's results
and the launches; for each caption entry each batch's tokens, scores and
steps (the rank's) and the launches. An evaluation's, an index's and a
caption entry's ``launches`` count graph replays as launches and captures
as none (``utils/graphs.py:LaunchCounts``), their ``wrapper_launches``
the wrappers' own counts. Rank 0 returns its own.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch
from torch import nn

from univl_tpu_torch.checkpoint.convert import load_reference_bin
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.evals.beam import CaptionGenerator
from univl_tpu_torch.evals.retrieval import RetrievalEvaluator
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn.layers import TOWER_TAGS, Randomness, TransformerStack
from univl_tpu_torch.parallel import mesh as dp_mesh
from univl_tpu_torch.parallel import pp
from univl_tpu_torch.parallel.mesh import DP_AXIS
from univl_tpu_torch.serving.index import VideoRetrievalIndex
from univl_tpu_torch.utils.graphs import LaunchCounts

ENTRY = "univl_tpu_torch.parallel.pp_replay:main"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TIMEOUT = datetime.timedelta(minutes=2)
SEED = 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pipelines and the data-parallel fan-outs on N ranks")
    p.add_argument("--spec", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_gpu", type=int, default=2)
    p.add_argument("--pipeline_parallel", type=int, default=1)
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.n_gpu > 1 and not dp_mesh.launched():
        return dp_mesh.spawn(ENTRY, argv, args.n_gpu)
    stages = args.pipeline_parallel
    mesh = pp.make_mesh_pp(args.n_gpu // stages, stages, args.device, args.dist_backend,
                           timeout=TIMEOUT)
    try:
        return run(args, mesh)
    finally:
        mesh.close()


class ToyLayer(nn.Module):
    """``tests/test_pp.py``'s residual dense block."""

    def __init__(self, w: np.ndarray, b: np.ndarray):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(np.array(w, np.float32)))
        self.b = nn.Parameter(torch.from_numpy(np.array(b, np.float32)))


def toy_body(layer, h, i, m):
    return h + torch.tanh(h @ layer.w + layer.b)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stack(spec):
    """(the whole stack on the CPU, the body's factory, the input's dtype)."""
    if spec["kind"] == "toy":
        w, b = spec["params"]["w"], spec["params"]["b"]
        stack = nn.Module()
        stack.layer = nn.ModuleList(ToyLayer(w[i], b[i]) for i in range(len(w)))
        return stack, lambda mesh: toy_body, torch.float32
    dtype = DTYPES[spec["compute_dtype"]]
    stack = TransformerStack(spec["config"], dtype, "cpu", use_fused_ffn="block")
    stack.load_state_dict(torch.load(spec["weights"], map_location="cpu", weights_only=True),
                          strict=True)

    def body(mesh):
        dp = mesh.axis(DP_AXIS)  # the key mask's rows of this rank's dp group
        key_mask = torch.from_numpy(np.array_split(spec["key_mask"], dp.size)[dp.rank])
        rng = Randomness.from_key(SEED, mesh.device).run(TOWER_TAGS["text"])
        return pp.transformer_body(key_mask.to(mesh.device), rng)

    return stack.train(), body, dtype


def run_pipeline(spec, mesh) -> dict:
    stack, make_body, dtype = _stack(spec)
    layers = pp.place_stacked_params(stack, mesh)
    del stack
    device = mesh.device
    x = torch.from_numpy(spec["x"]).to(device, dtype)
    probe = spec.get("probe")
    probe = None if probe is None else torch.from_numpy(probe).to(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first, seconds, same = None, [], True
    before = dp_mesh.kernel_launches()
    for _ in range(spec.get("repeat", 1)):
        layers.zero_grad(set_to_none=True)
        _sync(device)
        t0 = time.perf_counter()
        fn = pp.pipelined_stack_fn(make_body(mesh), mesh, spec["microbatches"])
        y = fn(layers, x)
        (y.float().square() if probe is None else y.float() * probe).mean().backward()
        pp.sum_dp_grads(layers, mesh)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        grads = {f"layer.{i}.{name}": p.grad.detach().cpu().clone()
                 for i, layer in layers.items() for name, p in layer.named_parameters()}
        out = y.detach().cpu()
        if first is None:
            first = (out, grads)
        else:
            same = same and torch.equal(out, first[0]) and all(
                torch.equal(g, first[1][k]) for k, g in grads.items())
    after = dp_mesh.kernel_launches()
    return {"y": first[0], "grads": first[1], "layers": [int(i) for i in layers],
            "param_bytes": sum(p.numel() * p.element_size() for p in layers.parameters()),
            "seconds": seconds, "launches": {k: n - before[k] for k, n in after.items()},
            "repeat_equal": same,
            "peak_bytes": (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                           else None)}


def run_eval(spec, mesh, built: list) -> dict:
    ev = RetrievalEvaluator(_model(spec, mesh, built), batch_size=spec["batch_size"],
                            cross_text_block=spec["cross_text_block"],
                            cross_video_block=spec["cross_video_block"], mesh=mesh)
    out = {}
    with LaunchCounts() as counts:  # one for all modes: a graph adds to the one it was captured in
        for mode in spec["modes"]:
            before, wrappers = counts.launches(), dp_mesh.kernel_launches()
            metrics = ev.evaluate(iter(spec["batches"]), mode=mode)
            after = counts.launches()
            out[mode] = {"metrics": metrics, "sim": ev.similarity, "seconds": dict(ev.seconds),
                         "launches": {k: n - before[k] for k, n in after.items()},
                         "wrapper_launches": {k: n - wrappers[k]
                                              for k, n in dp_mesh.kernel_launches().items()}}
    return out


def _model(spec, mesh, built: list) -> UniVL:
    """The entry's model in eval mode, built once a run for each config and
    weights file the entries name (``built``: the run's models so far)."""
    for config, weights, model in built:
        if config == spec["config"] and weights == spec["weights"]:
            return model.eval()
    model = UniVL(spec["config"], device=mesh.device)
    model.load_state_dict(load_reference_bin(spec["weights"]), strict=True)
    built.append((spec["config"], spec["weights"], model))
    return model.eval()


def _counted(fn):
    """(``fn()``, its launches on the device, its wrappers' launches)."""
    with LaunchCounts() as counts:
        before, wrappers = counts.launches(), dp_mesh.kernel_launches()
        out = fn()
        after = counts.launches()
    return (out, {k: n - before[k] for k, n in after.items()},
            {k: n - wrappers[k] for k, n in dp_mesh.kernel_launches().items()})


def run_index(spec, mesh, built: list) -> dict:
    index = VideoRetrievalIndex(_model(spec, mesh, built), WordPieceTokenizer(spec["vocab"]),
                                mesh.device, batch_size=spec["batch_size"], store_full=True,
                                mesh=mesh)

    def go():
        index.add(spec["videos"], ids=spec["ids"])
        return {rerank: index.search(spec["queries"], top_k=spec["top_k"], rerank=rerank)
                for rerank in spec["reranks"]}

    results, launches, wrappers = _counted(go)
    return {"video_emb": index.video_emb, "vis_full": index.vis_full, "vm_full": index.vm_full,
            "results": results, "launches": launches, "wrapper_launches": wrappers}


def run_captions(spec, mesh, built: list) -> dict:
    gen = CaptionGenerator(_model(spec, mesh, built), WordPieceTokenizer(spec["vocab"]),
                           mesh.device, mesh=mesh, **spec["options"])

    def go():
        return [[x.cpu() if torch.is_tensor(x) else x for x in gen.decode(b)]
                for b in spec["batches"]]

    out, launches, wrappers = _counted(go)
    return {"tokens": [t for t, _, _ in out], "scores": [s for _, s, _ in out],
            "steps": [n for _, _, n in out], "launches": launches, "wrapper_launches": wrappers}


def run(args, mesh):
    spec = torch.load(args.spec, weights_only=False)
    built = []
    result = {"rank": mesh.rank,
              "pipelines": {s["name"]: run_pipeline(s, mesh) for s in spec.get("pipelines", [])},
              **{kind: {s["name"]: fn(s, mesh, built) for s in spec.get(kind, [])}
                 for kind, fn in (("evals", run_eval), ("indexes", run_index),
                                  ("captions", run_captions))}}
    os.makedirs(args.output, exist_ok=True)
    torch.save(result, os.path.join(args.output, f"rank{mesh.rank}.pt"))
    mesh.barrier()
    return result


if __name__ == "__main__":
    main()
