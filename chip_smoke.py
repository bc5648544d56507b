#!/usr/bin/env python3
"""Drive the PyTorch port's retrieval-serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits non-zero:
  1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
  2. the build: every CUDA kernel compiled from univl_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, with times from CUDA events;
  4. the slice: the port's retrieval server (univl_tpu_torch.cli.serve) at
     the full width of UniVLConfig.base, with random weights from a seed,
     answers add, search (with cross-encoder rerank) and save over HTTP. The
     kernel's launch count must match the traffic, and the card's bf16 video
     embeddings must agree with the port's f32 CPU run of the same weights.
     The first requests' times are single-request smoke readings;
  5. a sustained window of the same traffic: the index grows to YouCook2
     val's 3,328 clips in adds of 64, then takes 200 searches; add rate over
     the window and p50/p99 request latencies;
  6. torch.profiler over one more add and one more search, giving each
     request's device busy time, kernel and copy time, and the
     eval-attention kernel's share.
Then one JSON line describing the kernels, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from univl_tpu_torch import UniVLConfig, WordPieceTokenizer
from univl_tpu_torch.checkpoint.convert import init_state_dict
from univl_tpu_torch.cli.serve import main as serve_main
from univl_tpu_torch.kernels import _build
from univl_tpu_torch.kernels import attention as attn
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.serving.index import RERANK_TILE, VideoRetrievalIndex

# slice traffic
N_CLIPS, N_QUERIES, TOP_K, RERANK, BATCH = 64, 8, 5, 16, 16
N_FILES = 512  # distinct clip files; the sustained window cycles through them
SUSTAINED_INDEX, SUSTAINED_SEARCHES = 3328, 200  # YouCook2 val's clip count
ATTN_SHAPES = [(16, 12, 48, 64), (128, 12, 96, 64)]  # text/video batch; rerank 8 x 16 pairs
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
QUERIES = ["stir the soup", "slice the onion", "heat oil in a pan", "add salt and pepper",
           "boil the pasta", "mix flour and water", "fry the chicken", "serve the rice"]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_time_ms(fn, runs: int = 20, repeats: int = 5):
    """(device ms, host-paced ms) per call of fn, each the median of `repeats`.

    Device time: a sleep kernel holds the stream while the host queues `runs`
    calls, so CUDA events around them see the calls back to back on the card.
    Host-paced time: CUDA events around single calls, which also count the
    gaps while the card waits for the host to launch the next kernel."""

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    fn()
    torch.cuda.synchronize()
    device, paced = [], []
    for _ in range(repeats):
        start, end = events()
        torch.cuda._sleep(50_000_000)  # ~30 ms at 1.7 GHz: longer than queueing the calls
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / runs)
        for _ in range(runs):
            start, end = events()
            start.record()
            fn()
            end.record()
            end.synchronize()
            paced.append(start.elapsed_time(end))
    return float(np.median(device)), float(np.median(paced))


def phase_kernels() -> dict:
    """Kernel vs plain version on strided head-split views, as the model calls it."""
    worst, timing = 0.0, None
    for B, H, L, D in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(B, L, H * D, generator=g, device="cuda").to(dtype)
                       .view(B, L, H, D).transpose(1, 2) for _ in range(3))
            mask = (torch.rand(B, L, generator=g, device="cuda") > 0.3).float()
            mask[0] = 0.0
            mask[0, L // 2] = 1.0  # a single valid key
            mask[1] = 0.0  # no valid key: a padding row, left out of the comparison
            got = attn.fused_attention_masked(q, k, v, mask)
            want = attn.attention_reference(q, k, v, mask)
            torch.cuda.synchronize()
            rows = mask.sum(dim=1) > 0
            diff = (got.float() - want.float())[rows].abs()
            atol, rtol = TOL[str(dtype).split(".")[1]]
            excess = float((diff - atol - rtol * want.float()[rows].abs()).max())
            max_abs = float(diff.max())
            worst = max(worst, max_abs)
            ms, ms_paced = cuda_time_ms(lambda: attn.fused_attention_masked(q, k, v, mask))
            plain_ms, plain_paced = cuda_time_ms(lambda: attn.attention_reference(q, k, v, mask))
            print(f"eval_attention {[B, H, L, D]} {dtype}: max_abs_err {max_abs:.3e} "
                  f"(atol {atol}, rtol {rtol}); device ms per call: kernel {ms:.5f}, plain "
                  f"{plain_ms:.5f}; host-paced ms per call: kernel {ms_paced:.5f}, plain "
                  f"{plain_paced:.5f}", flush=True)
            require(excess <= 0.0, f"eval_attention disagrees with its plain version at "
                                   f"{[B, H, L, D]} {dtype}: max abs err {max_abs}")
            if (B, dtype) == (16, torch.bfloat16):
                timing = (ms, plain_ms)
    return {"max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def write_vocab(path: str) -> str:
    """A vocab of BERT's 30,522 entries: the specials, the queries' words,
    single characters and their ## pieces, then [unusedN]."""
    chars = "abcdefghijklmnopqrstuvwxyz0123456789"
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += sorted({w for q in QUERIES for w in q.split()})
    tokens = list(dict.fromkeys(tokens + list(chars) + ["##" + c for c in chars]))
    tokens += [f"[unused{i}]" for i in range(30522 - len(tokens))]
    with open(path, "w") as f:
        f.write("\n".join(tokens) + "\n")
    return path


def post(port: int, path: str, obj) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:  # raises on a non-200 reply
        require(r.status == 200, f"{path} answered {r.status}")
        return json.loads(r.read())


def check_results(results, n_queries: int) -> None:
    require(len(results) == n_queries, f"{len(results)} result lists for {n_queries} queries")
    for hits in results:
        scores = [h["score"] for h in hits]
        require(len(hits) == TOP_K, f"{len(hits)} hits, want {TOP_K}")
        require(all(np.isfinite(scores)), f"non-finite scores {scores}")
        require(scores == sorted(scores, reverse=True), f"scores out of order {scores}")


def percentile_ms(seconds, q: float) -> float:
    return 1e3 * float(np.percentile(seconds, q))


def phase_slice(tmp: str) -> int:
    vocab = write_vocab(os.path.join(tmp, "vocab.txt"))
    rng = np.random.RandomState(0)
    clips = [rng.randn(rng.randint(8, 49), 1024).astype(np.float32) for _ in range(N_FILES)]
    paths = []
    for i, c in enumerate(clips):
        paths.append(os.path.join(tmp, f"clip{i}.npy"))
        np.save(paths[-1], c)

    t0 = time.perf_counter()
    server = serve_main(
        ["--device", "cuda", "--mode", "retrieval", "--train_sim_after_cross",
         "--rerank_store_full", "--vocab_file", vocab, "--output_dir", os.path.join(tmp, "out"),
         "--port", "0", "--max_words", "48", "--max_frames", "48",
         "--serve_batch_size", str(BATCH), "--seed", "0"],
        serve_forever=False)
    print(f"server up in {time.perf_counter() - t0:.1f} s", flush=True)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    cfg = UniVLConfig.base(max_words=48, max_frames=48, train_sim_after_cross=True)
    search = {"queries": QUERIES, "top_k": TOP_K, "rerank": RERANK}
    try:
        attn.fused_attention_masked.launches = 0
        t0 = time.perf_counter()
        out = post(port, "/v1/retrieval/add",
                   {"feature_paths": paths[:N_CLIPS], "ids": [f"c{i}" for i in range(N_CLIPS)]})
        t_add = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = post(port, "/v1/retrieval/search", search)["results"]
        t_search = time.perf_counter() - t0
        launches = attn.fused_attention_masked.launches
        require(out["indexed"] == N_CLIPS, f"indexed {out['indexed']}")
        check_results(res, N_QUERIES)
        batches = -(-N_CLIPS // BATCH), -(-N_QUERIES // BATCH), -(-N_QUERIES // RERANK_TILE)
        expected = (batches[0] * cfg.visual.num_hidden_layers
                    + batches[1] * cfg.bert.num_hidden_layers
                    + batches[2] * cfg.cross.num_hidden_layers)
        print(f"eval_attention launches {launches}, traffic implies {expected} "
              f"({batches[0]} add batches x {cfg.visual.num_hidden_layers} + {batches[1]} "
              f"search batch x {cfg.bert.num_hidden_layers} + {batches[2]} rerank tile x "
              f"{cfg.cross.num_hidden_layers})", flush=True)
        require(launches == expected, f"{launches} kernel launches, traffic implies {expected}")
        index_path = os.path.join(tmp, "index.npz")
        post(port, "/v1/retrieval/save", {"path": index_path})
        print(f"smoke reading, first requests (one each): add {N_CLIPS / t_add:.3f} clips/s, "
              f"search {1e3 * t_search:.3f} ms", flush=True)

        t0 = time.perf_counter()
        out = post(port, "/v1/retrieval/add", {"feature_paths": paths[N_CLIPS:2 * N_CLIPS],
                                               "ids": [f"w{i}" for i in range(N_CLIPS)]})
        t_add = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = post(port, "/v1/retrieval/search", search)["results"]
        t_search = time.perf_counter() - t0
        check_results(res, N_QUERIES)
        print(f"smoke reading, second requests (one each): add {N_CLIPS / t_add:.3f} clips/s "
              f"({N_CLIPS} clips, batch {BATCH}); search {1e3 * t_search:.3f} ms "
              f"({N_QUERIES} queries, top_k {TOP_K}, rerank {RERANK}, {out['indexed']} indexed)",
              flush=True)

        phase_sustained(port, paths, out["indexed"], search)
        phase_profile(port, paths, tmp, search)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # the same weights on the CPU in f32, through the port's plain versions
    with np.load(index_path) as z:
        card = z["video_emb"][:8]
    model = UniVL(cfg)
    model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
    cpu_idx = VideoRetrievalIndex(model.eval(), WordPieceTokenizer(vocab), "cpu", batch_size=8)
    cpu_idx.add(clips[:8])
    cos = np.sum(card * cpu_idx.video_emb, axis=1)
    print(f"card bf16 vs CPU f32 pooled video embeddings: cosine min {cos.min():.6f}, "
          f"mean {cos.mean():.6f} (8 clips)", flush=True)
    require(card.shape == (8, cfg.bert.hidden_size) and np.isfinite(card).all(),
            f"card embeddings {card.shape}, finite {np.isfinite(card).all()}")
    require(cos.min() >= 0.99, f"card vs CPU cosine {cos.min()} < 0.99")
    return launches


def phase_sustained(port: int, paths, indexed: int, search: dict) -> None:
    """The smoke traffic over a window: adds of N_CLIPS clips, cycling through
    the clip files under new ids, until the index holds SUSTAINED_INDEX clips;
    then SUSTAINED_SEARCHES searches over that index, one at a time."""
    first, add_s = indexed, []
    t_window = time.perf_counter()
    while indexed < SUSTAINED_INDEX:
        n = min(N_CLIPS, SUSTAINED_INDEX - indexed)
        body = {"feature_paths": [paths[(indexed + i) % len(paths)] for i in range(n)],
                "ids": [f"s{indexed + i}" for i in range(n)]}
        t0 = time.perf_counter()
        got = post(port, "/v1/retrieval/add", body)["indexed"]
        add_s.append(time.perf_counter() - t0)
        require(got == indexed + n, f"indexed {got}, want {indexed + n}")
        indexed = got
    add_window = time.perf_counter() - t_window

    search_s = []
    t_window = time.perf_counter()
    for _ in range(SUSTAINED_SEARCHES):
        t0 = time.perf_counter()
        res = post(port, "/v1/retrieval/search", search)["results"]
        search_s.append(time.perf_counter() - t0)
        check_results(res, N_QUERIES)
    search_window = time.perf_counter() - t_window
    print(f"sustained add: {indexed - first} clips in {len(add_s)} requests of {N_CLIPS} "
          f"(index {first} -> {indexed}): {(indexed - first) / add_window:.3f} clips/s over "
          f"the window; request p50 {percentile_ms(add_s, 50):.3f} ms, p99 "
          f"{percentile_ms(add_s, 99):.3f} ms", flush=True)
    print(f"sustained search: {SUSTAINED_SEARCHES} requests of {N_QUERIES} queries (top_k "
          f"{TOP_K}, rerank {RERANK}) over {indexed} clips: "
          f"{SUSTAINED_SEARCHES / search_window:.3f} requests/s; request p50 "
          f"{percentile_ms(search_s, 50):.3f} ms, p99 {percentile_ms(search_s, 99):.3f} ms",
          flush=True)


def phase_profile(port: int, paths, tmp: str, search: dict) -> None:
    """torch.profiler over one add and one search through the server. Device
    busy time is the union of the trace's kernel, copy and memset intervals."""
    from torch.profiler import ProfilerActivity, profile

    requests = [
        (f"add {N_CLIPS} clips", "/v1/retrieval/add",
         {"feature_paths": paths[:N_CLIPS], "ids": [f"p{i}" for i in range(N_CLIPS)]}),
        (f"search {N_QUERIES} queries rerank {RERANK}", "/v1/retrieval/search", search),
    ]
    trace = os.path.join(tmp, "trace.json")
    for name, path, body in requests:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            post(port, path, body)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        require(bool(events), f"profile {name}: the trace holds no device activity")
        busy_us, end = 0.0, float("-inf")
        for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
            busy_us += max(0.0, e - max(s, end))
            end = max(end, e)
        kernels = [e for e in events if e["cat"] == "kernel"]
        attention = [e for e in kernels if "eval_attention" in e["name"]]
        copies = [e for e in events if e["cat"] != "kernel"]

        def ms(es):
            return sum(e["dur"] for e in es) / 1e3

        print(f"profile {name} (profiler on): wall {wall_ms:.3f} ms; device busy "
              f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / wall_ms:.4f} of wall); kernels "
              f"{ms(kernels):.3f} ms in {len(kernels)} launches; copies and memsets "
              f"{ms(copies):.3f} ms in {len(copies)}; eval_attention {ms(attention):.3f} ms "
              f"in {len(attention)} launches", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {os.path.relpath(lib_path)} in {time.perf_counter() - t0:.1f} s", flush=True)

    measured = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_slice(tmp)

    print(json.dumps({"kernels": [{
        "name": "eval_attention", "route": "cuda",
        "source": "univl_tpu_torch/csrc/attention.cu",
        "replaces": "univl_tpu/kernels/attention.py:65",
        "launches": launches, **measured,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
