#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits non-zero:
  1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
  2. the build: every CUDA kernel compiled from univl_tpu_torch/csrc, one
     nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serving paths give it, in f32 and bf16, with device times
     from CUDA events, the bound (bytes over the card's memory rate and
     operations over its peak rate, an estimate against nominal peaks) and,
     where one PyTorch call computes the same function, that call's time;
  4. the retrieval slice: the port's server (univl_tpu_torch.cli.serve) in
     --mode retrieval at the full width of UniVLConfig.base, with random
     weights from a seed, answers add, search (with cross-encoder rerank) and
     save over HTTP. The kernel's launch count must match the traffic, and
     the card's bf16 video embeddings must agree with the port's f32 CPU run
     of the same weights. The first requests' times are smoke readings;
  5. a sustained window of the same traffic: the index grows to YouCook2
     val's 3,328 clips in adds of 64, then takes 200 searches; add rate over
     the window and p50/p99 request latencies;
  6. torch.profiler over one more add and one more search, giving each
     request's device busy time, kernel and copy time, and the
     eval-attention kernel's share;
  7. the caption slice: the server in --mode caption (decoder 3 layers, beam
     5, batch 16, max_len 48) on its default (fused) path answers requests of
     16 ragged clips without and with transcripts; the launch counts must be
     what the decode steps imply; a sequential window of requests (clips/s,
     p50/p99); 16 concurrent one-clip requests through the coalescer; and
     torch.profiler over one request (device busy share, each kernel's share);
  8. the unfused path: a second server with --no-fused_decode
     --no-fused_vocab, in which the reorder kernel runs once per step;
  9. agreement with the CPU: a teacher-forced 47-step trajectory through the
     KV-cache decoder on the card in bf16 against the CPU in f32 (max |dlogp|
     under a stated limit), and the top-beam captions of 8 clips on the card
     in f32 against the CPU.
Then one JSON line describing the kernels, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from univl_tpu_torch import UniVLConfig, WordPieceTokenizer
from univl_tpu_torch.checkpoint.convert import init_state_dict
from univl_tpu_torch.cli.serve import main as serve_main
from univl_tpu_torch.evals.fast_decoder import FastDecoder, encoder_bias
from univl_tpu_torch.kernels import _build
from univl_tpu_torch.kernels import attention as attn
from univl_tpu_torch.kernels import decode_attention as dattn
from univl_tpu_torch.kernels import reorder
from univl_tpu_torch.kernels import vocab_topk
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.serving.captioning import CaptionService
from univl_tpu_torch.serving.index import RERANK_TILE, VideoRetrievalIndex

# retrieval traffic
N_CLIPS, N_QUERIES, TOP_K, RERANK, BATCH = 64, 8, 5, 16, 16
N_FILES = 512  # distinct clip files; the sustained window cycles through them
SUSTAINED_INDEX, SUSTAINED_SEARCHES = 3328, 200  # YouCook2 val's clip count
# caption traffic: requests of BATCH clips, beam BEAM, max_len = max_words
BEAM, MAX_WORDS, DECODER_LAYERS = 5, 48, 3
CAPTION_WINDOW, UNFUSED_WINDOW, CONCURRENT = 20, 10, 16
ATTN_SHAPES = [(16, 12, 48, 64), (16, 12, 96, 64), (128, 12, 96, 64)]  # tower; cross; rerank
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
VOCAB_ATOL = 1e-4  # logp: f32 sums of the same products in another order
DLOGP_LIMIT = 0.25  # card bf16 vs CPU f32 over the trajectory, stated before the first run
SAME_CAPTIONS_MIN = 4  # of 8 clips, card f32 vs CPU f32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, nominal
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor cores bf16; CUDA cores f32
QUERIES = ["stir the soup", "slice the onion", "heat oil in a pan", "add salt and pepper",
           "boil the pasta", "mix flour and water", "fry the chicken", "serve the rice"]
KERNELS = {  # name -> (wrapper with the launch count, source, the TPU kernel it replaces)
    "eval_attention": (attn.fused_attention_masked, "univl_tpu_torch/csrc/attention.cu",
                       "univl_tpu/kernels/attention.py:65"),
    "beam_reorder_groups": (reorder.beam_reorder_groups_inplace,
                            "univl_tpu_torch/csrc/reorder.cu", "univl_tpu/kernels/reorder.py:28"),
    "beam_decode_self_attention": (dattn.beam_decode_self_attention,
                                   "univl_tpu_torch/csrc/decode_attention.cu",
                                   "univl_tpu/kernels/decode_attention.py:77"),
    "vocab_topk": (vocab_topk.classify_topk, "univl_tpu_torch/csrc/vocab_topk.cu",
                   "univl_tpu/kernels/vocab_topk.py:62"),
}
TRACE_NAMES = {"eval_attention": ("eval_attention_kernel",),
               "beam_reorder_groups": ("reorder_groups_kernel",),
               "beam_decode_self_attention": ("decode_attention_kernel",),
               "vocab_topk": ("vocab_tile_kernel", "vocab_merge_kernel")}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def reset_launches() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}


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


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """The least time for the work, an estimate against nominal peaks: the
    larger of bytes over the memory rate and operations over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def report(name: str, shape: str, dtype, err: float, ms, plain, bound, library=None) -> dict:
    b_ms, b_by = bound
    lib = f"{library[0]:.5f} ({library[1]})" if library else "none"
    print(f"{name} {shape} {dtype_name(dtype)}: max_abs_err {err:.3e}; device ms per call: "
          f"kernel {ms[0]:.5f}, plain {plain[0]:.5f}, one PyTorch call {lib}; host-paced ms: "
          f"kernel {ms[1]:.5f}, plain {plain[1]:.5f}; bound {b_ms:.5f} ms by {b_by} (estimate "
          f"against nominal peaks)", flush=True)
    return {"max_abs_err": err, "ms": ms[0], "plain_ms": plain[0], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library[0] if library else None}


def kernel_eval_attention() -> dict:
    """Kernel vs plain version on strided head-split views, as the model calls it."""
    worst, row = 0.0, None
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
            atol, rtol = TOL[dtype_name(dtype)]
            excess = float((diff - atol - rtol * want.float()[rows].abs()).max())
            err = float(diff.max())
            worst = max(worst, err)
            ms = cuda_time_ms(lambda: attn.fused_attention_masked(q, k, v, mask))
            plain = cuda_time_ms(lambda: attn.attention_reference(q, k, v, mask))
            keep = mask.bool()[:, None, None, :]
            sdpa = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
            n_bytes = 4 * B * H * L * D * q.element_size() + mask.numel() * 4
            bound = bound_ms(n_bytes, 4.0 * B * H * L * L * D, dtype_name(dtype))
            r = report("eval_attention", str([B, H, L, D]), dtype, err, ms, plain, bound,
                       (sdpa[0], "scaled_dot_product_attention, boolean key mask"))
            require(excess <= 0.0, f"eval_attention disagrees with its plain version at "
                                   f"{[B, H, L, D]} {dtype}: max abs err {err}")
            if (B, L, dtype) == (16, 48, torch.bfloat16):
                row = r
    return {**row, "max_abs_err": worst}


def kernel_reorder() -> dict:
    """6 caches (3 decoder layers x k, v) of [80, 12, L, 64] permuted in place
    within groups of 5; one buffer holds the six, so one index_select is the
    same function out of place."""
    N, H, D, K, n = BATCH * BEAM, 12, 64, BEAM, 2 * DECODER_LAYERS
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for L in (32, MAX_WORDS):
            g = torch.Generator(device="cuda").manual_seed(1)
            buf = torch.randn(n, N, H, L, D, generator=g, device="cuda").to(dtype)
            prev_k = torch.randint(0, K, (N,), generator=g, device="cuda")
            prev_k[:K] = torch.tensor([4, 0, 0, 3, 1])  # a permutation with a repeat
            got, want = buf.clone(), buf.clone()
            reorder.beam_reorder_groups_inplace(list(got), prev_k, K)
            reorder.reorder_reference(list(want), prev_k, K)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"reorder differs from its plain version at L={L} "
                                            f"{dtype}")
            src = reorder.source_rows(prev_k, K)
            arrays = list(buf)
            ms = cuda_time_ms(lambda: reorder.beam_reorder_groups_inplace(arrays, prev_k, K))
            plain = cuda_time_ms(lambda: reorder.reorder_reference(arrays, prev_k, K))
            lib = cuda_time_ms(lambda: torch.index_select(buf, 1, src))
            bound = bound_ms(2.0 * buf.numel() * buf.element_size() + 8 * N, 0.0,
                             dtype_name(dtype))
            r = report("beam_reorder_groups", f"6 x {[N, H, L, D]}", dtype, 0.0, ms, plain,
                       bound, (lib[0], "index_select over the six, out of place"))
            if (L, dtype) == (MAX_WORDS, torch.bfloat16):
                row = r
    return row


def kernel_decode_attention() -> dict:
    """q, k_new, v_new [80, 12, 64] as views of one projection output, caches
    [80, 12, L, 64] zero beyond t, a permutation that is not the identity."""
    N, H, D, K = BATCH * BEAM, 12, 64, BEAM
    scale = 1.0 / math.sqrt(D)
    worst, row = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        for L, t in ((32, 0), (32, 31), (MAX_WORDS, MAX_WORDS - 1)):
            g = torch.Generator(device="cuda").manual_seed(2)
            f = torch.randn(N, 3 * H * D, generator=g, device="cuda").to(dtype)
            q, kn, vn = (f[:, i * H * D:(i + 1) * H * D].view(N, H, D) for i in range(3))
            kc, vc = (torch.randn(N, H, L, D, generator=g, device="cuda").to(dtype)
                      for _ in range(2))
            kc[:, :, t:] = 0
            vc[:, :, t:] = 0
            prev_k = torch.randint(0, K, (N,), generator=g, device="cuda")
            prev_k[:K] = torch.tensor([4, 0, 0, 3, 1])
            args = (q, kn, vn, kc, vc, prev_k, t, K)
            ctx, ko, vo = dattn.beam_decode_self_attention(*args, scale=scale)
            ctx_r, ko_r, vo_r = dattn.decode_attention_reference(*args, scale)
            torch.cuda.synchronize()
            require(torch.equal(ko, ko_r) and torch.equal(vo, vo_r),
                    f"decode attention's caches differ from the plain version's at L={L} t={t}")
            atol, rtol = TOL[dtype_name(dtype)]
            diff = (ctx.float() - ctx_r.float()).abs()
            err = float(diff.max())
            worst = max(worst, err)
            require(float((diff - atol - rtol * ctx_r.float().abs()).max()) <= 0.0,
                    f"decode attention disagrees with its plain version at L={L} t={t} {dtype}: "
                    f"max abs err {err}")
            ms = cuda_time_ms(lambda: dattn.beam_decode_self_attention(*args, scale=scale))
            plain = cuda_time_ms(lambda: dattn.decode_attention_reference(*args, scale))
            es = kc.element_size()
            n_bytes = (3 * N * H * D * es + 2 * N * H * t * D * es  # q, k_new, v_new; cache < t
                       + 2 * N * H * L * D * es + N * H * D * es + 8 * N)  # caches, ctx out
            bound = bound_ms(n_bytes, 4.0 * N * H * (t + 1) * D, dtype_name(dtype))
            r = report("beam_decode_self_attention", f"{[N, H, L, D]} t={t}", dtype, err, ms,
                       plain, bound)
            if (L, dtype) == (MAX_WORDS, torch.bfloat16):
                row = r
    return {**row, "max_abs_err": worst}


def kernel_vocab_topk() -> dict:
    """h [80, 768] against BERT's tied 30,522 x 768 classifier, k = 5."""
    R, Hd, V, k = BATCH * BEAM, 768, 30522, BEAM
    worst, row = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(3)
        h = torch.randn(R, Hd, generator=g, device="cuda").to(dtype)
        w = (0.02 * torch.randn(V, Hd, generator=g, device="cuda")).to(dtype)
        b = 0.02 * torch.randn(V, generator=g, device="cuda")
        wp, bp = vocab_topk.pad_vocab_inputs(w, b)
        logp, idx = vocab_topk.classify_topk(h, wp, bp, k)
        ref_v, ref_i = vocab_topk.classify_topk_reference(h, w, b, k + 1)
        torch.cuda.synchronize()
        err = float((logp - ref_v[:, :k]).abs().max())
        worst = max(worst, err)
        require(err <= VOCAB_ATOL, f"vocab top-k values differ from the plain version's by {err}")
        # indices must agree wherever a value is clear of its neighbours
        gaps = (ref_v[:, :-1] - ref_v[:, 1:]).abs()
        clear = torch.minimum(torch.cat([gaps[:, :1], gaps[:, :-1]], 1), gaps[:, :k]) > VOCAB_ATOL
        require(bool((idx[clear] == ref_i[:, :k][clear]).all()),
                f"vocab top-k indices differ from the plain version's at {dtype}")
        ms = cuda_time_ms(lambda: vocab_topk.classify_topk(h, wp, bp, k))
        plain = cuda_time_ms(lambda: vocab_topk.classify_topk_reference(h, w, b, k))
        es = h.element_size()
        n_bytes = V * Hd * es + R * Hd * es + 4 * V + 12 * R * k
        bound = bound_ms(n_bytes, 2.0 * R * Hd * V, dtype_name(dtype))
        r = report("vocab_topk", f"h {[R, Hd]} W {[V, Hd]} k={k} ({int(clear.sum())} of "
                                 f"{R * k} indices clear of ties)", dtype, err, ms, plain, bound)
        if dtype == torch.bfloat16:
            row = r
    return {**row, "max_abs_err": worst}


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


def start_server(argv):
    server = serve_main(argv, serve_forever=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop_server(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    require(not thread.is_alive(), "the server thread did not stop")


def phase_slice(tmp: str, vocab: str, paths, clips) -> int:
    t0 = time.perf_counter()
    server, thread = start_server(
        ["--device", "cuda", "--mode", "retrieval", "--train_sim_after_cross",
         "--rerank_store_full", "--vocab_file", vocab, "--output_dir", os.path.join(tmp, "out"),
         "--port", "0", "--max_words", "48", "--max_frames", "48",
         "--serve_batch_size", str(BATCH), "--seed", "0"])
    print(f"retrieval server up in {time.perf_counter() - t0:.1f} s", flush=True)
    port = server.server_address[1]
    cfg = UniVLConfig.base(max_words=48, max_frames=48, train_sim_after_cross=True)
    search = {"queries": QUERIES, "top_k": TOP_K, "rerank": RERANK}
    try:
        reset_launches()
        t0 = time.perf_counter()
        out = post(port, "/v1/retrieval/add",
                   {"feature_paths": paths[:N_CLIPS], "ids": [f"c{i}" for i in range(N_CLIPS)]})
        t_add = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = post(port, "/v1/retrieval/search", search)["results"]
        t_search = time.perf_counter() - t0
        counts = read_launches()
        launches = counts["eval_attention"]
        require(out["indexed"] == N_CLIPS, f"indexed {out['indexed']}")
        check_results(res, N_QUERIES)
        batches = -(-N_CLIPS // BATCH), -(-N_QUERIES // BATCH), -(-N_QUERIES // RERANK_TILE)
        expected = (batches[0] * cfg.visual.num_hidden_layers
                    + batches[1] * cfg.bert.num_hidden_layers
                    + batches[2] * cfg.cross.num_hidden_layers)
        print(f"eval_attention launches {launches}, traffic implies {expected} "
              f"({batches[0]} add batches x {cfg.visual.num_hidden_layers} + {batches[1]} "
              f"search batch x {cfg.bert.num_hidden_layers} + {batches[2]} rerank tile x "
              f"{cfg.cross.num_hidden_layers}); the decode kernels {counts}", flush=True)
        require(launches == expected, f"{launches} kernel launches, traffic implies {expected}")
        require(sum(counts.values()) == launches, f"a decode kernel ran on retrieval: {counts}")
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
        stop_server(server, thread)

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


def profile_request(port: int, path: str, body: dict, name: str, trace: str) -> None:
    """torch.profiler over one request through the server. Device busy time is
    the union of the trace's kernel, copy and memset intervals."""
    from torch.profiler import ProfilerActivity, profile

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
    copies = [e for e in events if e["cat"] != "kernel"]

    def ms(es):
        return sum(e["dur"] for e in es) / 1e3

    kernel_ms = ms(kernels)
    ours = []
    for kname, needles in TRACE_NAMES.items():
        mine = [e for e in kernels if any(n in e["name"] for n in needles)]
        if mine:
            ours.append(f"{kname} {ms(mine):.3f} ms in {len(mine)} launches "
                        f"({ms(mine) / kernel_ms:.4f} of kernel time)")
    print(f"profile {name} (profiler on): wall {wall_ms:.3f} ms; device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / wall_ms:.4f} of wall); kernels "
          f"{kernel_ms:.3f} ms in {len(kernels)} launches; copies and memsets "
          f"{ms(copies):.3f} ms in {len(copies)}; {'; '.join(ours)}", flush=True)


def phase_profile(port: int, paths, tmp: str, search: dict) -> None:
    trace = os.path.join(tmp, "trace.json")
    profile_request(port, "/v1/retrieval/add",
                    {"feature_paths": paths[:N_CLIPS], "ids": [f"p{i}" for i in range(N_CLIPS)]},
                    f"add {N_CLIPS} clips", trace)
    profile_request(port, "/v1/retrieval/search", search,
                    f"search {N_QUERIES} queries rerank {RERANK}", trace)


def caption_body(paths, i: int, transcripts: bool) -> dict:
    """Request i: BATCH clips, cycling through the clip files."""
    files = [paths[(i * BATCH + j) % len(paths)] for j in range(BATCH)]
    body = {"feature_paths": files}
    if transcripts:
        body["transcripts"] = [QUERIES[(i + j) % len(QUERIES)] for j in range(BATCH)]
    return body


def check_captions(out: dict, n: int) -> list:
    caps = out["captions"]
    require(len(caps) == n and all(isinstance(c, str) for c in caps),
            f"{len(caps)} captions for {n} clips")
    return caps


def phase_caption(tmp: str, vocab: str, paths, fused: bool) -> dict:
    """The caption server on its default (fused) path, or with
    --no-fused_decode --no-fused_vocab; returns its launch counts and captions."""
    label = "fused" if fused else "unfused"
    t0 = time.perf_counter()
    server, thread = start_server(
        ["--device", "cuda", "--mode", "caption", "--vocab_file", vocab,
         "--output_dir", os.path.join(tmp, f"out_{label}"), "--port", "0",
         "--max_words", str(MAX_WORDS), "--max_frames", "48", "--beam_size", str(BEAM),
         "--decoder_num_hidden_layers", str(DECODER_LAYERS), "--serve_batch_size", str(BATCH),
         "--seed", "0"] + ([] if fused else ["--no-fused_decode", "--no-fused_vocab"]))
    port = server.server_address[1]
    svc = server.caption_service
    gen = svc.generator
    require((svc.fused_decode, svc.fused_vocab) == (fused, fused),
            f"caption service fused_decode {svc.fused_decode}, fused_vocab {svc.fused_vocab}")
    print(f"caption server ({label}) up in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = UniVLConfig.base(max_words=MAX_WORDS, max_frames=48, stage_two=True)
    try:
        reset_launches()
        gen.steps = gen.batches = 0
        captions = []
        for i, transcripts in enumerate((False, True)):
            t0 = time.perf_counter()
            captions += check_captions(post(port, "/v1/caption",
                                            caption_body(paths, i, transcripts)), BATCH)
            print(f"smoke reading ({label}): caption request of {BATCH} clips, transcripts "
                  f"{transcripts}: {1e3 * (time.perf_counter() - t0):.3f} ms", flush=True)
        counts, steps, batches = read_launches(), gen.steps, gen.batches
        per_batch = (cfg.bert.num_hidden_layers + cfg.visual.num_hidden_layers
                     + cfg.cross.num_hidden_layers)
        expected = {"eval_attention": per_batch * batches,
                    "beam_reorder_groups": 0 if fused else steps,
                    "beam_decode_self_attention": DECODER_LAYERS * steps if fused else 0,
                    "vocab_topk": steps if fused else 0}
        print(f"caption ({label}): {batches} batches, {steps} decode steps (of at most "
              f"{batches * (MAX_WORDS - 1)}); launches {counts}, the steps imply {expected}",
              flush=True)
        require(counts == expected, f"caption ({label}) launches {counts}, steps imply {expected}")
        require(steps >= batches, f"{steps} decode steps for {batches} batches")

        window, lat, steps0 = UNFUSED_WINDOW if not fused else CAPTION_WINDOW, [], gen.steps
        t_window = time.perf_counter()
        for i in range(window):
            t0 = time.perf_counter()
            check_captions(post(port, "/v1/caption", caption_body(paths, 2 + i, i % 2 == 1)),
                           BATCH)
            lat.append(time.perf_counter() - t0)
        t_window = time.perf_counter() - t_window
        print(f"caption window ({label}): {window} sequential requests of {BATCH} clips "
              f"(alternately without and with transcripts), {gen.steps - steps0} decode steps: "
              f"{window * BATCH / t_window:.3f} clips/s over the window; request p50 "
              f"{percentile_ms(lat, 50):.3f} ms, p99 {percentile_ms(lat, 99):.3f} ms", flush=True)

        if fused:
            batches0 = gen.batches
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=CONCURRENT) as ex:
                futs = [ex.submit(post, port, "/v1/caption", {"feature_paths": [paths[i]]})
                        for i in range(CONCURRENT)]
                for f in futs:
                    check_captions(f.result(timeout=600), 1)
            print(f"coalescer: {CONCURRENT} concurrent one-clip requests in "
                  f"{1e3 * (time.perf_counter() - t0):.3f} ms, served by "
                  f"{gen.batches - batches0} decode batches", flush=True)
            require(gen.batches - batches0 < CONCURRENT, "the coalescer merged no requests")
            profile_request(port, "/v1/caption", caption_body(paths, 0, False),
                            f"caption {BATCH} clips ({label})", os.path.join(tmp, "trace.json"))
    finally:
        stop_server(server, thread)
    require(not server.caption_coalescer._worker.is_alive(), "the coalescer did not stop")
    return {"launches": counts, "captions": captions}


def phase_agreement(vocab: str, clips) -> None:
    """The card against the CPU with the same weights."""
    tok = WordPieceTokenizer(vocab)
    base = dict(max_words=MAX_WORDS, max_frames=48, stage_two=True, task_type="caption")
    cfg32 = UniVLConfig.base(**base)
    sd = init_state_dict(cfg32, seed=0)
    models = {}
    for name, dev, dtype in (("cpu", "cpu", "float32"), ("card_bf16", "cuda", "bfloat16"),
                             ("card_f32", "cuda", "float32")):
        m = UniVL(cfg32.replace(compute_dtype=dtype), device=dev)
        m.load_state_dict(sd, strict=True)
        models[name] = (m.eval(), torch.device(dev))

    services = {name: CaptionService(models[name][0], tok, models[name][1], beam_size=BEAM,
                                     batch_size=8) for name in ("cpu", "card_f32")}
    require(services["card_f32"].fused_decode and services["card_f32"].fused_vocab,
            "the card's f32 caption service is not on the fused path")

    # teacher-forced trajectory through the KV-cache decoder
    n, steps = 8, MAX_WORDS - 1
    batch = services["cpu"]._build_batch(clips[:n], None)
    tokens = np.random.RandomState(4).randint(5, 30522, (n, steps))
    logps = {}
    for name in ("cpu", "card_bf16"):
        model, dev = models[name]
        with torch.inference_mode():
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            seq, vis = model.encode(b["input_ids"], b["token_type_ids"], b["attention_mask"],
                                    b["video"], b["video_mask"])
            cross, _, mask = model.get_cross_output(seq, vis, b["attention_mask"],
                                                    b["video_mask"])
            fd = FastDecoder(model)
            enc_kv, bias = fd.precompute_enc_kv(cross), encoder_bias(mask)
            cache = fd.init_cache(n, MAX_WORDS)
            identity = torch.zeros(n, dtype=torch.long, device=dev)
            out = []
            for t in range(steps):
                tok_t = torch.from_numpy(tokens[:, t]).to(dev)
                logits, cache = fd.step_fused(tok_t, t, cache, enc_kv, bias, identity, 1)
                out.append(torch.log_softmax(logits, dim=-1).cpu())
        logps[name] = torch.stack(out)
    dlogp = float((logps["card_bf16"] - logps["cpu"]).abs().max())
    require(bool(torch.isfinite(logps["card_bf16"]).all()), "non-finite logp on the card")
    print(f"agreement: teacher-forced {steps}-step trajectory of {n} clips through the KV-cache "
          f"decoder (decode-attention kernel, identity permutation), card bf16 vs CPU f32: max "
          f"|dlogp| {dlogp:.4e} over all {logps['cpu'].numel()} entries (limit {DLOGP_LIMIT})",
          flush=True)
    require(dlogp <= DLOGP_LIMIT, f"card vs CPU |dlogp| {dlogp} > {DLOGP_LIMIT}")

    # top-beam captions of 8 clips, card f32 (its kernels) vs CPU f32 (plain versions)
    captions = {name: svc.caption(clips[:8]) for name, svc in services.items()}
    same = sum(a == b for a, b in zip(captions["cpu"], captions["card_f32"]))
    print(f"agreement: top-beam captions of 8 clips, card f32 (fused kernels) vs CPU f32 (plain "
          f"versions): {same} of 8 the same (at least {SAME_CAPTIONS_MIN} required)", flush=True)
    require(same >= SAME_CAPTIONS_MIN, f"only {same} of 8 captions agree")


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

    measured = {"eval_attention": kernel_eval_attention(),
                "beam_reorder_groups": kernel_reorder(),
                "beam_decode_self_attention": kernel_decode_attention(),
                "vocab_topk": kernel_vocab_topk()}
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        vocab = write_vocab(os.path.join(tmp, "vocab.txt"))
        rng = np.random.RandomState(0)
        clips = [rng.randn(rng.randint(8, 49), 1024).astype(np.float32) for _ in range(N_FILES)]
        paths = []
        for i, c in enumerate(clips):
            paths.append(os.path.join(tmp, f"clip{i}.npy"))
            np.save(paths[-1], c)
        by_path["retrieval"] = {**{k: 0 for k in KERNELS},
                                "eval_attention": phase_slice(tmp, vocab, paths, clips)}
        fused = phase_caption(tmp, vocab, paths, fused=True)
        unfused = phase_caption(tmp, vocab, paths, fused=False)
        by_path["caption"], by_path["caption_unfused"] = fused["launches"], unfused["launches"]
        same = sum(a == b for a, b in zip(fused["captions"], unfused["captions"]))
        print(f"fused vs unfused captions (bf16, same requests): {same} of "
              f"{len(fused['captions'])} the same", flush=True)
        phase_agreement(vocab, clips)

    rows = []
    for name, (wrapper, source, replaces) in KERNELS.items():
        launches = sum(counts[name] for counts in by_path.values())
        require(launches > 0, f"{name} never launched on the serving paths")
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches,
                     "launches_by_path": {p: c[name] for p, c in by_path.items()},
                     **measured[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
