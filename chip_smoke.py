#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, evaluation and pretraining
paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits non-zero:
  1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
  2. the build: every CUDA kernel compiled from univl_tpu_torch/csrc, one
     nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it, in f32 and bf16, with device times from CUDA
     events, the bound (bytes over the card's memory rate and operations over
     its peak rate, an estimate against nominal peaks) and, where one PyTorch
     call computes the same function, that call's time. The eval attention
     (#1) at a tower's, the cross tower's, the rerank's and the FT-Align
     eval rescoring's shapes: bf16 on its tensor-core kernel (each call's
     launch checked by the counters; the CUDA-core kernel checked and timed
     beside it on the same inputs), f32 on the CUDA-core kernel. The
     training attention (#2) runs forward and backward at rates 0 and 0.1
     at the FT-Joint towers' [32, 48], FT-Align's cross [1024, 96] and the
     caption step's 96, 128, 224 and 128 x 224
     positions: in bf16 its tensor-core kernels (each call's launches
     checked by the counters: never the tiled backward) and the CUDA-core
     kernels on the same inputs, in f32 the CUDA-core kernels (the tiled
     backward past 96 positions); forward kernel, backward kernel and plain
     version must drop the same probabilities, at the configured rate, at
     [32, 48] and a ragged [32, 40]; bf16 times of the tensor-core kernels
     beside the CUDA-core ones, SDPA and the bound; the tiled backward
     bitwise the whole-head one where both run. The fused FFN kernels (#3 FFN,
     #4 FFN block, #5 dense block), forward and backward, run at the cross
     tower's 98,304 rows, a tower's 1,536 and a ragged 300 and 6,000, rates 0
     and 0.1, beside the model's unfused chain for the same work (times with
     TFLOP/s); #4's and #5's forward kernel, backward kernel and plain
     version must drop the same entries; in bf16 #3, #4 and #5 run on their
     wgmma kernels (checked by the route counters) and two calls give
     bitwise equal outputs and partials, in f32 on their CUDA-core kernels
     (timed at 1,536 rows). The vocab top-k (#10) at the caption server's 80
     rows, the MSRVTT eval's 160 and a ragged 35 whose top three tie in
     every row: bf16 on its tensor-core tile kernel (two calls bitwise
     equal), f32 on its CUDA-core one (each call's route checked by the
     counters), timed at 80 and 160. The
     LayerNorm (#6), forward and backward, at the caption step's rows
     (2,048 and 3,584 x 768, 1,536 x 1,024 in f32) and a ragged 300; two
     backward calls must give bitwise equal dx, dscale and dbias. The
     classifier transform inside the vocab top-k kernel (#10t) at the decode
     step's 80 rows and a ragged 37, on #10's two routes, beside the unfused
     chain; the causal
     branch of the eval attention (#1c) at [16, 12, 48, 64] and [80, 12, 48,
     64] against SDPA with one combined mask, on #1's two routes; the row
     gather (#8) on the six decode caches and an int32 array, bitwise,
     against index_select. No path of the port runs #1c or #8 (none of the
     JAX package does): they are held here and launch 0 times on the main
     paths;
  4. the retrieval slice: the port's server (univl_tpu_torch.cli.serve) in
     --mode retrieval at the full width of UniVLConfig.base, with random
     weights from a seed, answers add, search (with cross-encoder rerank) and
     save over HTTP, its index on CUDA graphs (an add batch, a query batch
     and a rerank tile each one replay). The kernel's launch count (replays
     counted) must match the traffic, and the card's bf16 video embeddings
     must agree with the port's f32 CPU run of the same weights. The first
     requests' times are smoke readings;
  5. a sustained window of the same traffic: the index grows to YouCook2
     val's 3,328 clips in adds of 64, then takes 100 searches; add rate over
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
  8. the same server with --fused_cls (the classifier transform inside the
     vocab kernel, #10t, once a decode step in place of #10): launches,
     captions, a window, and one profiled request's device time and launches
     a decode step against phase 7's; then the unfused path: a server with
     --no-fused_decode --no-fused_vocab, in which the reorder kernel runs once
     per step, in --mode both: after its caption requests it answers an add
     and a search with rerank, #1 as the traffic implies, the index's graphs
     in a memory pool apart from the decoder's;
  9. agreement with the CPU: a teacher-forced 47-step trajectory through the
     KV-cache decoder on the card in bf16 against the CPU in f32 (max |dlogp|
     under a stated limit), with and without --fused_cls, and the top-beam
     captions of 8 clips on the card in f32 against the CPU, with and without
     --fused_cls;
 I1. (after C1) VideoRetrievalIndex on its CUDA-graph route against
     graph=False, phase 4's configuration: in deterministic mode the stores
     and every search's ids and scores (rerank 0 and 16) bitwise equal after
     the first requests (the eager first uses and 3 captures) and the second
     (replays only), the kernels by name of a replayed add and search those
     of an eager one (fills and copies left out), #1 as the batches imply,
     and after every parameter's storage moved the reused graphs bitwise a
     fresh index; in the default mode I1_PAIRS alternating pairs of an add
     of 64 clips and a search, busy shares, launches, peak memory;
 10. the FT-Joint training slice: univl_tpu_torch.cli.task_retrieval
     --do_train at the full width of UniVLConfig.base (text 12, visual 6
     layers), bf16, batch 32, 20 steps on YouCook2-format fixtures, on the
     CLIs' graph route (one train_steps call a step, a replay from the
     second; step_route "graph" in metrics.jsonl): the loss at each display
     point, the steady clips/s, peak device memory, #2's launches counted by
     replay (#2's tensor-core kernels, 18 forward and 18 backward a step)
     and a pytorch_model.bin.0 that loads back;
 11. (cut: its eager step's profile; L1 profiles both routes)
 12. training agreement with the CPU at full width and text 2 + visual 1
     layers, dropout 0: card f32 (kernels) against CPU f32 (plain versions)
     for the loss, every gradient and the parameters after 2 BertAdam steps;
     card bf16 against CPU f32 losses over 3 steps (cut from 10, then 5);
 13. the FT-Align training slice: the same CLI with --train_sim_after_cross
     --fused_ffn block (text 12, visual 6, cross 2 layers; 1,024 text-video
     pairs of 96 tokens through the cross tower a step) on the same fixtures,
     20 steps: losses, steady clips/s, peak memory, launches (#2, #4 and #5
     20 forward and 20 backward a step; #3 and #4 on their wgmma kernels, the
     CUDA-core ones never) and a pytorch_model.bin.0 that loads back, on the
     graph route (its profiles against the unfused route were cut for L1);
 14. a short --fused_ffn pallas run (5 steps): #3 20 + 20 a step;
 15. FT-Align agreement with the CPU at full width, text 2 + visual 1 +
     cross 1 layers, batch 8 (64 pairs), dropout 0, on the block and pallas
     routes, with the limits of phase 12;
 16. the caption fine-tuning slice: univl_tpu_torch.cli.task_caption
     --do_train --fused_ln at the full width of UniVLConfig.base (text 12,
     visual 6, cross 2, decoder 3 layers), bf16, batch 16, 128 words, 96
     frames, 20 steps on YouCook2-format fixtures with transcripts: losses,
     steady clips/s, peak memory, launches (#6 in every LayerNorm, #2's
     tensor-core kernels in every attention over keys, 23 forward and 23
     backward a step, the tiled backward never) and a pytorch_model.bin.0
     that loads back, on the graph route; then --do_eval --fused_decode --fused_vocab of that
     file over 32 val clips (beam 5: captions and BLEU, METEOR, ROUGE-L,
     CIDEr), and once more with --fused_cls;
 17. (cut: its eager profiles; L1 profiles both routes)
 18. caption agreement with the CPU at full width, text 2 + visual 1 +
     cross 1 + decoder 1 layers, batch 4, dropout 0: card f32 without
     --fused_ln (the control) and with it, card bf16 over 3 steps, with the
     limits of phase 12 and the control's;
 K1. Trainer.train_steps (K optimizer steps a call, each step after a
     shape's first a replay of one step captured as a CUDA graph) at
     bf16, UniVLConfig.base, seeded weights, dropout 0.1, under
     torch.use_deterministic_algorithms: FT-Joint at bench.py's batch 32,
     48 words, 48 frames, K = 5 (FT-Align and caption at K = 3, and the
     windows, cut for L1). Two
     calls (the first runs its first step eagerly and captures; the second
     only replays) bitwise K train_step calls each from the same weights:
     every step's metrics, every parameter, both moments, the step count;
     the wrappers' counts by replay; clips/s of the second call against the
     last K train_step calls, a profiled call and one profiled
     train_step call (device busy share and kernel launches a step,
     replayed and eager; #2's, #4's and #5's kernels by name as many a step
     in both) and each route's peak device memory;
 19. MSRVTT caption eval: univl_tpu_torch.cli.task_caption --do_eval
     --fused_decode --fused_vocab --fused_cls --datatype msrvtt (the eval's
     fused kernels are off unless given) at full width, seeded weights, over 64
     fixture clips with 20 references each (the caption test layout):
     captions, BLEU/METEOR/ROUGE-L/CIDEr, #10t once a decode step;
 20. MSRVTT retrieval eval: univl_tpu_torch.cli.task_retrieval --do_eval
     --datatype msrvtt over 1,000 fixture clips (the JSFusion test size), 48
     words, 48 frames, batch 64: joint (encode clips/s, R@1/5/10, MedR,
     MeanR), then --train_sim_after_cross (the device-resident rescoring of
     all 1,000,000 pairs: pairs/s, #1's launches, peak memory), the
     evaluator on its CUDA graphs (#1 counted by replay);
 21. torch.profiler over the eval's encode of 64 clips and the rescoring of
     their 4,096 pairs, replayed (device busy share, kernel time by group);
 22. retrieval eval agreement: card f32 against CPU f32 at full width, text 2
     + visual 1 + cross 1 layers, 32 clips (cut from 64), both modes: the similarity
     matrices within stated limits and the metrics equal;
 I2. RetrievalEvaluator on its CUDA graphs against graph=False at full
     width (FT-Align's seeded weights, bf16) over 256 of phase 20's clips, in
     deterministic mode: the joint matrix, the device-resident rescoring and
     the host tiles' bitwise, three graphs captured once (the encode of a
     batch, a stripe against every video block, a tile), #1 counted by
     replay as graph=False launches it; then 2 alternating pairs of the
     encode (clips/s) and the rescoring (pairs/s) on both routes;
 P1. HowTo100M pretraining stage I: univl_tpu_torch.cli.pretrain --do_pretrain
     --sampled_use_mil --n_pair 3 at the full width of UniVLConfig.base (text
     12 + visual 6 layers), bf16, 48 words, 64 frames, 120 clips x 3 pairs =
     360 rows a micro-step (the micro-batch JAX's finalize_args gives one
     device), accumulation 2, 4 steps over 2 epochs of HowTo100M-format
     fixtures: the losses, steady clips/s, peak memory, #2 18 + 18 a
     micro-step on its tensor-core kernels, a pytorch_model.bin.1 that loads;
 P2. stage II from that file (--stage_two --pretrain_enhance_vmodal
     --fused_ffn block; cross 2 + decoder 3 layers more), 16 clips x 3 = 48
     rows a micro-step (2,304 pairs through the cross tower), accumulation
     4, 4 steps: all five losses, clips/s, peak memory, the launches of #2,
     #4 and #5 derived from the layer counts, a .bin with both heads (its
     eager profile cut: L1 profiles stage II on both routes); P1 and P2 on
     the graph route;
 P3. resume on the card, under torch.use_deterministic_algorithms: one
     uninterrupted stage-I run (the control) and one run preempted
     (--inject_preempt_after) and resumed (--load_checkpoint) with
     --async_checkpointing (R3): the parameters, moments, BertAdam's step
     count and losses of the resumed run bitwise the control's; all three
     on the graph route, each starting with one eager step;
 P4. stage II agreement with the CPU at full width, text 2 + visual 1 +
     cross 1 + decoder 1 layers, 4 clips x 3 pairs, dropout 0: card f32 (the
     unfused route as the control, then --fused_ffn block) and card bf16
     against CPU f32, with the limits of phases 12 and 15.
 R1. remat: P2's stage-II micro-step (16 clips x 3 pairs, --fused_ffn block)
     and phase 13's FT-Align step (batch 32), each without remat, with
     remat=True and with "dots" from one init and the same batches: 2 steps
     at dropout 0.1 under torch.use_deterministic_algorithms, their losses
     and the parameters after them bitwise equal across the three, the
     launches of #2, #4 and #5 those the layer counts imply (each
     rematerialized layer's forward kernels twice); then peak device memory,
     wall clips/s over 3 more steps (cut from 5) and device busy ms a step (torch.profiler
     over 2 more);
 K2. Trainer.train_steps on the one-card routes K1 left out, from R1's
     seeded weights and datasets, in deterministic mode: FT-Align
     --fused_ffn block with --remat and with --remat_policy dots (K = 2),
     pretraining stage I at P1's 120 clips x 3 pairs and accumulation 2 (K
     = 2), stage II at P2's 16 clips x 3 and accumulation 2 (P2's 4 cut
     for I1 and E1's fan-outs) with --remat (K = 2; without it cut for L1):
     two calls
     bitwise 2K train_step calls (metrics,
     parameters, moments, the step count), the wrappers' counts (the eager
     step and the capture), a profiled call against one profiled train_step
     call (busy share, launches; #2's, #4's and #5's kernels by name as
     many a step in both), clips/s and peak memory of both (stage II's
     windows cut for L1); then in the default mode FT-Align
     block (K = 2; stage II's cut for L1), one call against two train_step
     loops, within the limits stated at K2_CONTROL_FACTOR. Its ZeRO-1 route
     runs in D3;
 R2. the input pipeline: FT-Joint (phase 10's config) through
     cli.common.make_input_iter, a train_steps call of K = 1 a step as the
     CLIs step (the prefetch feeding the graph's replays): the prefetch and
     --no_prefetch give bitwise
     equal losses over 10 steps in deterministic mode; --transfer_dtype
     bfloat16 losses within a stated limit of the f32 transfer's (its timed
     windows cut for L1); the joint retrieval
     eval of phase 20 (its batches prefetched) against --no_prefetch: the
     same R@1/5/10, MedR and MeanR;
 L1. (after K2) the CLIs' epoch loop on its graph route against
     graph=False, in deterministic mode: FT-Joint, FT-Align block (with an
     eval after its epoch over 32 clips), caption --fused_ln and
     pretraining stage II (accumulation 2), each one epoch through its CLI,
     every step displayed, against a graph=False twin of the run's trainer
     stepping the same batches: displayed metrics, the .bin, parameters,
     both moments and the step count bitwise, one capture, launches by
     replay a step's on both, #2's, #4's and #5's kernels by name as many a
     replayed step as an eager one with both routes' busy share; then
     alternating pairs of CLI windows (run_train_epochs ended by
     --inject_crash_after), clips/s of both routes and the host's ms a
     train_steps call;
 X1. task_retrieval --do_train --profile_dir over L1's FT-Joint epoch (8
     steps, deterministic mode, the graph route): its displayed metrics and
     .bin bitwise L1's, one Chrome trace (rank0.<ms>.pt.trace.json) with a
     range for each of global steps 2-6 alone, every kernel launched in
     them (each event read by its launch's host time), #2's tensor-core
     kernels 18 + 18 + 18 in each; the file's size, the
     export's seconds, the steps' wall ms and the device-busy share read
     from the trace;
 R3. (in P3) the seconds the loop blocked at each epoch-end save,
     synchronous (the control) and async (the resumed run);
 R4. the checkpoint converter without JAX: a full-width reference .bin from
     seeded weights (every module: stage II with the heads) through
     univl_tpu_torch.cli.convert_checkpoint to a flax params file and back
     with --export_torch: bitwise equal, with the times;
 D1. data parallelism: FT-Align (--fused_ffn block) through task_retrieval
     --n_gpu 2 --dist_backend gloo, two ranks spawned by the CLI sharing the
     card, under torch.use_deterministic_algorithms (set here, inherited by
     the ranks), from phase 14's weights (one .bin, --init_model: no seeded
     draw in each rank; D3 and T1 too), global batch 32, 4 steps,
     replicated and --zero1:
     each rank's launches of #2, #4 and #5 (a one-process step's counts;
     summed into the kernels line) and peak memory, clips/s (not a scaling
     number); each against one process with --gradient_accumulation_steps 2
     over the same steps: bitwise replicated, within 1e-6 of each tensor's
     norm with --zero1;
 T1. tensor parallelism: FT-Align through task_retrieval --n_gpu 4
     --tensor_parallel 2 --sequence_parallel --zero1 --dist_backend gloo
     (dp 2 x tp 2, four ranks on the card), deterministic as D1, D1's batch,
     steps and weights, against D1's one-process accumulated run: the
     losses, each parameter within a share of its own movement, each rank's
     launches of #2 (on its heads) and of the split #4 and #5 pieces, its
     peak memory, clips/s (not a scaling number);
 T2. caption fine-tuning (--stage_two --fused_ln, f32) at --n_gpu 2
     --tensor_parallel 2 from phase 16's weights, 2 steps of 4 clips,
     against one process: the decoder's split layers, the vocab-parallel
     lookup, logits and cross entropy on the card;
 D2. pretraining stage I on two ranks with --zero1 (60 clips x 3 pairs a
     rank) from P1's weights, deterministic as D1, preempted after 2 steps
     and resumed without --zero1: within 1e-6 of the uninterrupted run (one
     process accumulating the ranks' two micro-batches: one spawn fewer);
 D3. --n_gpu 1 --zero1 in a process group of one rank on NCCL: FT-Align
     through the CLI for 2 steps (the graph route: one rank on NCCL is
     captured), then probes/zero1_ab at FT-Align's
     parameters: ZeRO-1 against BertAdam, each update's profiled device ms
     (2 updates, cut from 3), both optimizers' state bytes; then K2's ZeRO-1
     route: FT-Align block --zero1 in a new one-rank NCCL group, train_steps
     (K = 2) bitwise 2K train_step calls in deterministic mode, the shard's
     moments and f32 master included, profiled as K2's other routes.
 G1. GPipe (parallel/pp.py) over the text tower at full width (12 layers),
     batch 32 x 48, pp 2 with 4 microbatches, on two gloo ranks sharing the
     card (one spawn of parallel/pp_replay, deterministic mode, the seeded
     FT-Align weights): f32 and bf16 output and every gradient against the
     sequential stack in this process; dropout 0.1 bitwise over two runs; a
     rank's launches (#2, #4 and #5 24 + 24 a step), parameter bytes (half
     the stack's), peak memory and step time against the sequential one;
 E1. in the same spawn, RetrievalEvaluator(mesh=) over the two ranks: the
     joint and FT-Align evaluation of 256 MSRVTT-format clips against one
     process on the same clips and weights (similarity matrices, metrics,
     #1's launches a rank); VideoRetrievalIndex(mesh=) (128 clips in adds
     of 16, 8 a rank, searches with rerank 0 and 16) and CaptionGenerator(
     mesh=) (a 16-clip request, 8 a rank, the fused path) on their CUDA
     graphs, against one process that runs 8 rows a call: the store, the
     searches, the tokens and the scores bitwise, each rank's steps its
     half's, the launches (replays counted) as the traffic implies;
 N1. the native tokenizer, built by the machine's g++ (its version printed
     after the kernels' build): active, the same ids as the Python path on
     every fixture caption and transcript and on Unicode strings (the count
     the C++ path declines), tokens/s of both paths.
Phase 3 also runs #2 at pretraining's [360, 64], [2304, 112] and q 48 / kv
112, and #4 and #5 at its 258,048 cross rows, in bf16; and T1's
tensor-parallel shapes: #2 on 6 of 12 heads (head0 6) at [256, 96] and [16,
48], bf16 and f32, bitwise the whole call's heads; #4 and #5 cut at the
row-parallel product at 24,576 rows with F / 2 and K / 2, each piece against
its plain version and timed, the two ranks' halves summed within 2 bf16 ulps
of the unsplit kernels, rank 1's 12,288 rows under sequence parallelism
bitwise the call's.
After the main paths: every bf16 #1 call the model made on the card (each
recorded by its shape) must have taken the tensor cores, and the one with
the most keys (the caption eval's cross tower, 224) is timed as in phase 3;
every #10 and #10t call of the beam search (each recorded by its rows,
dtype and the counter it moved) must have taken its dtype's kernel, bf16
the tensor-core one at the server's 80 rows and the evals' 160. Then one
JSON line describing the kernels (the CUDA-core kernels of #1, #2, #3-#5
and #10 with their launches from the f32 runs of phases 9 and 22, and of
12, 15 and 18, the only paths that take them), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The CLIs and servers run in this process take their seeded weights from one
numpy draw for each parameter layout, and the bytecode this process compiles
is kept under build/pycache for the ranks it spawns.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import os

# P3 runs under torch.use_deterministic_algorithms, which needs cuBLAS's
# fixed workspace (the size PyTorch gives Hopper by default), set before the
# first cuBLAS handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import contextlib
import copy
import importlib.util
import json
import logging
import math
import pickle
import py_compile
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from univl_tpu_torch import UniVLConfig, WordPieceTokenizer
from univl_tpu_torch.checkpoint.convert import (
    init_state_dict,
    load_reference_bin,
    reference_state_dict,
)
from univl_tpu_torch.checkpoint.io import restore_checkpoint
from univl_tpu_torch.cli import common as cli_common
from univl_tpu_torch.cli import convert_checkpoint, pretrain, task_caption, task_retrieval
from univl_tpu_torch.cli.serve import main as serve_main
from univl_tpu_torch.data import fixtures
from univl_tpu_torch.data import native
from univl_tpu_torch.data.batching import Batcher, collate
from univl_tpu_torch.data.howto100m import HowTo100MPretrainDataset
from univl_tpu_torch.data.msrvtt import MsrvttRetrievalEvalDataset
from univl_tpu_torch.data.text_encoding import encode_text, pad_video
from univl_tpu_torch.data.youcook import YoucookCaptionDataset, YoucookRetrievalDataset
from univl_tpu_torch.evals import beam as beam_search
from univl_tpu_torch.evals.beam import CaptionGenerator
from univl_tpu_torch.evals.fast_decoder import FastDecoder, encoder_bias
from univl_tpu_torch.evals.metrics import compute_retrieval_metrics
from univl_tpu_torch.evals.retrieval import RetrievalEvaluator
from univl_tpu_torch.kernels import _build
from univl_tpu_torch.kernels import attention as attn
from univl_tpu_torch.kernels import decode_attention as dattn
from univl_tpu_torch.kernels import ffn as ffn_k
from univl_tpu_torch.kernels import layernorm as ln_k
from univl_tpu_torch.kernels import philox
from univl_tpu_torch.kernels import reorder
from univl_tpu_torch.kernels import train_attention as ta
from univl_tpu_torch.kernels import vocab_topk
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn import layers as nn_layers
from univl_tpu_torch.nn.layers import (
    LayerNormTF,
    Randomness,
    TransformerLayer,
    TransformerStack,
    gelu_erf,
    set_fused_layer_norm,
)
from univl_tpu_torch.parallel import mesh as dp_mesh
from univl_tpu_torch.parallel import pp_replay
from univl_tpu_torch.probes import zero1_ab
from univl_tpu_torch.serving.captioning import CaptionService
from univl_tpu_torch.serving.index import RERANK_TILE, VideoRetrievalIndex
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer
from univl_tpu_torch.train.zero1 import Zero1BertAdam, make_univl_zero1_optimizer
from univl_tpu_torch.utils.graphs import LaunchCounts
from univl_tpu_torch.utils.profiling import STEP_RANGE

# retrieval traffic
N_CLIPS, N_QUERIES, TOP_K, RERANK, BATCH = 64, 8, 5, 16, 16
N_FILES = 512  # distinct clip files; the sustained window cycles through them
# YouCook2 val's clip count; the searches cut from 200 to 100 for K1
SUSTAINED_INDEX, SUSTAINED_SEARCHES = 3328, 50  # 200 -> 100 for K1, -> 50 for C1
# caption traffic: requests of BATCH clips, beam BEAM, max_len = max_words
BEAM, MAX_WORDS, DECODER_LAYERS = 5, 48, 3
CAPTION_WINDOW, UNFUSED_WINDOW, CONCURRENT = 10, 3, 16  # cut from 20, 10 for K1; 5 -> 3 for C1
# #1: a tower; the cross tower; the server's rerank; FT-Align eval rescoring
# (8 texts x 64 videos a block). bf16 takes the tensor-core kernel, f32 the
# CUDA-core one; the bf16 shape with the most keys that the model launched
# (the caption eval's cross tower) is read from the recorded calls after the
# main paths and timed then.
ATTN_SHAPES = [(16, 12, 48, 64), (16, 12, 96, 64), (128, 12, 96, 64), (512, 12, 96, 64)]
TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
VOCAB_ATOL = 1e-4  # logp: f32 sums of the same products in another order
# #10's rows: the caption server's beam rows (16 clips x beam 5) and the
# MSRVTT eval's (32 x 5), timed; a ragged count, with vocab rows VOCAB_TIE
# tied at the top of every row
VOCAB_TIMED_ROWS, VOCAB_TIE = (BATCH * BEAM, 32 * BEAM), (10, 20, 300)
VOCAB_ROWS = (*VOCAB_TIMED_ROWS, 35)
DLOGP_LIMIT = 0.25  # card bf16 vs CPU f32 over the trajectory, stated before the first run
SAME_CAPTIONS_MIN = 4  # of 8 clips, card f32 vs CPU f32
# #10t, stated before the first run. f32: the same f32 math in another order
# (erff against torch.erf): logp within VOCAB_ATOL. bf16: the transform's one
# rounding to bf16 lands on the other side of a rounding boundary for a few of
# a row's 768 values, each moving a logit by |w| x one bf16 ulp: within 5e-3
VOCAB_T_TOL = {"float32": VOCAB_ATOL, "bfloat16": 5e-3}
VOCAB_T_ROWS = (BATCH * BEAM, 37)  # the decode step's beam rows, and a ragged count
# #1c: the tower batch's and the decode batch's [B, H, L, D]; the #1 limits
CAUSAL_SHAPES = [(16, 12, 48, 64), (BATCH * BEAM, 12, 48, 64)]
# training attention (#2): heads, head dim; (batch, length) of the FT-Joint
# towers (32 x 48) and of FT-Align's cross tower (1,024 pairs x 96 tokens).
# The dropout masks are checked at the first (a one-hot V needs L <= D) and
# at a ragged 40 (the tensor-core kernels' 64-row tiles and 16-key chunks cut).
TA_HEADS, TA_D, TA_RATE, TA_SEED = 12, 64, 0.1, 1234
TA_SHAPES = [(32, 48), (1024, 96)]
TA_B, TA_L = TA_SHAPES[0]
TA_RAGGED_L = 40
# f32: the same math summed in another order; bf16: a probability, ds or output
# that lands on the other side of a bf16 rounding moves by one bf16 ulp
TA_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
KEEP_RATE_TOL = 0.002  # dropped share over 884,736 draws: ~6 binomial standard deviations
# #2 at the caption step's lengths: (batch, Lq, Lk) of the visual tower (16 x
# 96), the text tower (16 x 128), the cross tower (16 x (128 + 96)) and the
# decoder's encoder attention (128 queries, 224 keys). Past 96 the CUDA-core
# route's backward is the tiled one (the whole-head kernel's shared memory);
# the tiled kernels' dropout masks are checked at TA_SHAPES[0], where the
# one-hot check fits.
TA_CAPTION_SHAPES = [(16, 96, 96), (16, 128, 128), (16, 224, 224), (16, 128, 224)]
# LayerNorm (#6): rows x width of the caption step's text and decoder rows
# (16 x 128), the cross tower's (16 x 224), NormalizeVideo's raw features (16
# x 96 x 1024, f32 only: the model normalizes them in f32) and a ragged count
LN_SHAPES = [(2048, 768), (3584, 768), (1536, 1024), (300, 768)]
LN_EPS = 1e-12
# Stated before the first run. f32: the same f32 math, the row's sums in
# another order and rsqrtf: atol + rtol * |ref| element by element. bf16: a
# value within an f32 rounding of a bf16 rounding boundary lands on the other
# side, one bf16 ulp of the row's scale: atol + rtol * the row's largest
# |ref|. dscale/dbias: per-block f32 partials summed in another order than
# the plain version's one sum over the rows, in both dtypes (the terms are
# f32 products of the same values): within LN_SUM_RTOL of the column's
# sum of |terms|.
LN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}  # (atol, rtol)
LN_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
LN_SUM_RTOL = 1e-5
# fused FFN kernels (#3, #4, #5): rows of FT-Align's cross tower (1,024 pairs x
# 96 tokens) and of a text or visual tower (32 x 48); H 768, F 3072
FFN_ROWS, FFN_H, FFN_F, FFN_RATE, FFN_SEED = (98304, 1536), 768, 3072, 0.1, 4321
# checked, not timed: 300 rows end in a block of 12 (the CUDA-core kernels)
# and a GEMM tile of 44, with F split 8 ways (ffn_plan; #5 unsplit); 6,000
# end in a GEMM tile of 112, unsplit, whose second 64-row half is cut at 48
FFN_RAGGED_ROWS = (300, 6000)
# f32 (CUDA cores): sums of up to 3,072 products in another order, erff
# against torch.erf: atol + rtol * |ref| element by element. bf16 (tensor
# cores): the products are summed in another order than the plain version's,
# so a bf16 rounding of an intermediate (the product, the dropped output)
# flips by an ulp, and the flip carries through the residual sum and the
# LayerNorm at the scale of the row's largest terms: atol + rtol * the row's
# largest |ref|, about two bf16 ulps of it.
FFN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
FFN_KEEP_TOL = 2e-4  # dropped share over 75,497,472 draws: ~6 binomial standard deviations
# FT-Joint training: UniVLConfig.base (text 12, visual 6 layers), batch 32,
# YouCook2-format fixtures of 80 videos x 8 clips = 640 pairs: 20 steps (cut
# from 40 to make room for R1-R4)
TRAIN_BATCH, TRAIN_VIDEOS, TRAIN_CLIPS, TRAIN_SECONDS, TRAIN_DISPLAY = 32, 80, 8, 120, 5
PALLAS_VIDEOS = 20  # the short --fused_ffn pallas run: 160 pairs, 5 steps
# every single-device phase pins --n_gpu 1 (the default, 0, takes every
# visible card), so that each stays one process on one card
TRAIN_FLAGS = ["--n_gpu", "1", "--lr", "3e-5", "--warmup_proportion", "0.1", "--coef_lr", "0.1",
               "--epochs", "1", "--batch_size", str(TRAIN_BATCH), "--max_words", "48",
               "--max_frames", "48", "--n_display", str(TRAIN_DISPLAY), "--seed", "0"]
# card vs CPU at full width, text 2 and visual 1 layers, dropout 0, stated
# before the first run: f32 (kernels, TF32 off) within the plain versions'
# rounding; bf16 loss over 3 steps (cut from 10, then 5 for the time limit)
# within LOSS_BF16_RTOL of the CPU's f32
AGREE_LOSS_RTOL, AGREE_GRAD_RTOL, AGREE_PARAM_RTOL, AGREE_BF16_STEPS = 1e-5, 1e-4, 1e-5, 3
LOSS_BF16_RTOL = 0.05
# Parameters whose gradient is zero in exact arithmetic hold rounding noise on
# both sides, so they get absolute limits: the key biases (a per-query
# constant leaves the softmax unchanged; gradient norm, and parameter
# difference after 2 steps) and, in FT-Align, similarity_dense.bias (the
# max-margin loss's gradients over the [B, B] scores sum to 0). A BertAdam
# step moves a parameter by at most lr * (1 - beta1) / eps = 3 per unit of
# gradient change, so 2 steps apart by at most 6 * AGREE_ZERO_GRAD (FT-Joint
# holds its key biases to the tighter AGREE_KEY_PARAM).
AGREE_ZERO_GRAD, AGREE_KEY_PARAM, AGREE_ZERO_PARAM = 1e-6, 1e-9, 6e-6
# FT-Align at full width, text 2 + visual 1 + cross 1 layers, batch 8 (64
# pairs), on the block and pallas routes. Every pair's score goes through the
# cross tower and the loss's gradients over the scores sum to 0, so a cross
# parameter's gradient is a difference of near-equal f32 sums: gradients
# under AGREE_GRAD_FLOOR of the largest gradient norm are held to
# AGREE_GRAD_RTOL of that floor (the CPU tests' rule).
AGREE_ALIGN_BATCH, AGREE_GRAD_FLOOR = 8, 1e-2
# BertAdam normalizes each gradient element, so a parameter whose gradient is
# small and cancelling moves by an amount as uncertain as that gradient: in
# FT-Align the gradient and parameter limits are the larger of the ones above
# and AGREE_CONTROL_FACTOR times the disagreement of the model's unfused route
# (no FFN kernel, the same card-vs-CPU comparison), the control
AGREE_CONTROL_FACTOR = 10
# caption fine-tuning: the reference's YouCook2 caption command
# (docs/REPRODUCE.md:58-74) at full width, bf16, with --fused_ln: batch 16, 128
# words, 96 frames, text 12 + visual 6 + cross 2 + decoder 3 layers, on
# fixtures of 40 videos x 8 clips = 320 clips (20 steps, cut from 40); 4 more videos (32
# clips) are the val split of a short --do_eval
CAP_BATCH, CAP_WORDS, CAP_FRAMES, CAP_VIDEOS, CAP_VAL_VIDEOS = 16, 128, 96, 40, 4
CAP_FLAGS = ["--n_gpu", "1", "--lr", "3e-5", "--warmup_proportion", "0.1", "--coef_lr", "0.1", "--epochs", "1",
             "--batch_size", str(CAP_BATCH), "--batch_size_val", "32",
             "--max_words", str(CAP_WORDS), "--max_frames", str(CAP_FRAMES),
             "--n_display", str(TRAIN_DISPLAY), "--seed", "0"]
# caption agreement, card against CPU at full width: text 2 + visual 1 + cross
# 1 + decoder 1 layers, batch 4, dropout 0, with and without --fused_ln; the
# limits of phase 12 (stated before the first run): loss within 1e-5 rel,
# every gradient within 1e-4 of its norm, parameters after 2 BertAdam steps
# within 1e-5 of theirs; the key biases (zero gradient in exact arithmetic)
# to AGREE_ZERO_GRAD and, after BertAdam's per-element normalization,
# AGREE_ZERO_PARAM; card bf16 losses over AGREE_BF16_STEPS steps within LOSS_BF16_RTOL.
# Restated after a run on the card: a zero-initialized bias is, after 2
# steps, two BertAdam updates, and BertAdam divides each gradient element by
# its own magnitude (plus 1e-6), so an element near 1e-6 passes its own
# rounding into the update whatever the tensor's norm. The route without
# --fused_ln (no #6; #2 and cuBLAS) is the control, its parameters held to
# AGREE_CAP_PARAM_RTOL; the --fused_ln route's gradients and parameters to
# the larger of the limits above and AGREE_CAP_FUSED_FACTOR times the
# control's disagreement (the two routes read alike: #6 adds at most its own
# rounding)
AGREE_CAP_BATCH, AGREE_CAP_PARAM_RTOL, AGREE_CAP_FUSED_FACTOR = 4, 1e-4, 3
# K1, stated before its first run: train_steps at K steps a call bitwise K
# train_step calls (metrics, parameters, moments, step count) over two calls,
# the first with the eager step and the capture, the second all replays.
# on FT-Joint at K1_K. FT-Align and caption (K = 3) and the alternating
# windows (K1_PAIRS 2) were cut for L1, which holds those routes through the
# CLI at K = 1
K1_K = 5
# K2, stated before its first run: train_steps on the one-card routes
# K1 left out, each bitwise 2K train_step calls in deterministic mode (every
# step's metrics, every parameter, both moments, ZeRO-1's f32 master, the step
# count): FT-Align --fused_ffn block with --remat and with --remat_policy dots
# (K2_ALIGN_K), pretraining stage I at P1's micro-step and accumulation
# (K2_PRE1_K), stage II at P2's micro-step and K2_PRE2_ACCUM without and with
# --remat (K2_PRE2_K), FT-Align
# block --zero1 on D3's one-rank NCCL group (K2_ALIGN_K); the wrappers' counts
# by replay 2K steps' (the eager step and each replay, the capture counted as
# nothing), and the kernels of #2, #4
# and #5 by name as many in a replayed step as in an eager one. In the default
# mode, FT-Align block (K2_ALIGN_K) and stage II (K2_PRE2_K), one call against
# two train_step loops: each parameter and moment within the larger of
# K2_CONTROL_FACTOR times the loops' own difference and K2_NORM_RTOL of its
# norm, every metric within K2_LOSS_RTOL. Stage II's windows (K2_PAIRS, cut
# from 2 for C1 to 1), its route without remat and its default-mode check
# were cut for L1, which holds and times stage II through the CLI;
# K2_ALIGN_K and K2_PRE1_K from 3 for the time limit
K2_ALIGN_K, K2_PRE1_K, K2_PRE2_K = 2, 2, 2
K2_PRE2_ACCUM = 2  # P2's accumulation, 4, cut for I1 and E1's fan-outs
K2_CONTROL_FACTOR, K2_NORM_RTOL, K2_LOSS_RTOL = 10, 1e-6, 1e-5
GRAPH_LR = dict(lr=3e-5, t_total=100, warmup_proportion=0.1, coef_lr=0.1)  # K1's and K2's
# L1, stated before its first run: the CLIs' epoch loop (cli/common.py:
# run_train_epochs: one Trainer.train_steps call of K = 1 an update-batch)
# on its graph route, in deterministic mode, over an epoch of part of phases
# 10, 13 and 16's fixtures and of P2's stage II (16 clips x 3 pairs a micro-step,
# accumulation L1_PRE2_ACCUM: P2's 4 cut, as K2's), against a graph=False
# twin of the run's trainer (cli.common.make_trainer over a copy of its model
# taken before the first step) stepping the same batches: every displayed
# metric, the .bin, every parameter, both moments and the step count bitwise;
# one capture; the wrappers' counts by replay a step's on both routes; #2's,
# #4's and #5's kernels by name as many in a replayed step as in an eager
# one, with each route's busy share; FT-Align's run also evaluates after its
# epoch (--do_eval over L1_VAL_VIDEOS videos: the evaluator's graphs beside
# the step's), its metrics those of the twin's weights through graph=False.
# Then alternating pairs of CLI windows (run_train_epochs over a window's
# steps, ended by --inject_crash_after), the graph route against graph=False:
# clips/s between the window's display points, medians, and the host's ms a
# train_steps call on the graph route
L1_ROUTES = {  # label -> (CLI, extra flags, window steps, display every, pairs)
    "FT-Joint": ("retrieval", [], 12, 4, 2),
    "FT-Align (--fused_ffn block)": ("retrieval", ["--train_sim_after_cross", "--fused_ffn",
                                                   "block"], 9, 3, 1),
    "caption (--stage_two --fused_ln)": ("caption", [], 9, 3, 1),
    "pretraining stage II (--fused_ffn block)": ("pretrain", [], 4, 1, 1),
}
L1_PRE2_ACCUM, L1_VAL_VIDEOS = 2, 4
# the bitwise runs' epochs: the first L1_VIDEOS of phase 10's videos (8 steps
# of 32 clips), the first L1_CAP_VIDEOS of phase 16's (8 of 16); the windows
# draw from the phases' whole datasets
L1_VIDEOS, L1_CAP_VIDEOS = 32, 16
# X1, stated before its first run: task_retrieval --do_train --profile_dir over
# L1's FT-Joint epoch (the first L1_VIDEOS of phase 10's videos: 8 update-batches
# of 32 clips, 48 words, 48 frames, bf16), in deterministic mode on the graph
# route: every displayed metric and pytorch_model.bin.0 bitwise L1's run of
# that epoch (tracing changes nothing); the launches by replay 8 steps'; one
# trace file, rank0.<ms>.pt.trace.json, that loads as JSON, with one range
# for each of JAX's traced steps (X1_STEPS) and none for another; every
# kernel of the trace within those ranges (the warmup step's discarded), each
# step's kernels by name the same as every other's, and #2's tensor-core
# kernels by name exactly a step's 18 each in every step (5 x 18 in all):
# the warmup takes CUPTI's loss at the session's start. Restated after the
# first run on the card: steps 2-4 held 5 kernels more than steps 5-6, while
# the input thread still staged the epoch's last batches, so the steps'
# kernels compared are those on #2's stream; every kernel on another stream
# within a step must be a fill (FILL in its name), and is reported. Restated
# after a run that failed the per-step rule: the trace's card timestamps drift
# from the host's (a step's last kernels showed past its range, although the
# step synchronizes at its end; read by their launches, no record was
# lost), so each device event is read into the step whose range
# holds the host call that launched it (its correlation), not by its own
# time; a kernel launched outside the ranges must be a fill off #2's stream
# (the input thread's), and is reported. Printed
# beside the card: the file's size, the export's seconds, the traced steps'
# wall ms a step and the device-busy share read from the trace.
X1_ROUTE, X1_STEPS = "FT-Joint", (2, 3, 4, 5, 6)
FILL = "FillFunctor"  # PyTorch's fill kernels, the input thread's on its own stream
# I2, stated before its first run: RetrievalEvaluator on its graph route
# against graph=False at full width (FT-Align's seeded weights, bf16) over the
# first I2_CLIPS of phase 20's clips in batches of EVAL_BATCH, in
# deterministic mode: the joint matrix, the device-resident rescoring and the
# host tiles' bitwise; three graphs (the encode, a stripe, a tile), none
# more at a second evaluation; #1 counted by replay as the eager route
# launches it; then I2_PAIRS alternating pairs of the encode (clips/s) and the
# rescoring (pairs/s), in the default mode
I2_CLIPS, I2_PAIRS = 256, 2
# evaluation on MSRVTT-format fixtures at S3D width 1024: retrieval over the
# JSFusion test split's 1,000 clips (48 words, 48 frames, batch 64; joint, then
# the device-resident FT-Align rescoring of all 1,000,000 pairs in blocks of 8
# texts x 64 videos), captioning of 64 clips with 20 references each in the
# caption test layout (beam 5, batch 32, --fused_cls). YouCook2's 3,328 val
# clips would give 11 M pairs: minutes of forward passes, so the cut.
EVAL_CLIPS, EVAL_CAP_CLIPS, EVAL_REFS, EVAL_BATCH = 1000, 64, 20, 64
# card f32 against CPU f32 at full width on EVAL_AGREE_CLIPS clips, text 2 +
# visual 1 + cross 1 layers (stated before the first run): the similarity
# matrices within the limits below (joint: f32 cosines of the same pooled
# outputs; cross: f32 scores of the cross tower through #1 against its plain
# version), and the metrics equal; 32 clips (cut from 64 for the time limit:
# the CPU's cross matrix is most of the phase)
EVAL_AGREE_CLIPS, EVAL_AGREE_ATOL = 32, {"joint": 1e-5, "cross": 1e-4}
# HowTo100M pretraining, the reference's recipe (docs/REPRODUCE.md:107-137) at the
# full width of UniVLConfig.base, bf16: 48 words, 64 frames, --n_pair 3
# --sampled_use_mil --lr 1e-4 --coef_lr 0.1, at the micro-batch finalize_args
# gives one device, which sets every contrastive loss's negatives: stage I
# 1920 / 16 = 120 clips x 3 pairs = 360 rows (text 12 + visual 6 layers), stage
# II 960 / 60 = 16 clips x 3 = 48 rows (text 12 + visual 6 + cross 2 + decoder 3
# layers, --pretrain_enhance_vmodal --fused_ffn block). Cut: the accumulation
# (16 -> PRE1_ACCUM, 60 -> PRE2_ACCUM), the steps (2 an epoch, 2 epochs) and the
# corpus (HowTo100M's 1.2 M videos -> PRE_VIDEOS fixture videos of PRE_CLIPS
# clips over PRE_SECONDS s of S3D features; stage II reads the first
# PRE2_VIDEOS)
PRE_WORDS, PRE_FRAMES, PRE_PAIRS = 48, 64, 3
PRE1_CLIPS, PRE1_ACCUM, PRE2_CLIPS, PRE2_ACCUM = 120, 2, 16, 4
PRE_VIDEOS, PRE2_VIDEOS, PRE_CLIPS, PRE_SECONDS = 480, 128, 6, 120
PRE_FLAGS = ["--n_gpu", "1", "--n_pair", str(PRE_PAIRS), "--sampled_use_mil", "--lr", "1e-4", "--coef_lr", "0.1",
             "--warmup_proportion", "0.1", "--max_words", str(PRE_WORDS), "--max_frames",
             str(PRE_FRAMES), "--epochs", "2", "--n_display", "1", "--seed", "0",
             "--num_thread_reader", "8"]
# P3, stated before its first run: the preempted and resumed stage-I run
# differs from an uninterrupted one by no more than two uninterrupted runs differ
# from each other (bitwise where they are bitwise equal): parameters, moments,
# BertAdam's step count and the per-step losses. The default mode's controls
# differ in the embedding tables (their backward adds repeated ids' rows with
# atomics), so the runs compared go under torch.use_deterministic_algorithms,
# where two controls were bitwise equal in every run: now one control (cut
# from two, for D1-D3), and the resumed runs held to bitwise
PRE_PREEMPT_AFTER = 1
# P4, card against CPU, stated before the first run: stage II at full width,
# text 2 + visual 1 + cross 1 + decoder 1 layers, 4 clips x 3 pairs, dropout 0,
# on the --fused_ffn block route: f32 each of the five losses within
# AGREE_LOSS_RTOL, every gradient within AGREE_GRAD_RTOL of its norm, the
# parameters after 2 BertAdam steps within AGREE_PARAM_RTOL (phase 12's
# limits); the gradients that cancel (the cross tower's under the cross
# similarity's CrossEn, as FT-Align's under the max-margin loss) are held as
# phase 15 holds FT-Align: gradients under AGREE_GRAD_FLOOR of the largest norm
# to AGREE_GRAD_RTOL of that floor, and every limit at least
# AGREE_CONTROL_FACTOR times the unfused route's (--fused_ffn xla) disagreement;
# the zero-gradient parameters (key biases, similarity_dense.bias) to
# AGREE_ZERO_GRAD and AGREE_ZERO_PARAM; bf16 losses over AGREE_BF16_STEPS steps within
# LOSS_BF16_RTOL
PRE_AGREE_CLIPS = 4
# R1-R4, stated before their first run. R1: REMAT_CHECK_STEPS steps at
# dropout 0.1 in deterministic mode, the losses and the parameters after them
# bitwise equal without remat, with remat=True and with "dots" (each layer's
# randomness is keyed by where it is drawn, so the recompute draws the first
# pass's masks, and the backward runs the same kernels on the same inputs);
# then REMAT_TIMED_STEPS steps timed and REMAT_PROFILE_STEPS profiled. R2:
# INPUT_CHECK_STEPS steps bitwise equal with and without the prefetch in
# deterministic mode (the same batches, copied another way), the bf16
# transfer's losses within TRANSFER_BF16_RTOL of the f32 transfer's (the
# features rounded to bf16, about 3 significant digits, before the f32 feature
# LayerNorm of a bf16 model); each step one train_steps call of K = 1, as the
# CLIs step, so the prefetch feeds the graph's replays. Its timed
# windows (INPUT_PAIRS 1 of INPUT_WINDOW 5 steps, cut from 3 and 20) were cut
# for L1. R3: as P3's resumed run, bitwise. R4: bitwise.
REMAT_CHECK_STEPS, REMAT_TIMED_STEPS, REMAT_PROFILE_STEPS = 2, 3, 2  # timed: cut from 5
REMAT_MODES = (False, True, "dots")
REMAT_FLAGS = {False: "no remat", True: "--remat", "dots": "--remat --remat_policy dots"}
INPUT_CHECK_STEPS = 10
TRANSFER_BF16_RTOL = 2e-2
# D1-D3, data parallelism and ZeRO-1, stated before their first run. D1:
# FT-Align (--fused_ffn block) through the CLI with --n_gpu 2 --dist_backend
# gloo, two ranks on one card, global batch 32 (16 a rank), DP_STEPS steps,
# replicated and --zero1: per rank the launches of #2, #4 and #5 (the
# one-process counts a step), its peak memory; clips/s from rank 0's display
# points (two ranks sharing a card: not a scaling number). At dropout 0.1
# under torch.use_deterministic_algorithms (set in this process, inherited by
# the ranks) against one process with --gradient_accumulation_steps 2: the parameters bitwise equal replicated, within DP_PARAM_RTOL of each
# tensor's norm with --zero1 (the clips' norms summed in another order).
# The timed runs are the compared ones (deterministic, all DP_STEPS
# steps), not separate 2-step runs: two fewer spawns of two full-width ranks
# (D1, D2, D3 and T1-T2 start from a .bin an earlier phase wrote, not a
# seeded draw in each rank). D2: pretraining stage I, --n_gpu 2 --zero1, 60
# clips x 3 pairs a rank (P1's 120 a micro-step over two ranks), one epoch of
# 4 steps, deterministic as D1: preempted after DP_PREEMPT_AFTER steps, resumed
# without --zero1, against the uninterrupted run (one process accumulating
# the two ranks' micro-batches, one spawn fewer): the parameters and
# moments within DP_PARAM_RTOL of each tensor's norm, the losses within
# DP_PARAM_RTOL relative. D3: --n_gpu 1 --zero1, a process group of one rank
# on NCCL: FT-Align through the CLI (DP_CHECK_STEPS steps), then
# probes/zero1_ab at FT-Align's parameters: ZeRO-1 against BertAdam, both
# updates profiled, and both optimizers' state bytes.
# DP_STEPS cut from 6 for the time limit (gloo's host-staged steps)
DP_RANKS, DP_STEPS, DP_CHECK_STEPS, DP_PREEMPT_AFTER = 2, 4, 2, 2
DP_PARAM_RTOL = 1e-6
DP_FLAGS = ["--train_sim_after_cross", "--fused_ffn", "block", "--n_display", "1",
            "--no_preempt_checkpoint"]
# Tensor parallelism, stated before the first run. Phase 3: #2 on 6 of 12
# heads with head0 6 at the cross tower's [256 pairs, 96] and a tower's [16,
# 48] (16 clips a dp rank), bf16 and f32, forward and backward bitwise the
# whole call's heads; #4 and #5 cut at the row-parallel product at the cross
# tower's TP_ROWS rows with F / 2 and K / 2 (rank 0's and rank 1's shares):
# each piece against its plain version (FFN_TOL), the two ranks' partials
# summed and finished by the row kernel within 2 bf16 ulps of each row's
# largest |value| of the unsplit kernel's output (forward) and dx (backward),
# and the rows of rank 1 under sequence parallelism (TP_SP_ROWS from row
# TP_SP_ROWS) bitwise the same rows of the whole call; times of each piece,
# its plain version, its bound and the unsplit kernel's. T1: task_retrieval
# FT-Align (--fused_ffn block) at --n_gpu 4 --tensor_parallel 2
# --sequence_parallel --zero1 --dist_backend gloo (dp 2 x tp 2, four ranks on
# one card), deterministic mode, bf16, D1's batch and steps and D1's initial
# weights, against D1's one-process accumulated run: losses within
# TP_LOSS_RTOL relative, each parameter within TP_PARAM_RTOL of its norm (the
# key biases and similarity_dense.bias, zero gradient in exact arithmetic,
# within TP_ZERO_PARAM absolutely, above 2 x 3.2 x the run's summed learning
# rates, the most two BertAdam runs can move an element apart). Restated
# after the first run on the card (a development script): the norm missed
# for cross.pooler.dense.bias (5.6e-2 of its norm), a bias that starts at 0,
# so its norm is its few updates, and BertAdam divides each element's
# gradient by its own magnitude, so bf16 noise in a small gradient moves the
# update whatever the tensor's norm. Each parameter is now held to
# TP_MOVE_FRAC of its own movement over the run (L2, from the initial
# weights; ``tests/test_tp.py``'s self-calibrating rule, which a wrong or
# zeroed gradient fails at ~100%), the norm-relative difference reported
# beside it, the zero-gradient ones as before; per rank the
# launches of #2 and of the split #4 and #5 pieces, DP_STEPS times the
# one-process counts of a step (the unsplit #4, #5 and every f32 kernel 0).
# T2: task_caption --stage_two --fused_ln at --n_gpu 2 --tensor_parallel 2,
# f32, T2_BATCH clips a step over T2_CLIPS clips (2 steps), from phase 16's
# weights, deterministic mode, against one process: losses within T2_RTOL
# relative, each parameter within T2_RTOL of its norm (the zero-gradient key
# biases within AGREE_ZERO_PARAM absolutely).
TP_RANKS, TP_SIZE, TP_ROWS, TP_SP_ROWS = 4, 2, 24576, 12288
TP_TA_SHAPES, TP_HEADS = [(256, 96), (16, 48)], 6
TP_LOSS_RTOL, TP_MOVE_FRAC, TP_ZERO_PARAM = 2e-2, 0.1, 6e-4
TP_FLAGS = ["--n_gpu", str(TP_RANKS), "--tensor_parallel", str(TP_SIZE), "--sequence_parallel",
            "--zero1", "--dist_backend", "gloo"]
T2_CLIPS, T2_BATCH, T2_WORDS, T2_FRAMES, T2_RTOL = 8, 4, 48, 48, 1e-5
# G1, E1 and N1, stated before their first run (PERF.md, PR 15). G1: GPipe
# (parallel/pp.py) over UniVLConfig.base's text tower at full width (12
# layers, hidden 768, 12 heads, F 3072), bf16 over f32 parameters on the
# block route (#2, #4, #5), PP_BATCH rows of PP_WORDS words with an all-valid
# key mask (JAX's primitive carries h alone), pp PP_STAGES (6 layers a stage)
# with PP_MICRO microbatches, on two gloo ranks sharing the card
# (parallel/pp_replay.py, deterministic mode), from the seeded FT-Align
# .bin's text layers; against one process running the sequential
# TransformerStack on the same weights and rows at dropout 0, each rank
# taking the loss mean(y * probe) from its delivered copy: the output and
# every parameter's gradient within PP_RTOL of its norm (f32: the CUDA-core
# kernels; bf16: the tensor-core ones, where a microbatch's products may
# round to bf16 otherwise than the whole batch's: on the CPU at these
# shapes 1.1e-2 of the output's norm and 1.9e-2 of a gradient's), the key
# biases (zero gradient in exact arithmetic) within PP_RTOL of their layer's
# query bias's gradient norm; at dropout 0.1 two runs bitwise equal; a rank's launches a step #2, #4 and #5 PP_MICRO x 6
# forward and as many backward; its parameter bytes half the stack's. E1:
# RetrievalEvaluator(mesh=) over the same two ranks: FT-Align's joint and
# cross evaluation of E1_CLIPS MSRVTT-format clips (batch E1_BATCH, 48 words,
# 48 frames, bf16) against one process on the same clips and weights that
# encodes E1_BATCH / 2 clips a call, as a rank does: the similarity matrices
# within E1_ATOL, the metrics equal, #1's launches a rank the passes' count.
# N1: the tokenizer's native path built by the card machine's g++ and
# active; the ids of every YouCook2 and MSRVTT fixture caption and
# transcript and of N1_UNICODE equal to the Python path's, the C++ path
# declining exactly N1_DECLINED of them (each then takes the Python path);
# tokens/s of both paths.
PP_STAGES, PP_MICRO, PP_BATCH, PP_WORDS, PP_TIMED = 2, 4, 32, 48, 3
PP_RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
E1_CLIPS, E1_BATCH, E1_ATOL = 256, 64, {"joint": 1e-5, "cross": 1e-4}
# E1's index fan-out: adds of BATCH clips, BATCH / 2 a rank, then the
# server's searches; its caption fan-out: one BATCH-clip request
E1_INDEX_CLIPS = 128
N1_UNICODE = ["café olé", "添加洋葱 then stir", "naïve mix", "ÜBER Äpfel", "İstanbul",
              "ЖИЗНЬ хорошо", "crème brûlée!", "ñoño 한국어", "ＦＵＬＬＷＩＤＴＨ text",
              "[SEP] café [UNK]", "em—dash and … ellipsis", "«guillemets»",
              # declined by the C++ path: the context-sensitive sigma, a codepoint
              # past the tables, a lone surrogate, an embedded NUL
              "ΣΟΦΟΣ σοφος", "beyond \U00030001 table", "lone \ud800 surrogate", "add\x00salt"]
N1_DECLINED = 4
SLOW_CALL_MS = 2.0  # cuda_time_ms: a reference call this slow is timed over 2 x 2 calls
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, nominal
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor cores bf16; CUDA cores f32
QUERIES = ["stir the soup", "slice the onion", "heat oil in a pan", "add salt and pepper",
           "boil the pasta", "mix flour and water", "fry the chicken", "serve the rice"]
KERNELS = {  # name -> (wrapper with the launch count, source, the TPU kernel it replaces)
    "eval_attention": (attn.fused_attention_masked, "univl_tpu_torch/csrc/attention.cu",
                       "univl_tpu/kernels/attention.py:65"),
    "eval_attention_cuda_cores": ((attn.fused_attention_masked, "cuda_core_launches"),
                                  "univl_tpu_torch/csrc/attention.cu",
                                  "univl_tpu/kernels/attention.py:65"),
    "eval_attention_causal": ((attn.fused_attention_masked, "causal_launches"),
                              "univl_tpu_torch/csrc/attention.cu",
                              "univl_tpu/kernels/attention.py:47"),
    "eval_attention_causal_cuda_cores": ((attn.fused_attention_masked,
                                          "cuda_core_causal_launches"),
                                         "univl_tpu_torch/csrc/attention.cu",
                                         "univl_tpu/kernels/attention.py:47"),
    "beam_reorder_groups": (reorder.beam_reorder_groups_inplace,
                            "univl_tpu_torch/csrc/reorder.cu", "univl_tpu/kernels/reorder.py:28"),
    "reorder_rows": (reorder.beam_reorder_rows, "univl_tpu_torch/csrc/reorder.cu",
                     "univl_tpu/kernels/reorder.py:130"),
    "beam_decode_self_attention": (dattn.beam_decode_self_attention,
                                   "univl_tpu_torch/csrc/decode_attention.cu",
                                   "univl_tpu/kernels/decode_attention.py:77"),
    "vocab_topk": (vocab_topk.classify_topk, "univl_tpu_torch/csrc/vocab_topk.cu",
                   "univl_tpu/kernels/vocab_topk.py:62"),
    "vocab_topk_transform": ((vocab_topk.classify_topk, "transform_launches"),
                             "univl_tpu_torch/csrc/vocab_topk.cu",
                             "univl_tpu/kernels/vocab_topk.py:106"),
    "vocab_topk_cuda_cores": ((vocab_topk.classify_topk, "cuda_core_launches"),
                              "univl_tpu_torch/csrc/vocab_topk.cu",
                              "univl_tpu/kernels/vocab_topk.py:62"),
    "vocab_topk_transform_cuda_cores": ((vocab_topk.classify_topk,
                                         "cuda_core_transform_launches"),
                                        "univl_tpu_torch/csrc/vocab_topk.cu",
                                        "univl_tpu/kernels/vocab_topk.py:106"),
    "train_attention_fwd": (ta.train_attention_fwd, "univl_tpu_torch/csrc/train_attention.cu",
                            "univl_tpu/kernels/train_attention.py:83"),
    "train_attention_bwd": (ta.train_attention_bwd, "univl_tpu_torch/csrc/train_attention.cu",
                            "univl_tpu/kernels/train_attention.py:116"),
    "train_attention_fwd_cuda_cores": ((ta.train_attention_fwd, "cuda_core_launches"),
                                       "univl_tpu_torch/csrc/train_attention.cu",
                                       "univl_tpu/kernels/train_attention.py:83"),
    "train_attention_bwd_cuda_cores": ((ta.train_attention_bwd, "cuda_core_launches"),
                                       "univl_tpu_torch/csrc/train_attention.cu",
                                       "univl_tpu/kernels/train_attention.py:116"),
    "train_attention_bwd_tiled": (ta.train_attention_bwd_tiled,
                                  "univl_tpu_torch/csrc/train_attention.cu",
                                  "univl_tpu/kernels/train_attention.py:116"),
    "ffn_fwd": (ffn_k.ffn_fwd, "univl_tpu_torch/csrc/ffn.cu", "univl_tpu/kernels/ffn.py:100"),
    "ffn_bwd": (ffn_k.ffn_bwd, "univl_tpu_torch/csrc/ffn.cu", "univl_tpu/kernels/ffn.py:111"),
    "ffn_block_fwd": (ffn_k.ffn_block_fwd, "univl_tpu_torch/csrc/ffn.cu",
                      "univl_tpu/kernels/ffn.py:309"),
    "ffn_block_bwd": (ffn_k.ffn_block_bwd, "univl_tpu_torch/csrc/ffn.cu",
                      "univl_tpu/kernels/ffn.py:329"),
    "ffn_fwd_cuda_cores": ((ffn_k.ffn_fwd, "cuda_core_launches"), "univl_tpu_torch/csrc/ffn.cu",
                           "univl_tpu/kernels/ffn.py:100"),
    "ffn_bwd_cuda_cores": ((ffn_k.ffn_bwd, "cuda_core_launches"), "univl_tpu_torch/csrc/ffn.cu",
                           "univl_tpu/kernels/ffn.py:111"),
    "ffn_block_fwd_cuda_cores": ((ffn_k.ffn_block_fwd, "cuda_core_launches"),
                                 "univl_tpu_torch/csrc/ffn.cu", "univl_tpu/kernels/ffn.py:309"),
    "ffn_block_bwd_cuda_cores": ((ffn_k.ffn_block_bwd, "cuda_core_launches"),
                                 "univl_tpu_torch/csrc/ffn.cu", "univl_tpu/kernels/ffn.py:329"),
    "dense_block_fwd": (ffn_k.dense_block_fwd, "univl_tpu_torch/csrc/ffn.cu",
                        "univl_tpu/kernels/ffn.py:545"),
    "dense_block_bwd": (ffn_k.dense_block_bwd, "univl_tpu_torch/csrc/ffn.cu",
                        "univl_tpu/kernels/ffn.py:571"),
    "dense_block_fwd_cuda_cores": ((ffn_k.dense_block_fwd, "cuda_core_launches"),
                                   "univl_tpu_torch/csrc/ffn.cu", "univl_tpu/kernels/ffn.py:545"),
    "dense_block_bwd_cuda_cores": ((ffn_k.dense_block_bwd, "cuda_core_launches"),
                                   "univl_tpu_torch/csrc/ffn.cu", "univl_tpu/kernels/ffn.py:571"),
    "layernorm_fwd": (ln_k.layer_norm_fwd, "univl_tpu_torch/csrc/layernorm.cu",
                      "univl_tpu/kernels/layernorm.py:45"),
    "layernorm_bwd": (ln_k.layer_norm_bwd, "univl_tpu_torch/csrc/layernorm.cu",
                      "univl_tpu/kernels/layernorm.py:79"),
    # the split halves under tensor parallelism: #3's and #4's GEMMs over a
    # rank's F, #5's over its K, the row kernels after the reduce (#3-#5), the
    # backwards' LayerNorm head (#4, #5) and dx's rows (#3, #4)
    "ffn_split_fwd": (ffn_k.ffn_part, "univl_tpu_torch/csrc/ffn.cu",
                      "univl_tpu/kernels/ffn.py:309"),
    "dense_split_fwd": (ffn_k.dense_part, "univl_tpu_torch/csrc/ffn.cu",
                        "univl_tpu/kernels/ffn.py:545"),
    "split_rows": (ffn_k.split_rows, "univl_tpu_torch/csrc/ffn.cu",
                   "univl_tpu/kernels/ffn.py:309"),
    "split_bwd_ln": (ffn_k.block_bwd_ln, "univl_tpu_torch/csrc/ffn.cu",
                     "univl_tpu/kernels/ffn.py:329"),
    "ffn_split_bwd": (ffn_k.ffn_bwd_part, "univl_tpu_torch/csrc/ffn.cu",
                      "univl_tpu/kernels/ffn.py:329"),
    "ffn_split_bwd_rows": (ffn_k.ffn_bwd_rows, "univl_tpu_torch/csrc/ffn.cu",
                           "univl_tpu/kernels/ffn.py:329"),
    "dense_split_bwd": (ffn_k.dense_bwd_dx, "univl_tpu_torch/csrc/ffn.cu",
                        "univl_tpu/kernels/ffn.py:571"),
}
# the kernels no path of the port (nor of the JAX package) runs: held against
# their plain versions here, never launched on the main paths
NO_ROUTE = ("eval_attention_causal", "eval_attention_causal_cuda_cores", "reorder_rows")
# the CUDA-core kernels of #1, #2, #3-#5 and #10 (with #10t): the f32 route,
# which only the f32 agreement runs (phases 9 and 22 for #1; 12, 15 and 18
# for #2; 15 for #3-#5; 9 for #10 and #10t) take: 0 launches on the main
# paths, which run bf16; their launches in those runs are printed apart from
# the main paths' (``f32_agreement_launches``)
F32_ROUTE = ("eval_attention_cuda_cores", "train_attention_fwd_cuda_cores",
             "train_attention_bwd_cuda_cores", "train_attention_bwd_tiled", "ffn_fwd_cuda_cores",
             "ffn_bwd_cuda_cores", "ffn_block_fwd_cuda_cores", "ffn_block_bwd_cuda_cores",
             "dense_block_fwd_cuda_cores", "dense_block_bwd_cuda_cores", "vocab_topk_cuda_cores",
             "vocab_topk_transform_cuda_cores")
TRACE_NAMES = {"eval_attention": ("eval_attention_mma_kernel",),
               "eval_attention_cuda_cores": ("eval_attention_kernel",),
               "beam_reorder_groups": ("reorder_groups_kernel",),
               "beam_decode_self_attention": ("decode_attention_kernel",),
               # #10's merge kernel serves both routes: it is counted with bf16's
               "vocab_topk": ("vocab_tile_mma_kernel", "vocab_merge_kernel"),
               "vocab_topk_transform": ("cls_dense_gelu_kernel<__nv_bfloat16>",
                                        "cls_layernorm_kernel<__nv_bfloat16>"),
               "vocab_topk_cuda_cores": ("vocab_tile_kernel(",),
               "vocab_topk_transform_cuda_cores": ("cls_dense_gelu_kernel<float>",
                                                   "cls_layernorm_kernel<float>"),
               "reorder_rows": ("gather_rows_kernel",),
               "train_attention_fwd": ("train_attention_fwd_mma_kernel",),
               "train_attention_bwd": ("train_attention_bwd_dq_mma_kernel",
                                       "train_attention_bwd_dkdv_mma_kernel"),
               "train_attention_fwd_cuda_cores": ("train_attention_fwd_kernel",),
               "train_attention_bwd_cuda_cores": ("train_attention_bwd_kernel",),
               "train_attention_bwd_tiled": ("train_attention_bwd_dq_kernel",
                                             "train_attention_bwd_dkdv_kernel"),
               # bf16 #3 and #4: the same wgmma GEMMs and row kernels
               "ffn_fwd": ("ffn_fwd_gemm_kernel", "ffn_fwd_rows_kernel"),
               "ffn_bwd": ("ffn_bwd_gemm_kernel", "ffn_bwd_rows_kernel"),
               "ffn_block_fwd": ("ffn_fwd_gemm_kernel", "ffn_fwd_rows_kernel"),
               "ffn_block_bwd": ("ffn_bwd_ln_kernel", "ffn_bwd_gemm_kernel",
                                 "ffn_bwd_rows_kernel"),
               "ffn_fwd_cuda_cores": ("ffn_fwd_kernel",), "ffn_bwd_cuda_cores": ("ffn_bwd_kernel",),
               "ffn_block_fwd_cuda_cores": ("ffn_block_fwd_kernel",),
               "ffn_block_bwd_cuda_cores": ("ffn_block_bwd_kernel",),
               # bf16 #5: the same GEMM body and row kernels under names of its own
               "dense_block_fwd": ("dense_fwd_gemm_kernel", "dense_fwd_rows_kernel"),
               "dense_block_bwd": ("dense_bwd_ln_kernel", "dense_bwd_gemm_kernel"),
               "dense_block_fwd_cuda_cores": ("dense_block_fwd_kernel",),
               "dense_block_bwd_cuda_cores": ("dense_block_bwd_kernel",),
               "layernorm_fwd": ("layernorm_fwd_kernel",),
               "layernorm_bwd": ("layernorm_bwd_kernel", "layernorm_bwd_sum_kernel")}


# the model's #1 calls on the card by (B, H, Lq, Lk, D, dtype): nn/layers.py's
# call passes through _recorded_attention, which counts no launch itself
ATTN_CALLS = {}
_ATTN_CALLS_LOCK = threading.Lock()


def _recorded_attention(q, k, v, key_mask, causal=False):
    if q.device.type == "cuda":
        key = (*q.shape[:3], k.shape[2], q.shape[3], dtype_name(q.dtype))
        with _ATTN_CALLS_LOCK:
            ATTN_CALLS[key] = ATTN_CALLS.get(key, 0) + 1
    return attn.fused_attention_masked(q, k, v, key_mask, causal)


def check_attention_routes() -> tuple:
    """Every bf16 #1 call the model made on the card went to the tensor
    cores (by cuda_route); returns the [B, H, L, D] of the bf16 call with the
    most keys (then the largest batch)."""
    print(f"eval_attention calls of the model on the card, (B, H, Lq, Lk, D, dtype): count: "
          f"{dict(sorted(ATTN_CALLS.items()))}", flush=True)
    bf16 = [c for c in ATTN_CALLS if c[5] == "bfloat16"]
    off = [c for c in bf16 if attn.cuda_route(torch.bfloat16, c[4], c[2], c[3])
           != attn.TENSOR_CORES]
    require(bool(bf16) and not off, f"bf16 eval_attention calls off the tensor cores: {off}")
    B, H, Lq, Lk, D, _ = max(bf16, key=lambda c: (c[3], c[0]))
    require(Lq == Lk, f"the longest bf16 eval_attention call is not self-attention: {Lq}, {Lk}")
    return B, H, Lk, D


# the beam search's #10 calls on the card by (R, dtype, transform, the
# counter the call moved): _recorded_topk holds a lock around each call, so
# the counter it moved is its own
VOCAB_CALLS = {}
_VOCAB_CALLS_LOCK = threading.Lock()
_TOPK_COUNTERS = ("launches", "cuda_core_launches", "transform_launches",
                  "cuda_core_transform_launches")


def _recorded_topk(h, w, bias, k, transform=None):
    fn = vocab_topk.classify_topk
    if h.device.type != "cuda":
        return fn(h, w, bias, k, transform)
    with _VOCAB_CALLS_LOCK:
        before = [getattr(fn, c) for c in _TOPK_COUNTERS]
        out = fn(h, w, bias, k, transform)
        moved = tuple(c for c, n in zip(_TOPK_COUNTERS, before) if getattr(fn, c) != n)
        key = (h.shape[0], dtype_name(h.dtype), transform is not None, moved)
        VOCAB_CALLS[key] = VOCAB_CALLS.get(key, 0) + 1
    return out


def check_vocab_routes() -> None:
    """Every #10 and #10t call of the beam search on the card took its
    dtype's kernel (bf16: the tensor-core tile kernel), each call one launch
    of its counter; the caption server's 80 rows and the MSRVTT eval's 160
    ran in bf16."""
    print(f"vocab top-k calls of the beam search on the card, (R, dtype, transform, counter): "
          f"count: {dict(sorted(VOCAB_CALLS.items()))}", flush=True)
    off = [key for key in VOCAB_CALLS
           if key[3] != (("" if key[1] == "bfloat16" else "cuda_core_")
                         + ("transform_launches" if key[2] else "launches"),)]
    require(not off, f"vocab top-k calls off their dtype's kernel: {off}")
    bf16_rows = {key[0] for key in VOCAB_CALLS if key[1] == "bfloat16"}
    require(set(VOCAB_TIMED_ROWS) <= bf16_rows,
            f"the beam search ran bf16 vocab top-k at rows {sorted(bf16_rows)}, not at "
            f"{VOCAB_TIMED_ROWS}")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _counter(entry):
    """(wrapper, attribute) of a KERNELS entry's launch count."""
    return entry if isinstance(entry, tuple) else (entry, "launches")


# The CUDA graphs of the caption decode, the retrieval index, the retrieval
# evaluator and the training step (utils/graphs.py:GraphCapture.record,
# patched by main for the whole run through LAUNCHES): a wrapper counts at a
# capture, where nothing launches,
# and not at a replay, where its kernel runs. LAUNCHES takes each capture's
# counts off and adds them back at each replay of its graph, so that
# read_launches gives the launches on the device.
LAUNCHES = LaunchCounts()
CARD = []  # nvidia-smi's name and power limit of the card, read first


def reset_launches() -> None:
    for entry, _, _ in KERNELS.values():
        setattr(*_counter(entry), 0)
    LAUNCHES.reset()


def read_launches() -> dict:
    """Each kernel's launches on the device since reset_launches: its
    wrapper's count with the graphs counted by replay."""
    counts = LAUNCHES.launches()
    return {name: counts[_launch_key(entry)] for name, (entry, _, _) in KERNELS.items()}


def cuda_time_ms(fn, runs: int = 20, repeats: int = 3, reference: bool = False):
    """(device ms, host-paced ms) per call of fn, each the median of `repeats`.

    Device time: a sleep kernel holds the stream while the host queues `runs`
    calls, so CUDA events around them see the calls back to back on the card.
    Host-paced time: CUDA events around single calls, which also count the
    gaps while the card waits for the host to launch the next kernel. A
    ``reference`` call (a plain version, a library call or an unfused chain,
    never a hand-written kernel) that takes SLOW_CALL_MS or more alone is
    timed over at most 2 repeats of 2 calls: its device time dwarfs the
    host's launch gaps that the longer windows even out (the cut that made
    room for D1-D3, 3 x 3 until the cut for K1; repeats cut from 5 to 3 for
    K1 too)."""

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    fn()
    torch.cuda.synchronize()
    start, end = events()
    start.record()
    fn()
    end.record()
    end.synchronize()
    if reference and start.elapsed_time(end) >= SLOW_CALL_MS:
        runs, repeats = min(runs, 2), min(repeats, 2)
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


def report(name: str, shape: str, dtype, err: float, ms, plain, bound, library=None,
           before=None) -> dict:
    """Print a kernel's row (``before``: the CUDA-core kernel's times and max
    abs error on the same inputs, printed beside its own) and return the JSON
    keys."""
    b_ms, b_by = bound
    lib = f"{library[0]:.5f} ({library[1]})" if library else "none"
    was = (f" (the CUDA-core kernel on the same inputs {before[0][0]:.5f}, max_abs_err "
           f"{before[1]:.3e})" if before else "")
    print(f"{name} {shape} {dtype_name(dtype)}: max_abs_err {err:.3e}; device ms per call: "
          f"kernel {ms[0]:.5f}{was}, plain {plain[0]:.5f}, one PyTorch call {lib}; host-paced ms: "
          f"kernel {ms[1]:.5f}, plain {plain[1]:.5f}; bound {b_ms:.5f} ms by {b_by} (estimate "
          f"against nominal peaks)", flush=True)
    return {"max_abs_err": err, "ms": ms[0], "plain_ms": plain[0], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library[0] if library else None}


def _attn_inputs(B: int, H: int, L: int, D: int, dtype, seed: int):
    """Strided head-split q, k, v views of [B, L, H * D], as the model passes
    them, and a ragged f32 key mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, L, H * D, generator=g, device="cuda").to(dtype)
               .view(B, L, H, D).transpose(1, 2) for _ in range(3))
    mask = (torch.rand(B, L, generator=g, device="cuda") > 0.3).float()
    return q, k, v, mask


def _attn_err(got, want, valid, dtype) -> tuple:
    """(max abs error, largest excess over TOL) over the query rows ``valid``
    ([B, Lq]); the other rows are padding (no valid key), left out."""
    got_r, want_r = (t.float().transpose(1, 2)[valid] for t in (got, want))
    diff = (got_r - want_r).abs()
    atol, rtol = TOL[dtype_name(dtype)]
    return float(diff.max()), float((diff - atol - rtol * want_r.abs()).max())


def _eval_attention_row(args, valid, dtype, causal: bool, flops: float, sdpa_mask,
                        sdpa_what: str) -> tuple:
    """#1 (``causal``: #1c) on one set of inputs: the kernel of the dtype's
    route, checked by its counter, against the plain version within TOL, its
    device time beside the plain version's, SDPA's and the bound; in bf16 the
    CUDA-core kernel on the same inputs (uncounted) is checked and timed
    beside it. Returns (the kernels-line name, max abs error, report row)."""
    q, k, v, mask = args
    B, H, L, D = q.shape
    cores = attn.cuda_route(dtype, D, L, k.shape[2]) == attn.CUDA_CORES
    name = ("eval_attention" + ("_causal" if causal else "")
            + ("_cuda_cores" if cores else ""))
    before = read_launches()
    got = attn.fused_attention_masked(q, k, v, mask, causal=causal)
    want = attn.attention_reference(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in read_launches().items() if c != before[n]}
    require(ran == {name: 1}, f"{name} at {[B, H, L, D]} {dtype}: launched {ran}")
    err, excess = _attn_err(got, want, valid, dtype)
    require(excess <= 0.0, f"{name} disagrees with its plain version at {[B, H, L, D]} "
                           f"{dtype}: max abs err {err}")
    was = None
    if not cores:
        other = attn._launch(q, k, v, mask, causal, tensor_cores=False)
        other_err, other_excess = _attn_err(other, want, valid, dtype)
        require(other_excess <= 0.0, f"the CUDA-core kernel disagrees with the plain version "
                                     f"at {[B, H, L, D]} {dtype}: max abs err {other_err}")
        was = (cuda_time_ms(lambda: attn._launch(q, k, v, mask, causal, tensor_cores=False)),
               other_err)
    ms = cuda_time_ms(lambda: attn.fused_attention_masked(q, k, v, mask, causal=causal))
    plain = cuda_time_ms(lambda: attn.attention_reference(q, k, v, mask, causal=causal))
    sdpa = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
    n_bytes = 4 * B * H * L * D * q.element_size() + mask.numel() * 4
    return name, err, report(name, str([B, H, L, D]), dtype, err, ms, plain,
                             bound_ms(n_bytes, flops, dtype_name(dtype)), (sdpa[0], sdpa_what),
                             was)


def kernel_eval_attention(shapes=ATTN_SHAPES) -> dict:
    """#1 against its plain version on strided head-split views, as the
    model calls it, at ``shapes`` in f32 (the CUDA-core kernel) and bf16 (the
    tensor-core kernel, and the CUDA-core one beside it). Returns each
    route's row at the first shape, with the route's worst error."""
    worst, rows = {}, {}
    for B, H, L, D in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = _attn_inputs(B, H, L, D, dtype, seed=0)
            mask[0] = 0.0
            mask[0, L // 2] = 1.0  # a single valid key
            mask[1] = 0.0  # no valid key: a padding row, left out of the comparison
            valid = (mask.sum(dim=1) > 0)[:, None].expand(B, L)
            name, err, r = _eval_attention_row(
                (q, k, v, mask), valid, dtype, False, 4.0 * B * H * L * L * D,
                mask.bool()[:, None, None, :], "scaled_dot_product_attention, boolean key mask")
            worst[name] = max(worst.get(name, 0.0), err)
            rows.setdefault(name, r)
    return {n: {**r, "max_abs_err": worst[n]} for n, r in rows.items()}


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
    [80, 12, L, 64] zero beyond t, a permutation that is not the identity; the
    position a 0-d int32 tensor on the card and the caches written into out=,
    as the decoder calls it."""
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
            pos = torch.tensor(t, dtype=torch.int32, device="cuda")
            out = (torch.empty_like(kc), torch.empty_like(vc))
            args = (q, kn, vn, kc, vc, prev_k, pos, K)
            ctx, ko, vo = dattn.beam_decode_self_attention(*args, scale=scale, out=out)
            ctx_r, ko_r, vo_r = dattn.decode_attention_reference(*args, scale)
            torch.cuda.synchronize()
            require(ko is out[0] and vo is out[1] and torch.equal(ko, ko_r)
                    and torch.equal(vo, vo_r),
                    f"decode attention's caches differ from the plain version's at L={L} t={t}")
            atol, rtol = TOL[dtype_name(dtype)]
            diff = (ctx.float() - ctx_r.float()).abs()
            err = float(diff.max())
            worst = max(worst, err)
            require(float((diff - atol - rtol * ctx_r.float().abs()).max()) <= 0.0,
                    f"decode attention disagrees with its plain version at L={L} t={t} {dtype}: "
                    f"max abs err {err}")
            ms = cuda_time_ms(lambda: dattn.beam_decode_self_attention(*args, scale=scale,
                                                                       out=out))
            plain = cuda_time_ms(lambda: dattn.decode_attention_reference(*args, scale))
            es = kc.element_size()
            n_bytes = (3 * N * H * D * es + 2 * N * H * t * D * es  # q, k_new, v_new; cache < t
                       + 2 * N * H * L * D * es + N * H * D * es + 8 * N + 4)  # outs; prev_k, t
            bound = bound_ms(n_bytes, 4.0 * N * H * (t + 1) * D, dtype_name(dtype))
            r = report("beam_decode_self_attention", f"{[N, H, L, D]} t={t}", dtype, err, ms,
                       plain, bound)
            if (L, dtype) == (MAX_WORDS, torch.bfloat16):
                row = r
    return {**row, "max_abs_err": worst}


def _vocab_agrees(logp, idx, h, w, b, k: int, what: str):
    """Holds #10's (logp, idx) against the plain version: the values within
    VOCAB_ATOL, the indices wherever a value is clear of its neighbours.
    Returns the max abs error and where the indices were clear."""
    ref_v, ref_i = vocab_topk.classify_topk_reference(h, w, b, k + 1)
    torch.cuda.synchronize()
    err = float((logp - ref_v[:, :k]).abs().max())
    require(err <= VOCAB_ATOL, f"vocab top-k values differ from the plain version's by "
                               f"{err} at {what}")
    gaps = (ref_v[:, :-1] - ref_v[:, 1:]).abs()
    clear = torch.minimum(torch.cat([gaps[:, :1], gaps[:, :-1]], 1), gaps[:, :k]) > VOCAB_ATOL
    require(bool((idx[clear] == ref_i[:, :k][clear]).all()),
            f"vocab top-k indices differ from the plain version's at {what}")
    return err, clear


def kernel_vocab_topk() -> dict:
    """h [R, 768] against BERT's tied 30,522 x 768 classifier, k = 5, at the
    caption server's R = 80 (16 clips x beam 5), the MSRVTT eval's 160 (32 x
    5) and a ragged 35 whose vocab rows 10, 20 and 300 tie every row's top
    three (zero rows, equal bias: the lower index first), there also at the
    largest k, 32. bf16 takes the tensor-core tile kernel (two calls bitwise
    equal), f32 the CUDA-core one, each checked by its counter; both timed at
    80 and 160 rows."""
    Hd, V, k = 768, 30522, BEAM
    worst, rows = {"bfloat16": 0.0, "float32": 0.0}, {}
    for R in VOCAB_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(3)
            h = torch.randn(R, Hd, generator=g, device="cuda").to(dtype)
            w = (0.02 * torch.randn(V, Hd, generator=g, device="cuda")).to(dtype)
            b = 0.02 * torch.randn(V, generator=g, device="cuda")
            tied = R not in VOCAB_TIMED_ROWS
            if tied:
                w[list(VOCAB_TIE)] = 0.0
                b[list(VOCAB_TIE)] = 20.0
            wp, bp = vocab_topk.pad_vocab_inputs(w, b)
            before = read_launches()
            logp, idx = vocab_topk.classify_topk(h, wp, bp, k)
            counts = read_launches()
            route = "vocab_topk" if dtype == torch.bfloat16 else "vocab_topk_cuda_cores"
            require(all(counts[n] - before[n] == (n == route) for n in counts),
                    f"vocab top-k at R={R} {dtype_name(dtype)} did not take {route} alone")
            what = f"R={R} {dtype_name(dtype)}"
            err, clear = _vocab_agrees(logp, idx, h, w, b, k, what)
            worst[dtype_name(dtype)] = max(worst[dtype_name(dtype)], err)
            if tied:
                require(bool((idx[:, :3] == torch.tensor(VOCAB_TIE, device="cuda")).all())
                        and bool((logp[:, :3] == logp[:, :1]).all()),
                        f"vocab top-k: the tied entries are not first in index order at {what}")
                # the largest k: the merge stages 239 x 65 words of winners, past
                # the 48 KB a block takes without the opt-in
                kk = vocab_topk.MAX_K
                before = read_launches()
                big = vocab_topk.classify_topk(h, wp, bp, kk)
                counts = read_launches()
                require(all(counts[n] - before[n] == (n == route) for n in counts),
                        f"vocab top-k at R={R} k={kk} {dtype_name(dtype)} did not take {route}")
                err_k, _ = _vocab_agrees(*big, h, w, b, kk, f"{what} k={kk}")
                worst[dtype_name(dtype)] = max(worst[dtype_name(dtype)], err_k)
                print(f"vocab_topk h {[R, Hd]} W {[V, Hd]} k={kk} {dtype_name(dtype)}: "
                      f"max_abs_err {err_k:.3e}", flush=True)
            if dtype == torch.bfloat16:
                again = vocab_topk.classify_topk(h, wp, bp, k)
                require(torch.equal(logp, again[0]) and torch.equal(idx, again[1]),
                        f"vocab top-k: two calls differ at {what}")
            shape = (f"h {[R, Hd]} W {[V, Hd]} k={k} ({int(clear.sum())} of {R * k} indices "
                     f"clear of ties{'; rows 10, 20, 300 tied in every row' if tied else ''})")
            if tied:
                print(f"vocab_topk {shape} {dtype_name(dtype)}: max_abs_err {err:.3e}", flush=True)
                continue
            ms = cuda_time_ms(lambda: vocab_topk.classify_topk(h, wp, bp, k))
            plain = cuda_time_ms(lambda: vocab_topk.classify_topk_reference(h, w, b, k))
            es = h.element_size()
            n_bytes = V * Hd * es + R * Hd * es + 4 * V + 12 * R * k
            bound = bound_ms(n_bytes, 2.0 * R * Hd * V, dtype_name(dtype))
            rows[(route, R)] = report(route, shape, dtype, err, ms, plain, bound)
    out = {}
    for route, dt in (("vocab_topk", "bfloat16"), ("vocab_topk_cuda_cores", "float32")):
        main, eval_rows = (rows[(route, R)] for R in VOCAB_TIMED_ROWS)
        out[route] = {**main, "max_abs_err": worst[dt],
                      f"r{VOCAB_TIMED_ROWS[1]}": {n: eval_rows[n] for n in ("ms", "plain_ms",
                                                                            "bound_ms")}}
    return out


def kernel_vocab_topk_transform() -> dict:
    """#10t: the raw hidden h [R, 768], the classifier transform (an f32 dense
    [768, 768], GELU, LayerNorm) and BERT's tied 30,522 x 768 classifier,
    k = 5, at the decode step's 80 rows and a ragged 37. Beside it the chain
    the decoder runs without --fused_cls for the same work (F.linear, GELU,
    F.layer_norm in the compute dtype, then #10); no single PyTorch call
    computes the function. bf16 runs #10's tensor-core tile kernel after the
    transform's two, f32 the CUDA-core one (each checked by its counter)."""
    Hd, V, k = 768, 30522, BEAM
    worst, rows = {"bfloat16": 0.0, "float32": 0.0}, {}
    for R in VOCAB_T_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(5)
            h = torch.randn(R, Hd, generator=g, device="cuda").to(dtype)
            w = (0.02 * torch.randn(V, Hd, generator=g, device="cuda")).to(dtype)
            b = 0.02 * torch.randn(V, generator=g, device="cuda")
            wt = 0.03 * torch.randn(Hd, Hd, generator=g, device="cuda")  # nn.Linear's [out, in]
            bt = 0.02 * torch.randn(Hd, generator=g, device="cuda")
            ga = 1.0 + 0.1 * torch.randn(Hd, generator=g, device="cuda")
            be = 0.1 * torch.randn(Hd, generator=g, device="cuda")
            tr = (wt, bt, ga, be, LN_EPS)
            wp, bp = vocab_topk.pad_vocab_inputs(w, b)
            before = read_launches()
            logp, idx = vocab_topk.classify_topk(h, wp, bp, k, transform=tr)
            counts = read_launches()
            route = ("vocab_topk_transform" if dtype == torch.bfloat16
                     else "vocab_topk_transform_cuda_cores")
            require(all(counts[n] - before[n] == (n == route) for n in counts),
                    f"vocab top-k with the transform at R={R} {dtype_name(dtype)} did not take "
                    f"{route} alone")
            ref_v, ref_i = vocab_topk.classify_topk_reference(h, w, b, k + 1, transform=tr)
            torch.cuda.synchronize()
            tol = VOCAB_T_TOL[dtype_name(dtype)]
            err = float((logp - ref_v[:, :k]).abs().max())
            worst[dtype_name(dtype)] = max(worst[dtype_name(dtype)], err)
            require(err <= tol, f"vocab top-k with the transform: logp differs from the plain "
                                f"version's by {err} at R={R} {dtype} (limit {tol})")
            gaps = (ref_v[:, :-1] - ref_v[:, 1:]).abs()
            clear = torch.minimum(torch.cat([gaps[:, :1], gaps[:, :-1]], 1), gaps[:, :k]) > tol
            require(bool((idx[clear] == ref_i[:, :k][clear]).all()),
                    f"vocab top-k with the transform: indices differ at R={R} {dtype}")
            what = (f"h {[R, Hd]} W {[V, Hd]} k={k} ({int(clear.sum())} of {R * k} indices "
                    f"clear of near-ties)")
            if R != VOCAB_T_ROWS[0]:
                print(f"vocab_topk_transform {what} {dtype_name(dtype)}: max_abs_err {err:.3e} "
                      f"(limit {tol})", flush=True)
                continue
            ms = cuda_time_ms(lambda: vocab_topk.classify_topk(h, wp, bp, k, transform=tr))
            plain = cuda_time_ms(
                lambda: vocab_topk.classify_topk_reference(h, w, b, k, transform=tr))
            wt_c, bt_c = wt.to(dtype), bt.to(dtype)

            def chain():
                t = gelu_erf(F.linear(h, wt_c, bt_c))
                t = F.layer_norm(t.float(), (Hd,), ga, be, LN_EPS).to(dtype)
                return vocab_topk.classify_topk(t, wp, bp, k)

            chain_ms = cuda_time_ms(chain)
            es = h.element_size()
            n_bytes = R * Hd * es + 4 * Hd * Hd + 12 * Hd + V * Hd * es + 4 * V + 12 * R * k
            bound = bound_ms(n_bytes, 2.0 * R * Hd * (V + Hd), dtype_name(dtype))
            print(f"vocab_topk_transform {what} {dtype_name(dtype)}: the unfused chain for the "
                  f"same work (F.linear, GELU, F.layer_norm, #10): device ms {chain_ms[0]:.5f}",
                  flush=True)
            rows[route] = report(route, what, dtype, err, ms, plain, bound)
            rows[route]["unfused_chain_ms"] = chain_ms[0]
    return {"vocab_topk_transform": {**rows["vocab_topk_transform"],
                                     "max_abs_err": worst["bfloat16"]},
            "vocab_topk_transform_cuda_cores": {**rows["vocab_topk_transform_cuda_cores"],
                                                "max_abs_err": worst["float32"]}}


def kernel_eval_attention_causal() -> dict:
    """#1c against its plain version on strided head-split views, with a
    ragged key mask, on both routes as for #1; the queries with no valid key
    at or before them are padding rows, left out of the comparison. Returns
    each route's row at the decode batch's shape."""
    worst, rows = {}, {}
    for B, H, L, D in CAUSAL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = _attn_inputs(B, H, L, D, dtype, seed=6)
            mask[0, : L // 2] = 0.0  # the first half of row 0's queries see no valid key
            mask[1] = 0.0  # no valid key at all
            causal = torch.ones(L, L, dtype=torch.bool, device="cuda").tril()
            name, err, r = _eval_attention_row(
                (q, k, v, mask), mask.cumsum(dim=1) > 0, dtype, True,
                4.0 * B * H * D * L * (L + 1) / 2, mask.bool()[:, None, None, :] & causal,
                "scaled_dot_product_attention, one boolean mask: key mask and causal")
            worst[name] = max(worst.get(name, 0.0), err)
            if B == BATCH * BEAM:
                rows[name] = r
    return {n: {**r, "max_abs_err": worst[n]} for n, r in rows.items()}


def kernel_reorder_rows() -> dict:
    """#8: a gather into new buffers over the six decode caches [80, 12, 48,
    64] (#7's shape) and an int32 [80, 4, 32], with duplicate indices; a copy,
    so bitwise. The library time is index_select, one call per array."""
    N, H, D, L = BATCH * BEAM, 12, 64, MAX_WORDS
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(7)
        arrays = [torch.randn(N, H, L, D, generator=g, device="cuda").to(dtype)
                  for _ in range(2 * DECODER_LAYERS)]
        arrays.append(torch.randint(-1000, 1000, (N, 4, 32), generator=g, device="cuda",
                                    dtype=torch.int32))
        src = torch.randint(0, N, (N,), generator=g, device="cuda")
        src[:4] = 7  # duplicates
        got = reorder.beam_reorder_rows(arrays, src)
        want = reorder.reorder_rows_reference(arrays, src)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"reorder_rows differs from its plain version ({dtype})")
        del got, want
        ms = cuda_time_ms(lambda: reorder.beam_reorder_rows(arrays, src))
        plain = cuda_time_ms(lambda: reorder.reorder_rows_reference(arrays, src))
        lib = cuda_time_ms(lambda: [torch.index_select(a, 0, src) for a in arrays])
        n_bytes = 2.0 * sum(a.numel() * a.element_size() for a in arrays) + 8 * N
        r = report("reorder_rows", f"6 x {[N, H, L, D]} + int32 {[N, 4, 32]}", dtype, 0.0, ms,
                   plain, bound_ms(n_bytes, 0.0, dtype_name(dtype)),
                   (lib[0], "index_select, one call per array"))
        if dtype == torch.bfloat16:
            row = r
    return row


def _sdpa_train(q, k, v, keep, n_heads: int = TA_HEADS):
    """The yardstick for #2: SDPA on [B, H, L, D] views, boolean key mask, prob dropout."""
    B, _, HD = q.shape
    heads = [t.view(B, t.shape[1], n_heads, HD // n_heads).transpose(1, 2) for t in (q, k, v)]
    return F.scaled_dot_product_attention(*heads, attn_mask=keep[:, None, None, :],
                                          dropout_p=TA_RATE)


def _one_hot(B: int, L: int, n: int) -> torch.Tensor:
    """[B, L, heads*D] with head row j equal to the one-hot vector e_j, so a
    product with it exposes the other operand's column j."""
    eye = torch.zeros(L, TA_HEADS, n, device="cuda")
    eye[:, :, :L] = torch.eye(L, device="cuda")[:, None, :]
    return eye.reshape(1, L, TA_HEADS * n).expand(B, -1, -1).contiguous()


def _launched(fn):
    """fn's result and the launch counts it moved, {kernel: launches}."""
    before = read_launches()
    out = fn()
    after = read_launches()
    return out, {k: n - before[k] for k, n in after.items() if n != before[k]}


def check_dropout_masks(dtype, L: int, kinds=None) -> float:
    """The forward kernel, the backward kernel and the plain version drop the
    same probabilities at [TA_B, L]: v one-hot over keys makes out[i, j] the
    dropped probability (i, j), g one-hot over queries makes dv[j, i] the
    same; with every key valid no kept probability is 0. ``kinds`` names the
    (forward, backward) kernels, launched uncounted (None: the dtype's route,
    through the wrappers). Returns the dropped share."""
    B, H, D = TA_B, TA_HEADS, TA_D
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k = (torch.randn(B, L, H * D, generator=g, device="cuda").to(dtype) for _ in range(2))
    v, grad = _one_hot(B, L, D).to(dtype), _one_hot(B, L, D).to(dtype)
    mask = torch.ones(B, L, device="cuda")
    args = (q, k, v, mask, TA_SEED, TA_RATE, H)
    if kinds is None:
        out, m, l = ta.train_attention_fwd(*args)
        _, _, dv = ta.train_attention_bwd(*args, m, l, grad)
    else:
        out, m, l = ta._launch_fwd(kinds[0], *args)
        _, _, dv = ta._launch_bwd(kinds[1], *args, m, l, grad)
    fwd = out.view(B, L, H, D)[..., :L].permute(0, 2, 1, 3) != 0  # [b, h, i, j]
    back = dv.view(B, L, H, D)[..., :L].permute(0, 2, 3, 1) != 0  # dv[b, j, h, i]
    plain = ta.dropout_keep(TA_SEED, B, H, L, L, TA_RATE, device="cuda")
    torch.cuda.synchronize()
    what = f"({dtype_name(dtype)}, [{B},{L}], {_ta_kinds_name(dtype, L, L, kinds)})"
    require(torch.equal(fwd, plain), f"forward kernel's dropout mask differs from the plain "
                                     f"version's {what}")
    require(torch.equal(back, plain), f"backward kernel's dropout mask differs from the plain "
                                      f"version's {what}")
    return 1.0 - float(plain.float().mean())


def _ta_inputs(B: int, Lq: int, Lk: int, dtype):
    """q, g [B, Lq, 768], k, v [B, Lk, 768], ragged key mask, one all-masked row."""
    H, D = TA_HEADS, TA_D
    g = torch.Generator(device="cuda").manual_seed(6)
    q, grad = (torch.randn(B, Lq, H * D, generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Lk, H * D, generator=g, device="cuda").to(dtype) for _ in range(2))
    mask = (torch.rand(B, Lk, generator=g, device="cuda") > 0.3).float()
    mask[:, 0] = 1.0
    mask[1] = 0.0  # no valid key: a uniform softmax in both versions
    return q, k, v, grad, mask


def _ta_agree(part: str, got, want, dtype, what: str) -> float:
    """Max abs error of a kernel's outputs against the plain version's, each
    within TA_TOL (atol + rtol * |ref|)."""
    atol, rtol = TA_TOL[dtype_name(dtype)]
    err = 0.0
    for a, ref in zip(got, want):
        diff = (a.float() - ref.float()).abs()
        excess = float((diff - atol - rtol * ref.float().abs()).max())
        require(excess <= 0.0, f"train_attention {part} disagrees with its plain version at "
                               f"{what}: max abs err {float(diff.max())}")
        err = max(err, float(diff.max()))
    return err


def _ta_cuda_cores(Lq: int, Lk: int) -> tuple:
    """The CUDA-core (forward, backward) kernels at a head of Lq x Lk."""
    return ta.FWD, ta.BWD_WHOLE if ta.whole_head_backward_fits(Lq, Lk, TA_D) else ta.BWD_TILED


TA_KIND_NAMES = {ta.FWD: "train_attention_fwd_cuda_cores",
                 ta.BWD_WHOLE: "train_attention_bwd_cuda_cores",
                 ta.BWD_TILED: "train_attention_bwd_tiled"}


def _ta_kinds_name(dtype, Lq: int, Lk: int, kinds) -> str:
    if kinds is None:
        return f"{ta.cuda_route(dtype, TA_D, Lq, Lk)}, the dtype's route"
    return " and ".join(TA_KIND_NAMES[k] for k in kinds) + ", uncounted"


def _ta_expect(dtype, Lq: int, Lk: int) -> tuple:
    """The kernels one forward and one backward call launch, by their counters."""
    if ta.cuda_route(dtype, TA_D, Lq, Lk) == ta.TENSOR_CORES:
        return {"train_attention_fwd": 1}, {"train_attention_bwd": 1}
    bwd = ("train_attention_bwd_cuda_cores" if ta.whole_head_backward_fits(Lq, Lk, TA_D)
           else "train_attention_bwd_tiled")
    return {"train_attention_fwd_cuda_cores": 1}, {bwd: 1}


def _ta_bounds(B: int, Lq: int, Lk: int, dtype) -> tuple:
    """Forward and backward bounds: the forward reads q, k, v and writes out,
    m, l; the backward reads q, g, k, v, m, l and writes dq, dk, dv; both
    read the key mask."""
    H, D, es = TA_HEADS, TA_D, torch.finfo(dtype).bits // 8
    qb, kb = B * Lq * H * D * es, B * Lk * H * D * es
    stats = 2 * B * H * Lq * 4 + B * Lk * 4
    return (bound_ms(2 * qb + 2 * kb + stats, 4.0 * B * H * Lq * Lk * D, dtype_name(dtype)),
            bound_ms(3 * qb + 4 * kb + stats, 10.0 * B * H * Lq * Lk * D, dtype_name(dtype)))


def _ta_times(args, m, l, grad, mask, before: bool = False, **timing) -> dict:
    """Device times of #2 on one set of inputs: forward and backward of the
    dtype's route (key None) and, with ``before``, of the CUDA-core kernels
    (key "before"), the plain versions, SDPA's forward and its autograd
    backward (``timing``: cuda_time_ms's runs and repeats)."""
    q, k, v = args[:3]
    B, Lq, HD = q.shape
    t = {("fwd", None): cuda_time_ms(lambda: ta.train_attention_fwd(*args), **timing),
         ("bwd", None): cuda_time_ms(lambda: ta.train_attention_bwd(*args, m, l, grad),
                                     **timing)}
    if before:
        fwd, bwd = _ta_cuda_cores(Lq, k.shape[1])
        t["fwd", "before"] = cuda_time_ms(lambda: ta._launch_fwd(fwd, *args))
        t["bwd", "before"] = cuda_time_ms(lambda: ta._launch_bwd(bwd, *args, m, l, grad))
    t["fwd", "plain"] = cuda_time_ms(lambda: ta.train_attention_reference_fwd(*args),
                                     reference=True, **timing)
    t["bwd", "plain"] = cuda_time_ms(lambda: ta.train_attention_reference_bwd(*args, m, l, grad),
                                     reference=True, **timing)
    keep = mask.bool()
    keep[1] = True  # SDPA gives NaN on a row with no valid key
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    t["fwd", "sdpa"] = cuda_time_ms(lambda: _sdpa_train(*leaves, keep), reference=True,
                                    **timing)
    out = _sdpa_train(*leaves, keep)
    g4 = grad.view(B, Lq, TA_HEADS, HD // TA_HEADS).transpose(1, 2)
    t["bwd", "sdpa"] = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, g4,
                                                                retain_graph=True),
                                    reference=True, **timing)
    return t


SDPA_TRAIN = "scaled_dot_product_attention, boolean key mask, dropout_p 0.1"


def _ta_report(t: dict, shape: str, dtype, ran: dict, errs: dict, bounds,
               before_errs=None) -> dict:
    """Forward and backward rows from _ta_times, named by the kernels the
    dtype's route ran (``ran``), with the CUDA-core kernels' times and errors
    (``before_errs``) on the same inputs printed beside them where timed."""
    rows = {}
    for i, part in enumerate(("fwd", "bwd")):
        lib = (t[part, "sdpa"][0], SDPA_TRAIN + (", autograd backward" if part == "bwd" else ""))
        before = (t[part, "before"], before_errs[part]) if before_errs else None
        rows[part] = report(ran[part], shape, dtype, errs[part], t[part, None], t[part, "plain"],
                            bounds[i], lib, before)
    return rows


def kernel_train_attention() -> dict:
    """#2 forward and backward against the plain versions (ragged key masks,
    one all-masked row) at rates 0 and 0.1, with the kernels each call
    launched checked by their counters: at the FT-Joint towers' and FT-Align's
    cross shapes (TA_SHAPES) in f32 (the CUDA-core kernels) and bf16 (the
    tensor-core kernels, and the CUDA-core ones on the same inputs); at the
    caption step's shapes (TA_CAPTION_SHAPES) in bf16 (tensor cores; the
    CUDA-core kernels, whose backward is the tiled one past the whole-head
    kernel's shared memory, on the same inputs) and f32 (the CUDA-core
    kernels). The CUDA-core kernels on bf16 inputs go through the private
    launch helpers, which count nothing. The dropout masks of each forward
    and backward against the plain version's. bf16 times and errors of the
    tensor-core kernels beside the CUDA-core ones, the bound, the plain
    versions and SDPA; f32 times of the CUDA-core kernels; the tiled backward
    against the whole-head one where both run. Rows: the tensor-core kernels
    at the cross shape in bf16 (the main paths' dtype), the CUDA-core kernels
    there in f32 and the tiled backward at the caption cross tower's [16,
    224] in f32 (the f32 agreement runs' dtype); each row's max_abs_err is
    its kernel's worst in the row's dtype."""
    H, D = TA_HEADS, TA_D
    worst = {}  # (kernel, dtype name): max abs error over the shapes and rates
    for dtype, kinds in ((torch.float32, None), (torch.bfloat16, None),
                         (torch.bfloat16, (ta.FWD, ta.BWD_WHOLE))):
        for L in (TA_L, TA_RAGGED_L):
            drop = check_dropout_masks(dtype, L, kinds)
            n = TA_B * H * L * L
            print(f"train_attention dropout masks ({dtype_name(dtype)}, [{TA_B},{L}], "
                  f"{_ta_kinds_name(dtype, L, L, kinds)}): forward kernel, backward kernel "
                  f"and plain version equal over {n} draws; dropped share {drop:.6f} (rate "
                  f"{TA_RATE}, limit +-{KEEP_RATE_TOL} at [{TA_B},{TA_L}])", flush=True)
            require(L != TA_L or abs(drop - TA_RATE) <= KEEP_RATE_TOL,
                    f"dropped share {drop} is not {TA_RATE}")
    for dtype in (torch.float32, torch.bfloat16):
        check_dropout_masks(dtype, TA_L, (ta.FWD, ta.BWD_TILED))
    print(f"train_attention_bwd_tiled dropout masks at [{TA_B},{TA_L}]: forward kernel, tiled "
          f"backward and plain version equal in f32 and bf16", flush=True)

    rows = {}  # kernel: (row, the dtype it was timed in)
    shapes = [(B, L, L) for B, L in TA_SHAPES] + TA_CAPTION_SHAPES
    for B, Lq, Lk in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            before = dtype == torch.bfloat16  # the CUDA-core kernels on the same inputs
            q, k, v, grad, mask = _ta_inputs(B, Lq, Lk, dtype)
            errs, ran, before_errs = {"fwd": 0.0, "bwd": 0.0}, {}, {"fwd": 0.0, "bwd": 0.0}
            for rate in (0.0, TA_RATE):
                args = (q, k, v, mask, TA_SEED, rate, H)
                want = ta.train_attention_reference_fwd(*args)
                want_grads = ta.train_attention_reference_bwd(*args, want[1], want[2], grad)
                what = f"[{B},{Lq},{Lk}] {dtype_name(dtype)} rate {rate}"
                (out, m, l), ran_f = _launched(lambda: ta.train_attention_fwd(*args))
                grads, ran_b = _launched(lambda: ta.train_attention_bwd(*args, m, l, grad))
                require((ran_f, ran_b) == _ta_expect(dtype, Lq, Lk),
                        f"#2 at {what} launched {ran_f} and {ran_b}, not "
                        f"{_ta_expect(dtype, Lq, Lk)}")
                results = [("fwd", (out, m, l), next(iter(ran_f)), errs),
                           ("bwd", grads, next(iter(ran_b)), errs)]
                if before:
                    kf, kb = _ta_cuda_cores(Lq, Lk)
                    (out_c, m_c, l_c), moved_f = _launched(lambda: ta._launch_fwd(kf, *args))
                    grads_c, moved_b = _launched(
                        lambda: ta._launch_bwd(kb, *args, m_c, l_c, grad))
                    require(not moved_f and not moved_b,
                            f"the uncounted launches moved the counters: {moved_f} {moved_b}")
                    results += [("fwd", (out_c, m_c, l_c), TA_KIND_NAMES[kf], before_errs),
                                ("bwd", grads_c, TA_KIND_NAMES[kb], before_errs)]
                for part, got, name, into in results:
                    ref = want if part == "fwd" else want_grads
                    err = _ta_agree(part, got, ref, dtype, f"{what} ({name})")
                    key = (name, dtype_name(dtype))
                    worst[key] = max(worst.get(key, 0.0), err)
                    into[part] = max(into[part], err)
                    if into is errs:
                        ran[part] = name
                del want, want_grads
            args = (q, k, v, mask, TA_SEED, TA_RATE, H)
            _, m, l = ta.train_attention_fwd(*args)
            shape = f"[{B},{Lq}/{Lk},{H * D}] x {H} heads rate {TA_RATE}"
            cross, long_f32 = (B, Lq) == TA_SHAPES[1], dtype == torch.float32 and Lq == 224
            # timed at the cross shape (the rows) and the tiled backward's f32
            # caption shape; the bf16 tower and caption shapes' times were cut
            # for T1 and T2 (their rows in PERF.md are earlier runs')
            if cross or long_f32:
                t = _ta_times(args, m, l, grad, mask, before)
                r = _ta_report(t, shape, dtype, ran, errs, _ta_bounds(B, Lq, Lk, dtype),
                               before_errs if before else None)
                if cross:
                    rows.update({ran[p]: (r[p], dtype) for p in r})
                if long_f32:  # the tiled backward, in the dtype it runs in
                    rows[ran["bwd"]] = (r["bwd"], dtype)
            del q, k, v, grad, mask
    require(not ta.whole_head_backward_fits(224, 224, D), "the tiled backward is not exercised")
    for B, L in TA_SHAPES:  # where both CUDA-core backwards run: do they agree, which is faster?
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, grad, mask = _ta_inputs(B, L, L, dtype)
            args = (q, k, v, mask, TA_SEED, TA_RATE, H)
            _, m, l = ta._launch_fwd(ta.FWD, *args)
            whole = ta._launch_bwd(ta.BWD_WHOLE, *args, m, l, grad)
            tiled = ta._launch_bwd(ta.BWD_TILED, *args, m, l, grad)
            same = all(torch.equal(a, b) for a, b in zip(whole, tiled))
            t_whole = cuda_time_ms(lambda: ta._launch_bwd(ta.BWD_WHOLE, *args, m, l, grad))
            t_tiled = cuda_time_ms(lambda: ta._launch_bwd(ta.BWD_TILED, *args, m, l, grad))
            print(f"train_attention CUDA-core backward at [{B},{L},{H * D}] {dtype_name(dtype)} "
                  f"rate {TA_RATE}: whole-head {t_whole[0]:.5f} ms, tiled {t_tiled[0]:.5f} ms per "
                  f"call (device); results bitwise equal: {same}", flush=True)
            require(same, f"the tiled backward differs from the whole-head one at [{B},{L}] "
                          f"{dtype_name(dtype)}")
    return {name: {**row, "max_abs_err": worst[name, dtype_name(dtype)]}
            for name, (row, dtype) in rows.items()}


def _ln_agree(name: str, got, want, dtype, tol, what: str) -> float:
    """Max abs error; fails past ``tol`` (element by element in f32, at the
    row's scale in bf16)."""
    atol, rtol = tol[dtype_name(dtype)]
    ref = want.float().abs()
    if dtype == torch.bfloat16:
        ref = ref.amax(dim=-1, keepdim=True)
    diff = (got.float() - want.float()).abs()
    require(got.dtype == want.dtype and got.shape == want.shape
            and bool(torch.isfinite(got).all())
            and float((diff - atol - rtol * ref).max()) <= 0.0,
            f"{name} disagrees with its plain version at {what}: max abs err "
            f"{float(diff.max())}")
    return float(diff.max())


def kernel_layernorm() -> dict:
    """#6 forward and backward against the plain versions at LN_SHAPES, f32
    and bf16 (NormalizeVideo's width in f32 only): y, dx, and dscale/dbias
    within LN_SUM_RTOL of each column's sum of |terms|; bf16 device times
    (f32 at the video width) beside the bound, the plain version and
    torch.nn.functional.layer_norm (forward, and its autograd backward). The
    rows are the cross tower's [3584, 768] in bf16."""
    worst, rows = {"fwd": 0.0, "bwd": 0.0}, {}
    for N, D in LN_SHAPES:
        dtypes = (torch.float32,) if D == 1024 else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
            g = torch.Generator(device="cuda").manual_seed(9)
            x = (0.5 + 2.0 * torch.randn(N, D, generator=g, device="cuda")).to(dtype)
            dy = torch.randn(N, D, generator=g, device="cuda").to(dtype)
            scale = 1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")
            bias = 0.1 * torch.randn(D, generator=g, device="cuda")
            what = f"[{N}, {D}] {dtype_name(dtype)}"
            y = ln_k.layer_norm_fwd(x, scale, bias, LN_EPS)
            dx, ds, db = ln_k.layer_norm_bwd(x, scale, dy, LN_EPS)
            again = ln_k.layer_norm_bwd(x, scale, dy, LN_EPS)
            y_r = ln_k.layer_norm_reference_fwd(x, scale, bias, LN_EPS)
            dx_r, ds_r, db_r = ln_k.layer_norm_reference_bwd(x, scale, dy, LN_EPS)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip((dx, ds, db), again)),
                    f"layernorm_bwd at {what}: two calls differ (dx, dscale or dbias)")
            blocks = ln_k.bwd_blocks(N, torch.cuda.get_device_properties(0).multi_processor_count)
            err_f = _ln_agree("layernorm_fwd", y, y_r, dtype, LN_TOL, what)
            err_b = _ln_agree("layernorm_bwd dx", dx, dx_r, dtype, LN_BWD_TOL, what)
            xf, dyf = x.float(), dy.float()
            xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
                (xf - xf.mean(-1, keepdim=True)).square().mean(-1, keepdim=True) + LN_EPS)
            for name, got, want, terms in (("dscale", ds, ds_r, dyf * xhat),
                                           ("dbias", db, db_r, dyf)):
                diff = (got - want).abs()
                limit = LN_SUM_RTOL * terms.abs().sum(dim=0)
                require(float((diff - limit).max()) <= 0.0,
                        f"layernorm_bwd {name} disagrees with its plain version at {what}: max "
                        f"abs err {float(diff.max())}, largest column scale "
                        f"{float(limit.max()) / LN_SUM_RTOL}")
                err_b = max(err_b, float(diff.max()))
            print(f"layernorm vs plain versions, {what}: max abs errs forward {err_f:.3e}, "
                  f"backward {err_b:.3e}; the backward's dx, dscale and dbias bitwise equal "
                  f"over two calls ({blocks} blocks)", flush=True)
            worst["fwd"], worst["bwd"] = max(worst["fwd"], err_f), max(worst["bwd"], err_b)
            if N == 300 or (dtype == torch.float32 and D != 1024):
                continue
            es, dt = x.element_size(), dtype_name(dtype)
            xl = x.detach().requires_grad_()
            sl, bl = (t.to(dtype).requires_grad_() for t in (scale, bias))
            lib = (cuda_time_ms(lambda: F.layer_norm(xl, (D,), sl, bl, LN_EPS), reference=True),
                   "torch.nn.functional.layer_norm, weight and bias in x's dtype")
            yl = F.layer_norm(xl, (D,), sl, bl, LN_EPS)
            lib_b = (cuda_time_ms(lambda: torch.autograd.grad(yl, [xl, sl, bl], dy,
                                                              retain_graph=True),
                                  reference=True),
                     "its autograd backward (dx, dweight, dbias)")
            del yl
            fwd = report("layernorm_fwd", f"[{N}, {D}]", dtype, err_f,
                         cuda_time_ms(lambda: ln_k.layer_norm_fwd(x, scale, bias, LN_EPS)),
                         cuda_time_ms(lambda: ln_k.layer_norm_reference_fwd(x, scale, bias,
                                                                            LN_EPS),
                                      reference=True),
                         bound_ms(2 * N * D * es + 2 * D * 4, 8.0 * N * D, dt),
                         (lib[0][0], lib[1]))
            bwd = report("layernorm_bwd", f"[{N}, {D}]", dtype, err_b,
                         cuda_time_ms(lambda: ln_k.layer_norm_bwd(x, scale, dy, LN_EPS)),
                         cuda_time_ms(lambda: ln_k.layer_norm_reference_bwd(x, scale, dy,
                                                                            LN_EPS),
                                      reference=True),
                         bound_ms(3 * N * D * es + 3 * D * 4, 16.0 * N * D, dt),
                         (lib_b[0][0], lib_b[1]))
            if (N, dtype) == (3584, torch.bfloat16):
                rows = {"layernorm_fwd": fwd, "layernorm_bwd": bwd}
    return {n: {**rows[n], "max_abs_err": worst[n.split("_")[1]]} for n in rows}


def _ffn_inputs(N: int, dtype, seed: int) -> dict:
    """Activations ~ N(0, 1), BERT-scale weights, f32 LayerNorm parameters."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=g, device="cuda")

    H, Fd = FFN_H, FFN_F
    t = {"x": rn(N, H), "r": rn(N, H), "g": rn(N, H), "w1": rn(H, Fd, s=0.02),
         "b1": rn(Fd, s=0.1), "w2": rn(Fd, H, s=0.02), "b2": rn(H, s=0.1), "w": rn(H, H, s=0.02),
         "b": rn(H, s=0.1)}
    t = {k: v.to(dtype) for k, v in t.items()}
    t["scale"], t["bias"] = 1.0 + rn(H, s=0.1), rn(H, s=0.1)
    return t


def _agree(name: str, got, want, dtype, what: str) -> float:
    """Max abs error over the pairs; fails past FFN_TOL."""
    atol, rtol = FFN_TOL[dtype_name(dtype)]
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"{name} output {i}: {a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
        ref = b.float().abs()
        if dtype == torch.bfloat16:
            ref = ref.amax(dim=-1, keepdim=True)
        diff = (a.float() - b.float()).abs()
        excess = diff - atol - rtol * ref
        worst = int(excess.argmax())
        require(float(excess.max()) <= 0.0 and bool(torch.isfinite(a).all()),
                f"{name} output {i} disagrees with its plain version at {what}: max abs err "
                f"{float(diff.max())}; worst excess at flat index {worst}: kernel "
                f"{float(a.flatten()[worst])}, plain {float(b.flatten()[worst])}")
        err = max(err, float(diff.max()))
    return err


def check_ffn_dropout_masks(dtype) -> dict:
    """#4's and #5's forward kernel, backward kernel and plain version drop
    the same entries at the cross shape: with x = 0, w2 = 0 and b2 = 1 (#4),
    or x = 0, b = 1 and r = 0 (#5), the saved LayerNorm input s is the dropped
    output itself, nonzero exactly where kept; the backward's dropped gradient
    is nonzero exactly where kept. Returns the dropped shares."""
    N, H = FFN_ROWS[0], FFN_H
    t = _ffn_inputs(N, dtype, seed=7)
    zero, one = torch.zeros_like(t["x"]), torch.ones_like(t["b2"])
    shares = {}
    for name, tag in (("ffn_block", philox.FFN_BLOCK_TAG), ("dense_block", philox.DENSE_BLOCK_TAG)):
        if name == "ffn_block":
            _, pre, s = ffn_k.ffn_block_fwd(zero, t["w1"], t["b1"], torch.zeros_like(t["w2"]),
                                            one, t["scale"], t["bias"], FFN_SEED, FFN_RATE,
                                            save=True)
            dropped = ffn_k.ffn_block_bwd(s, t["g"], pre, t["w1"], t["w2"], t["scale"],
                                          FFN_SEED, FFN_RATE)[3]
        else:
            pre = None
            _, s = ffn_k.dense_block_fwd(zero, zero, t["w"], one, t["scale"], t["bias"],
                                         FFN_SEED, FFN_RATE, save=True)
            dropped = ffn_k.dense_block_bwd(s, t["g"], t["w"], t["scale"], FFN_SEED,
                                            FFN_RATE)[1]
        plain = philox.row_dropout_keep(FFN_SEED, N, H, tag, FFN_RATE, device="cuda")
        torch.cuda.synchronize()
        require(torch.equal(s != 0, plain), f"{name} forward kernel's dropout mask differs from "
                                            f"the plain version's ({dtype_name(dtype)})")
        require(torch.equal(dropped != 0, plain), f"{name} backward kernel's dropout mask "
                                                  f"differs from the plain version's "
                                                  f"({dtype_name(dtype)})")
        shares[name] = 1.0 - float(plain.float().mean())
        del pre, s, dropped, plain
    return shares


def _same_twice(name: str, got, again, dtype, what: str) -> None:
    """A bf16 call of #3, #4 or #5 gives bitwise the same outputs (and #4's
    and #5's backward the same dscale and dbias) when called again: the
    splits' partial sums are added in a fixed order, without atomics."""
    if dtype != torch.bfloat16:
        return
    second = again()
    same = [torch.equal(a, b) for a, b in zip(got, second) if a is not None]
    require(all(same), f"{name} at {what}: two calls differ in outputs {same}")


def _check_ffn_route(before: dict, after: dict, dtype, N: int) -> None:
    """#3's, #4's and #5's calls in kernel_ffn took their dtype's route: bf16
    the wgmma kernels (``launches``), f32 the CUDA-core kernels."""
    for name in ("ffn_fwd", "ffn_bwd", "ffn_block_fwd", "ffn_block_bwd", "dense_block_fwd",
                 "dense_block_bwd"):
        tc = after[name] - before[name]
        cc = after[f"{name}_cuda_cores"] - before[f"{name}_cuda_cores"]
        ok = (tc > 0 and cc == 0) if dtype == torch.bfloat16 else (tc == 0 and cc > 0)
        require(ok, f"{name} at N={N} {dtype_name(dtype)}: {tc} wgmma-route and {cc} "
                    f"CUDA-core calls")


def _unfused_chains(dtype):
    """The model's xla route (UniVL's unfused TransformerLayer modules at
    full width, in training mode) for the work of #3, #4 and #5."""
    cfg = UniVLConfig.base().cross
    layer = TransformerLayer(cfg, dtype, device="cuda", use_fused_ffn=False).train()
    rng = Randomness.derive(torch.Generator().manual_seed(0), "cuda")
    inter, out, att = layer.intermediate.dense, layer.output, layer.attention.output
    return {
        "ffn": lambda x: out.dense(gelu_erf(inter(x))),
        "ffn_block": lambda x: out(gelu_erf(inter(x)), x, rng),
        "dense_block": lambda x: att(x, x, rng),
    }


def kernel_ffn() -> dict:
    """#3, #4 and #5, forward and backward, against their plain versions at
    the cross and tower row counts and a ragged one, f32 and bf16, rates 0
    and 0.1 (#3 has no dropout); the three-way dropout-mask check; in bf16
    two calls of #3, #4 and #5 bitwise equal; each call on its dtype's
    route; device times beside the bound, the plain version and the model's
    unfused chain for the same work (forward, and the input gradient
    through autograd). No single PyTorch call computes these functions. The
    rows are the cross shape's in bf16 (#5 also at a tower's rows, under
    ``tower_1536``), and the CUDA-core kernels at a tower's rows in f32."""
    H, Fd = FFN_H, FFN_F
    names = ("ffn_fwd", "ffn_bwd", "ffn_block_fwd", "ffn_block_bwd", "dense_block_fwd",
             "dense_block_bwd")
    worst, rows = {n: 0.0 for n in names}, {}
    worst_f32 = {n: 0.0 for n in names}  # in f32: their CUDA-core kernels
    tower = {}
    for dtype in (torch.float32, torch.bfloat16):
        shares = check_ffn_dropout_masks(dtype)
        print(f"fused FFN dropout masks ({dtype_name(dtype)}, {FFN_ROWS[0]} x {H}): forward "
              f"kernel, backward kernel and plain version equal for #4 and #5; dropped shares "
              f"{shares} (rate {FFN_RATE}, limit +-{FFN_KEEP_TOL})", flush=True)
        require(all(abs(v - FFN_RATE) <= FFN_KEEP_TOL for v in shares.values()),
                f"dropped shares {shares} are not {FFN_RATE}")
    for N in (*FFN_ROWS, *FFN_RAGGED_ROWS):
        big = N == FFN_ROWS[0]
        timing = dict(runs=3, repeats=3) if big else {}
        for dtype in (torch.float32, torch.bfloat16):
            t = _ffn_inputs(N, dtype, seed=8)
            x, r, g, w1, b1, w2, b2, w, b, sc, bi = (t[k] for k in (
                "x", "r", "g", "w1", "b1", "w2", "b2", "w", "b", "scale", "bias"))
            errs = {}
            before = read_launches()
            for rate in (0.0, FFN_RATE):
                what = f"N={N} {dtype_name(dtype)} rate {rate}"
                ffn_args = (x, w1, b1, w2, b2)
                blk_args = (*ffn_args, sc, bi, FFN_SEED, rate)
                den_args = (x, r, w, b, sc, bi, FFN_SEED, rate)
                if rate == 0.0:
                    got = ffn_k.ffn_fwd(*ffn_args, save=True)
                    want = ffn_k.ffn_reference_fwd(*ffn_args)
                    errs["ffn_fwd"] = _agree("ffn_fwd", got, want, dtype, what)
                    _same_twice("ffn_fwd", got, lambda: ffn_k.ffn_fwd(*ffn_args, save=True),
                                dtype, what)
                    got = ffn_k.ffn_bwd(want[1], g, w1, w2)
                    errs["ffn_bwd"] = _agree("ffn_bwd", got,
                                             ffn_k.ffn_reference_bwd(want[1], g, w1, w2),
                                             dtype, what)
                    _same_twice("ffn_bwd", got, lambda: ffn_k.ffn_bwd(want[1], g, w1, w2), dtype,
                                what)
                    del got, want
                got = ffn_k.ffn_block_fwd(*blk_args, save=True)
                want = ffn_k.ffn_block_reference_fwd(*blk_args)
                errs["ffn_block_fwd"] = _agree("ffn_block_fwd", got, want, dtype, what)
                _same_twice("ffn_block_fwd", got,
                            lambda: ffn_k.ffn_block_fwd(*blk_args, save=True), dtype, what)
                _, pre, s = want
                bwd_args = (s, g, pre, w1, w2, sc, FFN_SEED, rate)
                got = ffn_k.ffn_block_bwd(*bwd_args)
                errs["ffn_block_bwd"] = _agree("ffn_block_bwd", got,
                                               ffn_k.ffn_block_reference_bwd(*bwd_args), dtype,
                                               what)
                _same_twice("ffn_block_bwd", got, lambda: ffn_k.ffn_block_bwd(*bwd_args), dtype,
                            what)
                del got, want, pre
                got = ffn_k.dense_block_fwd(*den_args, save=True)
                want = ffn_k.dense_block_reference_fwd(*den_args)
                errs["dense_block_fwd"] = _agree("dense_block_fwd", got, want, dtype, what)
                _same_twice("dense_block_fwd", got,
                            lambda: ffn_k.dense_block_fwd(*den_args, save=True), dtype, what)
                s = want[1]
                den_bwd = (s, g, w, sc, FFN_SEED, rate)
                got = ffn_k.dense_block_bwd(*den_bwd)
                errs["dense_block_bwd"] = _agree("dense_block_bwd", got,
                                                 ffn_k.dense_block_reference_bwd(*den_bwd),
                                                 dtype, what)
                _same_twice("dense_block_bwd", got, lambda: ffn_k.dense_block_bwd(*den_bwd),
                            dtype, what)
                del got, want, s
                torch.cuda.synchronize()
                print(f"fused FFN kernels vs plain versions, {what}: max abs errs "
                      f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }", flush=True)
                for k, v in errs.items():
                    worst[k] = max(worst[k], v)
            _check_ffn_route(before, read_launches(), dtype, N)
            if dtype == torch.float32:
                for k, v in errs.items():
                    worst_f32[k] = max(worst_f32[k], v)
                if N == FFN_ROWS[1]:  # the CUDA-core kernels at a tower's rows
                    rows.update({f"{k}_cuda_cores": v for k, v in _time_ffn(
                        N, t, {}, torch.float32).items()})
            elif N not in FFN_RAGGED_ROWS:
                rows_n = _time_ffn(N, t, timing)
                if big:
                    rows.update(rows_n)
                else:  # #5 at a tower's rows: 18 of its 20 calls a direction a step
                    tower = {n: {k: rows_n[n][k] for k in ("ms", "plain_ms", "bound_ms")}
                             for n in ("dense_block_fwd", "dense_block_bwd")}
            del t
    out = {n: {**rows[n], "max_abs_err": worst[n]} for n in names}
    for n in tower:
        out[n]["tower_1536"] = tower[n]
    out.update({f"{n}_cuda_cores": {**rows[f"{n}_cuda_cores"], "max_abs_err": worst_f32[n]}
                for n in names})
    return out


def _time_ffn(N: int, t: dict, timing: dict, dtype=torch.bfloat16, only=None) -> dict:
    """Device times of the six kernels (#4 and #5 at rate 0.1; ``only``
    some of them) in ``dtype``, their plain versions and the unfused chains,
    with their bounds."""
    H, Fd, es = FFN_H, FFN_F, t["x"].element_size()
    x, r, g, w1, b1, w2, b2, w, b, sc, bi = (t[k] for k in (
        "x", "r", "g", "w1", "b1", "w2", "b2", "w", "b", "scale", "bias"))
    rate, seed = FFN_RATE, FFN_SEED
    _, pre, s4 = ffn_k.ffn_block_fwd(x, w1, b1, w2, b2, sc, bi, seed, rate, save=True)
    _, s5 = ffn_k.dense_block_fwd(x, r, w, b, sc, bi, seed, rate, save=True)
    chains = _unfused_chains(dtype)
    # ln: the LayerNorm's f32 scale and bias (read in the forward), or the
    # backward's dscale and dbias (written; the kernels' per-block partials
    # are their own choice and not counted), beside the scale read (ln // 2)
    nh, nf, hf, hh, ln = N * H * es, N * Fd * es, H * Fd * es, H * H * es, 2 * H * 4
    ffn_ops, dense_ops = 4.0 * N * H * Fd, 2.0 * N * H * H
    cases = {  # name -> (kernel, plain, chain input, bytes, operations)
        "ffn_fwd": (lambda: ffn_k.ffn_fwd(x, w1, b1, w2, b2, save=True),
                    lambda: ffn_k.ffn_reference_fwd(x, w1, b1, w2, b2), "ffn",
                    2 * nh + 2 * hf + (Fd + H) * es + nf, ffn_ops),
        "ffn_bwd": (lambda: ffn_k.ffn_bwd(pre, g, w1, w2),
                    lambda: ffn_k.ffn_reference_bwd(pre, g, w1, w2), "ffn",
                    2 * nh + 3 * nf + 2 * hf, ffn_ops),
        "ffn_block_fwd": (lambda: ffn_k.ffn_block_fwd(x, w1, b1, w2, b2, sc, bi, seed, rate,
                                                      save=True),
                          lambda: ffn_k.ffn_block_reference_fwd(x, w1, b1, w2, b2, sc, bi, seed,
                                                                rate),
                          "ffn_block", 3 * nh + 2 * hf + (Fd + H) * es + ln + nf, ffn_ops),
        "ffn_block_bwd": (lambda: ffn_k.ffn_block_bwd(s4, g, pre, w1, w2, sc, seed, rate),
                          lambda: ffn_k.ffn_block_reference_bwd(s4, g, pre, w1, w2, sc, seed,
                                                                rate),
                          "ffn_block", 4 * nh + 3 * nf + 2 * hf + ln // 2 + ln, ffn_ops),
        "dense_block_fwd": (lambda: ffn_k.dense_block_fwd(x, r, w, b, sc, bi, seed, rate,
                                                          save=True),
                            lambda: ffn_k.dense_block_reference_fwd(x, r, w, b, sc, bi, seed,
                                                                    rate),
                            "dense_block", 4 * nh + hh + H * es + ln, dense_ops),
        "dense_block_bwd": (lambda: ffn_k.dense_block_bwd(s5, g, w, sc, seed, rate),
                            lambda: ffn_k.dense_block_reference_bwd(s5, g, w, sc, seed, rate),
                            "dense_block", 5 * nh + hh + ln // 2 + ln, dense_ops),
    }
    rows = {}
    for name, (kernel, plain, chain, n_bytes, ops) in cases.items():
        if only is not None and name not in only:
            continue
        ms = cuda_time_ms(kernel, **timing)
        plain_ms = cuda_time_ms(plain, reference=True, **timing)
        leaf = x.detach().requires_grad_()
        if name.endswith("_fwd"):
            with torch.no_grad():
                chain_ms = cuda_time_ms(lambda: chains[chain](leaf), reference=True, **timing)
        else:
            y = chains[chain](leaf)
            chain_ms = cuda_time_ms(
                lambda: torch.autograd.grad(y, leaf, g, retain_graph=True), reference=True,
                **timing)
            del y
        tflops = {k: ops / v[0] / 1e9 for k, v in (("kernel", ms), ("unfused chain", chain_ms))}
        print(f"{name} [{N}, {H}] F {Fd}: the model's unfused chain (xla route) for the same "
              f"work: device ms {chain_ms[0]:.5f}"
              f"{' (input gradient through autograd)' if name.endswith('_bwd') else ''}; "
              f"TFLOP/s of the function's {ops / 1e12:.4f} TFLOP: "
              f"{', '.join(f'{k} {v:.1f}' for k, v in tflops.items())}", flush=True)
        rows[name] = report(name, f"[{N}, {H}] F {Fd} rate {rate if 'block' in name else 0.0}",
                            dtype, 0.0, ms, plain_ms, bound_ms(n_bytes, ops, dtype_name(dtype)))
        rows[name]["unfused_chain_ms"] = chain_ms[0]
        rows[name]["tflop_s"] = tflops["kernel"]
    return rows


# pretraining's new shapes: #2 at stage I's visual tower [360, 64], stage II's
# cross tower over all pairs [2304, 112] and its decoder's encoder attention
# (48 queries, 112 keys); #4 and #5 at the pairs' 2,304 x 112 = 258,048 rows
PRE_TA_SHAPES = [(PRE1_CLIPS * PRE_PAIRS, PRE_FRAMES, PRE_FRAMES),
                 ((PRE2_CLIPS * PRE_PAIRS) ** 2, PRE_WORDS + PRE_FRAMES, PRE_WORDS + PRE_FRAMES),
                 (PRE2_CLIPS * PRE_PAIRS, PRE_WORDS, PRE_WORDS + PRE_FRAMES)]
PRE_FFN_ROWS = (PRE2_CLIPS * PRE_PAIRS) ** 2 * (PRE_WORDS + PRE_FRAMES)


def kernel_pretrain_shapes(measured: dict) -> None:
    """#2 (rate 0.1), #4 and #5 (rate 0 and 0.1) at pretraining's new shapes
    in bf16 against their plain versions, on their tensor-core and wgmma
    kernels (checked by the counters), timed beside the bound, the plain
    versions and SDPA (#2) or the unfused chain (#4, #5); each row goes into
    its kernel's ``pretrain_shapes`` in ``measured``."""
    dtype, H = torch.bfloat16, TA_HEADS
    for B, Lq, Lk in PRE_TA_SHAPES:
        q, k, v, grad, mask = _ta_inputs(B, Lq, Lk, dtype)
        args = (q, k, v, mask, TA_SEED, TA_RATE, H)
        what = f"[{B},{Lq},{Lk}] bf16 rate {TA_RATE}"
        want = ta.train_attention_reference_fwd(*args)
        want_grads = ta.train_attention_reference_bwd(*args, want[1], want[2], grad)
        (out, m, l), ran_f = _launched(lambda: ta.train_attention_fwd(*args))
        grads, ran_b = _launched(lambda: ta.train_attention_bwd(*args, m, l, grad))
        require((ran_f, ran_b) == ({"train_attention_fwd": 1}, {"train_attention_bwd": 1}),
                f"#2 at {what} launched {ran_f} and {ran_b}, not the tensor-core kernels")
        errs = {"fwd": _ta_agree("fwd", (out, m, l), want, dtype, what),
                "bwd": _ta_agree("bwd", grads, want_grads, dtype, what)}
        del want, want_grads, out, grads
        # the pairs' [2304, 112]: the plain versions take ~0.2 s a call
        t = _ta_times(args, m, l, grad, mask, **(dict(runs=3, repeats=3) if B * Lq > 100_000
                                                 else {}))
        shape = f"[{B},{Lq}/{Lk},{H * TA_D}] x {H} heads rate {TA_RATE}"
        ran = {"fwd": "train_attention_fwd", "bwd": "train_attention_bwd"}
        rows = _ta_report(t, shape, dtype, ran, errs, _ta_bounds(B, Lq, Lk, dtype))
        for part, name in ran.items():
            measured[name].setdefault("pretrain_shapes", {})[f"[{B},{Lq},{Lk}]"] = rows[part]
        del q, k, v, grad, mask, m, l
        torch.cuda.empty_cache()
    N = PRE_FFN_ROWS
    t = _ffn_inputs(N, dtype, seed=9)
    x, r, g, w1, b1, w2, b2, w, b, sc, bi = (t[k] for k in (
        "x", "r", "g", "w1", "b1", "w2", "b2", "w", "b", "scale", "bias"))
    errs = {}
    before = read_launches()
    for rate in (0.0, FFN_RATE):
        what = f"N={N} bf16 rate {rate}"
        blk_args = (x, w1, b1, w2, b2, sc, bi, FFN_SEED, rate)
        got = ffn_k.ffn_block_fwd(*blk_args, save=True)
        want = ffn_k.ffn_block_reference_fwd(*blk_args)
        errs["ffn_block_fwd"] = max(errs.get("ffn_block_fwd", 0.0),
                                    _agree("ffn_block_fwd", got, want, dtype, what))
        _, pre, s4 = want
        bwd_args = (s4, g, pre, w1, w2, sc, FFN_SEED, rate)
        got = ffn_k.ffn_block_bwd(*bwd_args)
        errs["ffn_block_bwd"] = max(errs.get("ffn_block_bwd", 0.0), _agree(
            "ffn_block_bwd", got, ffn_k.ffn_block_reference_bwd(*bwd_args), dtype, what))
        del got, want, pre, s4
        den_args = (x, r, w, b, sc, bi, FFN_SEED, rate)
        got = ffn_k.dense_block_fwd(*den_args, save=True)
        want = ffn_k.dense_block_reference_fwd(*den_args)
        errs["dense_block_fwd"] = max(errs.get("dense_block_fwd", 0.0),
                                      _agree("dense_block_fwd", got, want, dtype, what))
        den_bwd = (want[1], g, w, sc, FFN_SEED, rate)
        got = ffn_k.dense_block_bwd(*den_bwd)
        errs["dense_block_bwd"] = max(errs.get("dense_block_bwd", 0.0), _agree(
            "dense_block_bwd", got, ffn_k.dense_block_reference_bwd(*den_bwd), dtype, what))
        del got, want
        torch.cuda.empty_cache()
    after = read_launches()
    for name in errs:
        require(after[name] > before[name]
                and after[f"{name}_cuda_cores"] == before[f"{name}_cuda_cores"],
                f"{name} at N={N} left its wgmma kernels")
    print(f"fused FFN kernels vs plain versions at pretraining's N={N} bf16, rates 0 and "
          f"{FFN_RATE}: max abs errs { {k: float(f'{v:.3e}') for k, v in errs.items()} }",
          flush=True)
    rows = _time_ffn(N, t, dict(runs=3, repeats=3), only=tuple(errs))
    for name, row in rows.items():
        measured[name].setdefault("pretrain_shapes", {})[f"[{N}, {FFN_H}]"] = {
            **row, "max_abs_err": errs[name]}
    del t, x, r, g
    torch.cuda.empty_cache()


def _ulps(got, want) -> float:
    """The largest |got - want| in units of 2 bf16 ulps of its row's largest
    |want| (at most 1 passes)."""
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return float(((got.float() - want.float()).abs() / (2 * ulp)).max())


def _tp_ta_check(dtype) -> dict:
    """#2 on TP_HEADS of 12 heads with head0 = 12 - TP_HEADS at
    TP_TA_SHAPES, forward and backward, bitwise against those heads of the
    whole call; the bf16 cross shape timed. Returns the printed times."""
    H, D, h, h0 = TA_HEADS, TA_D, TP_HEADS, TA_HEADS - TP_HEADS
    times = {}
    for B, L in TP_TA_SHAPES:
        q, k, v, grad, mask = _ta_inputs(B, L, L, dtype)
        out, m, l = ta.train_attention_fwd(q, k, v, mask, TA_SEED, TA_RATE, H)
        dq, dk, dv = ta.train_attention_bwd(q, k, v, mask, TA_SEED, TA_RATE, H, m, l, grad)
        cols = slice(h0 * D, H * D)
        mine = [t[..., cols].contiguous() for t in (q, k, v)]
        g2 = grad[..., cols].contiguous()
        args = (*mine, mask, TA_SEED, TA_RATE, h)
        o2, m2, l2 = ta.train_attention_fwd(*args, head0=h0)
        grads = ta.train_attention_bwd(*args, m2, l2, g2, head0=h0)
        same = (torch.equal(o2, out[..., cols]) and torch.equal(m2, m[:, h0:])
                and torch.equal(l2, l[:, h0:])
                and all(torch.equal(a, b[..., cols]) for a, b in zip(grads, (dq, dk, dv))))
        require(same, f"#2 on heads {h0}-{H - 1} with head0 {h0} at [{B},{L}] "
                      f"{dtype_name(dtype)} differs from those heads of the whole call")
        if dtype == torch.bfloat16 and (B, L) == TP_TA_SHAPES[0]:
            ref = dict(reference=True)
            times = {"fwd": cuda_time_ms(lambda: ta.train_attention_fwd(*args, head0=h0)),
                     "bwd": cuda_time_ms(lambda: ta.train_attention_bwd(*args, m2, l2, g2,
                                                                        head0=h0)),
                     "plain_fwd": cuda_time_ms(lambda: ta.train_attention_reference_fwd(
                         *args, h0), **ref),
                     "plain_bwd": cuda_time_ms(lambda: ta.train_attention_reference_bwd(
                         *args, m2, l2, g2, h0), **ref),
                     "unsplit_fwd": cuda_time_ms(lambda: ta.train_attention_fwd(
                         q, k, v, mask, TA_SEED, TA_RATE, H)),
                     "unsplit_bwd": cuda_time_ms(lambda: ta.train_attention_bwd(
                         q, k, v, mask, TA_SEED, TA_RATE, H, m, l, grad))}
            keep = mask.bool().clone()
            keep[1] = True  # SDPA gives NaN on a row with no valid key
            leaves = [x.detach().requires_grad_() for x in mine]
            times["sdpa_fwd"] = cuda_time_ms(lambda: _sdpa_train(*leaves, keep, h), **ref)
            out4 = _sdpa_train(*leaves, keep, h)
            g4 = g2.view(B, L, h, D).transpose(1, 2)
            times["sdpa_bwd"] = cuda_time_ms(lambda: torch.autograd.grad(
                out4, leaves, g4, retain_graph=True), **ref)
            del leaves, out4, g4
            es = 2
            qb = B * L * h * D * es
            stats = 2 * B * h * L * 4 + B * L * 4
            bf, bb = (bound_ms(2 * qb + 2 * qb + stats, 4.0 * B * h * L * L * D, "bfloat16"),
                      bound_ms(3 * qb + 4 * qb + stats, 10.0 * B * h * L * L * D, "bfloat16"))
            print(f"TP #2 [{B},{L}] bf16, {h} of {H} heads (head0 {h0}), rate {TA_RATE}: device "
                  f"ms forward {times['fwd'][0]:.5f}, backward {times['bwd'][0]:.5f}; plain "
                  f"{times['plain_fwd'][0]:.5f} / {times['plain_bwd'][0]:.5f}; bound "
                  f"{bf[0]:.5f} ({bf[1]}) / {bb[0]:.5f} ({bb[1]}); the whole call's "
                  f"{H} heads {times['unsplit_fwd'][0]:.5f} / {times['unsplit_bwd'][0]:.5f}; "
                  f"{SDPA_TRAIN} on the same {h} heads {times['sdpa_fwd'][0]:.5f} / its "
                  f"autograd backward {times['sdpa_bwd'][0]:.5f}", flush=True)
        del q, k, v, grad, mask, out, m, l, dq, dk, dv, mine, g2, o2, m2, l2, grads
        torch.cuda.empty_cache()
    print(f"TP #2 with head0 at {TP_TA_SHAPES} {dtype_name(dtype)}: forward and backward "
          f"bitwise the whole call's heads {h0}-{H - 1}", flush=True)
    return times


def kernel_tp_shapes() -> dict:
    """Phase 3's tensor-parallel shapes (T1's, stated with TP_RANKS): #2 with
    head0 (``_tp_ta_check``), then #4 and #5 cut at the row-parallel product
    at TP_ROWS rows, bf16, rate FFN_RATE: rank 0's and rank 1's GEMMs over F /
    2 and K / 2 against their plain versions, the partials summed and the row
    kernels against the unsplit kernels within 2 bf16 ulps, rank 1's rows
    under sequence parallelism bitwise, and each piece timed beside its plain
    version, its bound and the unsplit kernel. Returns the pieces' JSON keys."""
    for dtype in (torch.float32, torch.bfloat16):
        _tp_ta_check(dtype)
    dtype, N, H, n = torch.bfloat16, TP_ROWS, FFN_H, TP_SP_ROWS
    t = _ffn_inputs(N, dtype, seed=11)
    x, r, g, w1, b1, w2, b2, w, b, sc, bi = (t[k] for k in (
        "x", "r", "g", "w1", "b1", "w2", "b2", "w", "b", "scale", "bias"))
    f, kk = FFN_F // TP_SIZE, FFN_H // TP_SIZE
    drop = (FFN_SEED, FFN_RATE, LN_EPS)
    what = f"N={N} bf16 rate {FFN_RATE}"
    errs, ulps = {}, {}
    # #4 forward: the ranks' GEMMs, the sum, the rows; the unsplit kernel
    shares = [(w1[:, i * f:(i + 1) * f], b1[i * f:(i + 1) * f], w2[i * f:(i + 1) * f])
              for i in range(TP_SIZE)]
    parts = [ffn_k.ffn_part(x, *sh) for sh in shares]
    errs["ffn_split_fwd"] = _agree("ffn_split_fwd", parts[0],
                                   ffn_k.ffn_part_reference(x, *shares[0]), dtype, what)
    part = parts[0][0] + parts[1][0]
    out, s4 = ffn_k.split_rows(part, b2, x, sc, bi, *drop, 4)
    errs["split_rows"] = _agree("split_rows", (out, s4), ffn_k.split_rows_reference(
        part, b2, x, sc, bi, *drop, 4), dtype, what)
    want, pre_full, s_full = ffn_k.ffn_block_fwd(x, w1, b1, w2, b2, sc, bi, FFN_SEED, FFN_RATE,
                                                 save=True)
    ulps["#4 forward"] = _ulps(out, want)
    sp_out, _ = ffn_k.split_rows(part[n:], b2, x[n:], sc, bi, *drop, 4, row0=n)
    require(torch.equal(sp_out, out[n:]), "#4's rows kernel at row0 differs from the call's rows")
    # #4 backward: the LayerNorm head, the ranks' GEMMs, dx's rows
    dffn, _, stats, _, _ = ffn_k.block_bwd_ln(4, s4, g, sc, *drop)
    plain_head = ffn_k.block_bwd_ln_reference(4, s4, g, sc, *drop)
    errs["split_bwd_ln"] = _agree("split_bwd_ln", [dffn], [plain_head[0]], dtype, what)
    sp_dffn = ffn_k.block_bwd_ln(4, s4[n:], g[n:], sc, *drop, row0=n)[0]
    require(torch.equal(sp_dffn, dffn[n:]), "#4's LayerNorm head at row0 differs")
    bparts = [ffn_k.ffn_bwd_part(p[1], dffn, *sh[::2]) for p, sh in zip(parts, shares)]
    errs["ffn_split_bwd"] = _agree("ffn_split_bwd", bparts[0], ffn_k._ffn_backward_core(
        parts[0][1], dffn, *shares[0][::2]), dtype, what)
    dpart = bparts[0][0] + bparts[1][0]
    dx = ffn_k.ffn_bwd_rows(dpart, s4, g, sc, stats, dtype)
    errs["ffn_split_bwd_rows"] = _agree("ffn_split_bwd_rows", [dx],
                                        [(dpart + plain_head[2]).to(dtype)], dtype, what)
    ulps["#4 backward dx"] = _ulps(dx, ffn_k.ffn_block_bwd(s_full, g, pre_full, w1, w2, sc,
                                                           FFN_SEED, FFN_RATE)[0])
    # #5: the ranks' K columns of x (their heads' context) and rows of W
    dparts = [ffn_k.dense_part(x[:, i * kk:(i + 1) * kk].contiguous(), w[i * kk:(i + 1) * kk])
              for i in range(TP_SIZE)]
    errs["dense_split_fwd"] = _agree("dense_split_fwd", [dparts[0]], [ffn_k._mm(
        x[:, :kk], w[:kk])], dtype, what)
    out5, s5 = ffn_k.split_rows(dparts[0] + dparts[1], b, r, sc, bi, *drop, 5)
    want5, s5_full = ffn_k.dense_block_fwd(x, r, w, b, sc, bi, FFN_SEED, FFN_RATE, save=True)
    ulps["#5 forward"] = _ulps(out5, want5)
    dy = ffn_k.block_bwd_ln(5, s5, g, sc, *drop)[0]
    dx5 = torch.cat([ffn_k.dense_bwd_dx(dy, w[i * kk:(i + 1) * kk]) for i in range(TP_SIZE)],
                    dim=1)
    errs["dense_split_bwd"] = _agree("dense_split_bwd", [dx5[:, :kk].contiguous()],
                                     [ffn_k._mm(dy, w[:kk].t()).to(dtype)], dtype, what)
    ulps["#5 backward dx"] = _ulps(dx5, ffn_k.dense_block_bwd(s5_full, g, w, sc, FFN_SEED,
                                                              FFN_RATE)[0])
    print(f"TP #4 and #5 split over {TP_SIZE} ranks at {what}: the pieces against their plain "
          f"versions, max abs errs { {k: float(f'{v:.3e}') for k, v in errs.items()} }; the "
          f"summed halves against the unsplit kernels, in units of 2 bf16 ulps of each row's "
          f"largest value (limit 1): { {k: round(v, 4) for k, v in ulps.items()} }; rank 1's "
          f"{n} rows under sequence parallelism bitwise the call's", flush=True)
    require(all(v <= 1.0 for v in ulps.values()), f"split #4/#5 against the unsplit: {ulps}")
    # times: rank 0's share of each piece, its plain version, the unsplit kernel
    x0, w0 = x[:, :kk].contiguous(), w[:kk]
    ref = dict(reference=True)
    dparts_ds = plain_head[2]
    pieces = {
        "ffn_split_fwd": (lambda: ffn_k.ffn_part(x, *shares[0]),
                          lambda: ffn_k.ffn_part_reference(x, *shares[0]),
                          (N * H * 2 + 2 * H * f * 2 + f * 2 + N * f * 2 + N * H * 4,
                           4.0 * N * H * f), None),
        "dense_split_fwd": (lambda: ffn_k.dense_part(x0, w0), lambda: ffn_k._mm(x0, w0),
                            (N * kk * 2 + H * kk * 2 + N * H * 4, 2.0 * N * kk * H),
                            (lambda: torch.matmul(x0, w0),
                             "torch.matmul, bf16 output where the piece writes f32")),
        "split_rows": (lambda: ffn_k.split_rows(part, b2, x, sc, bi, *drop, 4),
                       lambda: ffn_k.split_rows_reference(part, b2, x, sc, bi, *drop, 4),
                       (N * H * 4 + 3 * N * H * 2 + 3 * H * 4, 12.0 * N * H), None),
        "split_bwd_ln": (lambda: ffn_k.block_bwd_ln(4, s4, g, sc, *drop),
                         lambda: ffn_k.block_bwd_ln_reference(4, s4, g, sc, *drop),
                         (3 * N * H * 2 + N * 16 + 2 * -(-N // 32) * H * 4 + H * 4,
                          16.0 * N * H), None),
        "ffn_split_bwd": (lambda: ffn_k.ffn_bwd_part(parts[0][1], dffn, *shares[0][::2]),
                          lambda: ffn_k._ffn_backward_core(parts[0][1], dffn, *shares[0][::2]),
                          (3 * N * f * 2 + N * H * 2 + 2 * H * f * 2 + N * H * 4,
                           4.0 * N * H * f), None),
        "ffn_split_bwd_rows": (lambda: ffn_k.ffn_bwd_rows(dpart, s4, g, sc, stats, dtype),
                               lambda: (dpart + dparts_ds).to(dtype),
                               (N * H * 4 + 3 * N * H * 2 + N * 16, 8.0 * N * H), None),
        "dense_split_bwd": (lambda: ffn_k.dense_bwd_dx(dy, w0), lambda: ffn_k._mm(
            dy, w0.t()).to(dtype), (N * H * 2 + kk * H * 2 + N * kk * 2, 2.0 * N * H * kk),
                            (lambda: torch.matmul(dy, w0.t()), "torch.matmul")),
    }
    unsplit = {
        "#4 forward": cuda_time_ms(lambda: ffn_k.ffn_block_fwd(x, w1, b1, w2, b2, sc, bi,
                                                               FFN_SEED, FFN_RATE)),
        "#4 backward": cuda_time_ms(lambda: ffn_k.ffn_block_bwd(s_full, g, pre_full, w1, w2, sc,
                                                                FFN_SEED, FFN_RATE)),
        "#5 forward": cuda_time_ms(lambda: ffn_k.dense_block_fwd(x, r, w, b, sc, bi, FFN_SEED,
                                                                 FFN_RATE)),
        "#5 backward": cuda_time_ms(lambda: ffn_k.dense_block_bwd(s5_full, g, w, sc, FFN_SEED,
                                                                  FFN_RATE))}
    rows = {}
    for name, (kernel, plain, (nbytes, flops), library) in pieces.items():
        row = report(f"{name} (a rank's share, tp {TP_SIZE})", f"[{N},{H}]", dtype, errs[name],
                     cuda_time_ms(kernel), cuda_time_ms(plain, **ref),
                     bound_ms(nbytes, flops, "bfloat16"),
                     library=(cuda_time_ms(library[0], **ref)[0], library[1])
                     if library else None)
        rows[name] = {**row, "tp_shape": f"[{N},{H}] tp {TP_SIZE}",
                      "unsplit_ms": {k: v[0] for k, v in unsplit.items()}}
    sp_rows = cuda_time_ms(lambda: ffn_k.split_rows(part[n:], b2, x[n:], sc, bi, *drop, 4,
                                                    row0=n))
    sp_head = cuda_time_ms(lambda: ffn_k.block_bwd_ln(4, s4[n:], g[n:], sc, *drop, row0=n))
    rows["split_rows"]["sp_ms"] = sp_rows[0]
    rows["split_bwd_ln"]["sp_ms"] = sp_head[0]
    print(f"TP the unsplit kernels at [{N},{H}] bf16 (device ms): "
          f"{ {k: round(v[0], 5) for k, v in unsplit.items()} }; under sequence parallelism "
          f"rank 1's {n} rows: split_rows {sp_rows[0]:.5f}, split_bwd_ln {sp_head[0]:.5f}",
          flush=True)
    del t, x, r, g, parts, part, bparts, dpart, dparts, out, s4, dffn, stats, dx, dy, dx5
    del want, pre_full, s_full, want5, s5, s5_full, out5, plain_head, pieces
    torch.cuda.empty_cache()
    return rows


def write_vocab(path: str) -> str:
    """A vocab of BERT's 30,522 entries: the specials, the queries' and the
    training fixtures' words, single characters and their ## pieces, then
    [unusedN]."""
    chars = "abcdefghijklmnopqrstuvwxyz0123456789"
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += sorted({w for q in QUERIES for w in q.split()} | set(fixtures.WORDS))
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
        index = server.index
        require(index.graph and index.capturer.captures == 3,
                f"the server's index: graph {index.graph}, {index.capturer.captures} captures")
        print(f"the server's index on CUDA graphs: 3 captures (video, text, rerank), replays "
              f"{dict(index.replays)}; #1 counted by replay", flush=True)
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
    model.load_state_dict(seeded_weights(cfg), strict=True)
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


def device_events(prof, trace: str, name: str):
    """The profile's kernel, copy and memset events, and the device busy time
    in us: the union of their intervals."""
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    require(bool(events), f"profile {name}: the trace holds no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return events, busy_us


def busy_seconds(prof, name: str) -> float:
    """The device busy time of a profile (the union of its device events'
    intervals), read from the profiler's events without a trace file."""
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    require(bool(spans), f"profile {name}: no device activity")
    busy, end = 0, -1
    for s, e in spans:
        busy += max(0, e - max(s, end))
        end = max(end, e)
    return busy / 1e9


def ms(events) -> float:
    return sum(e["dur"] for e in events) / 1e3


def profile_request(port: int, path: str, body: dict, name: str, trace: str) -> dict:
    """torch.profiler over one request through the server. Device busy time is
    the union of the trace's kernel, copy and memset intervals. Returns the
    request's device busy ms and kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        post(port, path, body)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events, busy_us = device_events(prof, trace, name)
    kernels = [e for e in events if e["cat"] == "kernel"]
    copies = [e for e in events if e["cat"] != "kernel"]
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
    return {"busy_ms": busy_us / 1e3, "kernels": len(kernels)}


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


# the caption decode's kernels by name in a profile: #1's tensor-core kernel,
# #7, #9, #10's tile kernel (which #10t runs too) and #10t's transform
DECODE_KERNEL_NAMES = ("eval_attention_mma_kernel", "reorder_groups_kernel",
                       "decode_attention_kernel", "vocab_tile_mma_kernel",
                       "cls_dense_gelu_kernel<__nv_bfloat16>")
# #1 a batch: the text, visual and cross towers' layers of UniVLConfig.base
ENCODE_ATTENTION = sum(getattr(UniVLConfig.base(), tower).num_hidden_layers
                       for tower in ("bert", "visual", "cross"))


def _decode_kernel_counts(named: dict) -> dict:
    """A profile's DECODE_KERNEL_NAMES counts as KERNELS' names."""
    cls = named["cls_dense_gelu_kernel<__nv_bfloat16>"]
    return {"eval_attention": named["eval_attention_mma_kernel"],
            "beam_reorder_groups": named["reorder_groups_kernel"],
            "beam_decode_self_attention": named["decode_attention_kernel"],
            "vocab_topk": named["vocab_tile_mma_kernel"] - cls, "vocab_topk_transform": cls}


def _decode_launches(steps: int, fused: bool, fused_cls: bool, batches: int = 1) -> dict:
    """The kernels that caption batches of ``steps`` decode steps in all
    launch on a path: #1 in each batch's encode, and a step's #9 three times
    (fused) or #7 once, and #10 or #10t once (the unfused path's classifier
    is PyTorch's)."""
    return {"eval_attention": ENCODE_ATTENTION * batches,
            "beam_reorder_groups": 0 if fused else steps,
            "beam_decode_self_attention": DECODER_LAYERS * steps if fused else 0,
            "vocab_topk": steps if fused and not fused_cls else 0,
            "vocab_topk_transform": steps if fused_cls else 0}


def _profiled_decode(run, gen, label: str, want) -> dict:
    """``run(j)``, one caption request of ``gen``'s, profiled PROFILE_RUNS
    times, up to PROFILE_ATTEMPTS profiles until its kernels by name (as
    KERNELS' names, each the largest count over the runs) are ``want(steps)``:
    the request's decode steps, those counts, what the steps imply, the
    profile's numbers and its text."""
    for attempt in range(PROFILE_ATTEMPTS):
        steps0 = gen.steps
        r = _profiled_steps(run, 1, label, DECODE_KERNEL_NAMES)
        steps = (gen.steps - steps0) / PROFILE_RUNS
        require(steps == int(steps), f"{label}: the profiled requests took unequal steps")
        counts = None if r["named"] is None else _decode_kernel_counts(r["named"])
        if counts == want(int(steps)):
            break
        print(f"{label}: kernels by name {counts} against {want(int(steps))} in profile "
              f"{attempt + 1} (records short of each run's fullest {r['lost']}; None: runs not "
              f"told apart); profiled again", flush=True)
    return {"steps": int(steps), "counts": counts, "want": want(int(steps)), "raw": r,
            "profile": f"{_profiled_text(r)} (a request as one step), records short of the "
                       f"fullest run {r['lost']}"}


def phase_caption(tmp: str, vocab: str, paths, fused: bool, fused_cls: bool = False) -> dict:
    """The caption server on its default (fused) path, with --fused_cls (the
    classifier transform inside the vocab kernel, #10t), or with
    --no-fused_decode --no-fused_vocab; returns its launch counts, captions
    and one profiled request's device ms and launches a decode step."""
    label = "fused_cls" if fused_cls else "fused" if fused else "unfused"
    t0 = time.perf_counter()
    server, thread = start_server(
        ["--device", "cuda", "--mode", "caption", "--vocab_file", vocab,
         "--output_dir", os.path.join(tmp, f"out_{label}"), "--port", "0",
         "--max_words", str(MAX_WORDS), "--max_frames", "48", "--beam_size", str(BEAM),
         "--decoder_num_hidden_layers", str(DECODER_LAYERS), "--serve_batch_size", str(BATCH),
         "--seed", "0"] + ([] if fused else ["--no-fused_decode", "--no-fused_vocab"])
        + (["--fused_cls"] if fused_cls else [])
        + (["--mode", "both", "--rerank_store_full"] if label == "unfused" else []))
    port = server.server_address[1]
    svc = server.caption_service
    gen = svc.generator
    require((svc.fused_decode, svc.fused_vocab, svc.fused_cls) == (fused, fused, fused_cls),
            f"caption service fused_decode {svc.fused_decode}, fused_vocab {svc.fused_vocab}, "
            f"fused_cls {svc.fused_cls}")
    print(f"caption server ({label}) up in {time.perf_counter() - t0:.1f} s", flush=True)
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
        # the launches on the device (the graphs counted by replay): as many as
        # the batches and their steps imply, and no other kernel
        counts, steps, batches = read_launches(), gen.steps, gen.batches
        require(steps >= batches, f"{steps} decode steps for {batches} batches")
        path = {**{k: 0 for k in KERNELS}, **_decode_launches(steps, fused, fused_cls, batches)}
        require(counts == path, f"caption ({label}) launches {counts}: {batches} batches of "
                                f"{steps} steps in all imply {path}")
        # a request's kernels by name, replayed: as many as its steps imply
        named = _profiled_decode(
            lambda j: check_captions(post(port, "/v1/caption", caption_body(paths, 0, False)),
                                     BATCH), gen, f"caption ({label})",
            lambda n: _decode_launches(n, fused, fused_cls))
        want = named["want"]
        print(f"caption ({label}): {batches} batches, {steps} decode steps (of at most "
              f"{batches * (MAX_WORDS - 1)}); launches {({k: v for k, v in counts.items() if v})}"
              f"; a replayed request of "
              f"{named['steps']} steps launched {named['counts']}, its steps imply {want} "
              f"({named['profile']})", flush=True)
        require(named["counts"] == want,
                f"caption ({label}) request launches {named['counts']}, steps imply {want}")

        window = CAPTION_WINDOW if label == "fused" else UNFUSED_WINDOW
        lat, steps0, per_step = [], gen.steps, None
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

        if label == "fused":
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
        raw = named["raw"]  # a request as one step
        per_step = {"busy_ms": raw["busy_ms"] / named["steps"],
                    "kernels": raw["launches"] / named["steps"]}
        print(f"profile caption ({label}): {named['steps']} decode steps; per decode step "
              f"device busy {per_step['busy_ms']:.4f} ms, {per_step['kernels']:.2f} kernel "
              f"launches (the encode and the cross encoder spread over the steps); a request "
              f"busy {raw['share']:.4f} of its wall {raw['wall_ms']:.3f} ms (profiler on)",
              flush=True)
        if label == "unfused":
            both = _mode_both_retrieval(port, server, paths)
    finally:
        stop_server(server, thread)
    require(not server.caption_coalescer._worker.is_alive(), "the coalescer did not stop")
    out = {"launches": counts, "captions": captions, "per_step": per_step}
    if label == "unfused":
        out["mode_both"] = both
    return out


def _mode_both_retrieval(port: int, server, paths) -> dict:
    """The unfused caption server runs --mode both: an add and a search with
    rerank beside its caption requests, the index's graphs in a pool of
    their own; #1 as many as the traffic implies, no decode kernel. Returns
    the launches."""
    reset_launches()
    out = post(port, "/v1/retrieval/add",
               {"feature_paths": paths[:N_CLIPS], "ids": [f"b{i}" for i in range(N_CLIPS)]})
    res = post(port, "/v1/retrieval/search", {"queries": QUERIES, "top_k": TOP_K,
                                              "rerank": RERANK})["results"]
    check_results(res, N_QUERIES)
    counts = read_launches()
    cfg = UniVLConfig.base()
    expected = (-(-N_CLIPS // BATCH) * cfg.visual.num_hidden_layers
                + -(-N_QUERIES // BATCH) * cfg.bert.num_hidden_layers
                + -(-N_QUERIES // RERANK_TILE) * cfg.cross.num_hidden_layers)
    index, dec = server.index, server.caption_service.generator.decoder
    require(out["indexed"] == N_CLIPS and counts == {**{k: 0 for k in KERNELS},
                                                     "eval_attention": expected},
            f"--mode both: indexed {out['indexed']}, launches {counts}, #1 implies {expected}")
    require(index.graph and index.capturer.captures == 3
            and index.capturer.pool != dec.capturer.pool,
            f"--mode both: the index's graph {index.graph}, captures "
            f"{index.capturer.captures}, its pool apart from the decoder's")
    print(f"--mode both (the unfused caption server): an add of {N_CLIPS} clips and a search "
          f"of {N_QUERIES} queries with rerank {RERANK} answered beside the caption requests; "
          f"#1 {expected} launches as the traffic implies; the index's 3 graphs in a pool "
          f"apart from the decoder's", flush=True)
    return counts


# C1: the caption beam search on its CUDA-graph route against the eager one,
# at the server's 16-clip request, the eval's batch of 32 and a ragged last
# batch, one step and C1_UNROLL steps a replay, on the three decode paths
C1_BATCHES = (BATCH, 32, 7)
C1_UNROLL = 4
C1_PAIRS = {"fused": 5, "--fused_cls": 2, "unfused": 2}  # the server's default path timed most
C1_PATHS = {"fused": dict(fused_decode=True, fused_vocab=True),
            "--fused_cls": dict(fused_decode=True, fused_vocab=True, fused_cls=True),
            "unfused": dict(fused_decode=False, fused_vocab=False)}
C1_EXIT_BIAS = 1e4  # added to [SEP]'s classifier bias: every instance ends at its first step


def _caption_batch(tok, clips, n: int, first: int, transcripts: bool) -> dict:
    """A host batch of n clips from clips[first:] (with QUERIES as their
    transcripts), built as CaptionService builds one."""
    feats = np.zeros((n, 48, 1024), np.float32)
    vmask = np.zeros((n, 48), np.int32)
    ids = np.zeros((n, MAX_WORDS), np.int32)
    amask = np.zeros((n, MAX_WORDS), np.int32)
    for i in range(n):
        feats[i], vmask[i], _ = pad_video(clips[(first + i) % len(clips)], 48, 1024)
        text = QUERIES[(first + i) % len(QUERIES)] if transcripts else ""
        e = encode_text(text, tok, MAX_WORDS)
        ids[i], amask[i] = e["input_ids"], e["attention_mask"]
    return {"input_ids": ids, "token_type_ids": np.zeros_like(ids), "attention_mask": amask,
            "video": feats, "video_mask": vmask}


def _scheduled(steps: int, unroll: int) -> int:
    """The steps a decode of ``unroll`` steps a replay runs where one step a
    replay runs ``steps``: replays of ``unroll`` while all stay in the cache
    bucket, then single steps to its end, until the replay that reaches them."""
    t = 1
    for bound in beam_search._cache_buckets(MAX_WORDS):
        for n in ((unroll, 1) if unroll > 1 else (1,)):
            while t + n - 1 < bound:
                t += n
                if t - 1 >= steps:
                    return t - 1
    return t - 1


def _c1_calls(label: str, eager, graphs: dict, cases: dict, decoded=None) -> list:
    """Each case decoded eagerly, then twice on each graph route (the first
    call captures what it has not yet, the second replays): tokens and
    scores bitwise the eager decode's, the steps its (one step a replay) or
    its runs' (C1_UNROLL); a second call captures nothing, replays one encode
    and runs of steps that add up to its steps, and reads one byte a replay.
    ``decoded``: cases already decoded eagerly. Returns the rows printed."""
    rows = []
    for case, batch in cases.items():
        want_t, want_s, want_n = (decoded or {}).get(case) or eager.decode(batch)
        if case == "early exit":
            require(want_n == 1, f"C1 {label} early exit: the eager decode ran {want_n} steps")
        for u, gen in graphs.items():
            dec = gen.decoder
            for call in ("first", "second"):
                before = (dec.capturer.captures, dict(dec.replays), dec.reads,
                          gen.encode_replays)
                got_t, got_s, n = gen.decode(batch)
                replays = {k: v - before[1].get(k, 0) for k, v in dec.replays.items()
                           if v - before[1].get(k, 0)}
                require(torch.equal(got_t, want_t) and torch.equal(got_s, want_s),
                        f"C1 {label} {case} U={u} ({call} call): tokens or scores differ from "
                        f"the eager decode's")
                require(n == _scheduled(want_n, u),
                        f"C1 {label} {case} U={u}: {n} steps, the eager decode {want_n}")
                if call == "second":
                    require(dec.capturer.captures == before[0]
                            and gen.encode_replays == before[3] + 1
                            and sum(k * v for k, v in replays.items()) == n
                            and dec.reads - before[2] == sum(replays.values()),
                            f"C1 {label} {case} U={u}: captures "
                            f"{dec.capturer.captures - before[0]}, "
                            f"encode replays {gen.encode_replays - before[3]}, replays "
                            f"{replays} for {n} steps, reads {dec.reads - before[2]}")
            rows.append(f"{case} U={u}: {n} steps (eager {want_n}), replays {replays}")
    return rows


def _c1_new_weights(label: str, model, graphs: dict, batch, before, fresh) -> str:
    """The tied word table (the embedding and the classifier) negated in
    place, where the graphs' casts of it are: each reused graph generator
    decodes ``batch`` bitwise as ``fresh()``, a generator built after the
    change, and not as ``before`` (the decode before it). The table is
    restored after."""
    table = model.bert.embeddings.word_embeddings.weight
    with torch.no_grad():
        table.neg_()
    try:
        want_t, want_s, _ = fresh().decode(batch)
        require(not torch.equal(want_s, before[1]),
                f"C1 {label}: negating the word table left the scores as they were")
        for u, gen in graphs.items():
            got_t, got_s, _ = gen.decode(batch)
            require(torch.equal(got_t, want_t) and torch.equal(got_s, want_s),
                    f"C1 {label} U={u}: after the word table changed in place, the reused graphs "
                    f"decode otherwise than a generator built after the change")
    finally:
        with torch.no_grad():
            table.neg_()
    return f"the word table changed in place: U={sorted(graphs)} as a fresh generator"


def _c1_moved_weights(label: str, model, graphs: dict, batch, fresh) -> str:
    """The tied word table's storage replaced by its negation: each reused
    graph generator drops its decoder, its graphs and their memory pool,
    captures anew in a new pool and decodes ``batch`` bitwise as
    ``fresh()``, a generator built after the change. The table's storage is
    restored after."""
    table = model.bert.embeddings.word_embeddings.weight
    saved = table.data
    with torch.no_grad():
        table.data = -saved
    try:
        want_t, want_s, _ = fresh().decode(batch)
        for u, gen in graphs.items():
            pool = gen.decoder.capturer.pool
            got_t, got_s, _ = gen.decode(batch)
            require(torch.equal(got_t, want_t) and torch.equal(got_s, want_s)
                    and gen.decoder.capturer.pool not in (None, pool),
                    f"C1 {label} U={u}: after the word table's storage moved, the reused graphs "
                    f"decode otherwise than a generator built after the change, or in the old "
                    f"pool")
    finally:
        with torch.no_grad():
            table.data = saved
    return (f"the word table's storage replaced: U={sorted(graphs)} captured anew in new pools, "
            f"as a fresh generator")


def _c1_request_ms(gen, batch) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen.generate(batch)
    return 1e3 * (time.perf_counter() - t0)


def phase_caption_graphs(vocab: str, clips) -> dict:
    """C1: CaptionGenerator on its CUDA-graph route (the card's default)
    against graph=False, the same seeded weights, UniVLConfig.base in bf16
    with 3 decoder layers, beam 5, max_len 48, on the fused, --fused_cls
    and unfused paths. In deterministic mode: bitwise (_c1_calls) at
    batches of 16, 32 and 7 and with every instance ending at its first
    step, at one and C1_UNROLL steps a replay, and after the word table
    changed in place as a generator built after it; #1, #7, #9, #10 and #10t by
    name in a replayed request as many as in an eager one and as its steps
    imply. In the default mode: C1_PAIRS alternating pairs of a 16-clip
    request on each route, one step and C1_UNROLL a replay; peak memory.
    Returns the timings."""
    tok = WordPieceTokenizer(vocab)
    cfg = UniVLConfig.base(max_words=MAX_WORDS, max_frames=48, stage_two=True,
                           task_type="caption", compute_dtype="bfloat16",
                           decoder_num_hidden_layers=DECODER_LAYERS)
    model = UniVL(cfg, device="cuda")
    model.load_state_dict(seeded_weights(cfg), strict=True)
    model.eval()
    bias = model.decoder.classifier.cls.predictions.bias
    batches = {f"{n} clips": _caption_batch(tok, clips, n, 11 * i, transcripts=i == 1)
               for i, n in enumerate(C1_BATCHES)}
    request = batches[f"{BATCH} clips"]
    kw = dict(beam_size=BEAM, max_len=MAX_WORDS)
    unrolled = f"graph U={C1_UNROLL}"
    out = {}
    for label, path in C1_PATHS.items():
        fused, fused_cls = path["fused_decode"], path.get("fused_cls", False)
        want = lambda n: _decode_launches(n, fused, fused_cls)  # noqa: E731
        with deterministic_mode():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            peak, gens, first = {}, {}, {}
            for route, extra in (("eager", dict(graph=False)), ("graph", dict(unroll=1)),
                                 (unrolled, dict(unroll=C1_UNROLL))):
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                gens[route] = CaptionGenerator(model, tok, "cuda", **kw, **path, **extra)
                t0 = time.perf_counter()
                first[route] = gens[route].decode(request)
                torch.cuda.synchronize()
                first[route] = (first[route], 1e3 * (time.perf_counter() - t0))
                peak[route] = (torch.cuda.max_memory_allocated() - held) / 2**30
            eager = gens["eager"]
            graphs = {1: gens["graph"], C1_UNROLL: gens[unrolled]}
            rows = _c1_calls(label, eager, graphs, batches, {f"{BATCH} clips": first["eager"][0]})
            saved = bias.detach().clone()
            with torch.no_grad():
                bias[tok.eos_id] += C1_EXIT_BIAS
            try:
                rows += _c1_calls(label, eager, graphs, {"early exit": request})
            finally:
                with torch.no_grad():
                    bias.copy_(saved)
            rows.append(_c1_new_weights(label, model, graphs, request, first["eager"][0],
                                        lambda: CaptionGenerator(model, tok, "cuda", **kw, **path,
                                                                 graph=False)))
            named = {r: _profiled_decode(lambda j, g=gens[r]: g.generate(request), gens[r],
                                         f"C1 {label} ({r})", want)
                     for r in ("graph", "eager")}
            require(all(v["counts"] == v["want"] for v in named.values()),
                    f"C1 {label}: kernels by name a request, replayed "
                    f"{named['graph']['counts']}, eager {named['eager']['counts']}, the steps "
                    f"imply {named['graph']['want']}")
        times = {"graph": [], "eager": [], unrolled: []}
        for pair in range(C1_PAIRS[label]):  # in turns: graph, eager, unrolled, the reverse
            for route in (("graph", "eager", unrolled), (unrolled, "eager", "graph"))[pair % 2]:
                times[route].append(_c1_request_ms(gens[route], request))
        med = {r: float(np.median(v)) for r, v in times.items()}
        if label == "fused":  # the server's path: its graphs after the weights' storage moved
            with deterministic_mode():
                rows.append(_c1_moved_weights(
                    label, model, graphs, request,
                    lambda: CaptionGenerator(model, tok, "cuda", **kw, **path, graph=False)))
        raw = {r: v["raw"] for r, v in named.items()}
        steps = named["graph"]["steps"]
        print(f"C1 {label}: bitwise the eager decode in deterministic mode ({'; '.join(rows)}); "
              f"a {BATCH}-clip request of {steps} steps launched {named['graph']['counts']} "
              f"replayed and {named['eager']['counts']} eager; replayed "
              f"{named['graph']['profile']}; eager {named['eager']['profile']}", flush=True)
        print(f"C1 {label}, {BATCH}-clip request, default mode, {C1_PAIRS[label]} alternating "
              f"pairs: ms a request, graph {[round(x, 3) for x in times['graph']]} median "
              f"{med['graph']:.3f}, eager {[round(x, 3) for x in times['eager']]} median "
              f"{med['eager']:.3f} ({med['eager'] / med['graph']:.3f}x), {unrolled} "
              f"{[round(x, 3) for x in times[unrolled]]} median {med[unrolled]:.3f}; busy "
              f"share of a request (deterministic mode's profile) graph "
              f"{raw['graph']['share']:.4f}, eager "
              f"{raw['eager']['share']:.4f}; launches a step graph "
              f"{raw['graph']['launches'] / steps:.2f}, eager "
              f"{raw['eager']['launches'] / steps:.2f}; the first request (graphs: the eager "
              f"first uses and the captures, {gens['graph'].decoder.capturer.seconds:.3f} and "
              f"{gens[unrolled].decoder.capturer.seconds:.3f} s of captures in all) "
              f"{ {r: round(v[1], 3) for r, v in first.items()} } ms, its peak device memory "
              f"{ {r: round(v, 3) for r, v in peak.items()} } GiB", flush=True)
        out[label] = {"ms": med, "peak_gib": peak}
        del gens, eager, graphs, named
    del model
    torch.cuda.empty_cache()
    return out


# I1: the retrieval index on its CUDA-graph route against the eager one, at
# the server's shapes: adds of N_CLIPS clips in batches of BATCH, searches
# of N_QUERIES queries with and without rerank RERANK
I1_PAIRS = 5
I1_SCALE = 1.01  # every parameter's storage replaced by one holding its values times this


def _i1_ids(tag: str, n: int = N_CLIPS) -> list:
    return [f"{tag}{i}" for i in range(n)]


def _i1_requests(index, clips, tag: str) -> dict:
    """An add of N_CLIPS clips, then a search with and without rerank."""
    index.add(clips, ids=_i1_ids(tag))
    return {r: index.search(QUERIES, top_k=TOP_K, rerank=r) for r in (0, RERANK)}


def _i1_bitwise(what: str, g, e, got: dict, want: dict) -> None:
    """The two indexes' stores and a request's results bitwise equal."""
    require(len(g) == len(e) and g.ids == e.ids and np.array_equal(g.video_emb, e.video_emb)
            and np.array_equal(g.vis_full, e.vis_full) and np.array_equal(g.vm_full, e.vm_full),
            f"I1 {what}: the graph route's store differs from the eager route's")
    for r in want:
        check_results([[{"score": x} for _, x in hits] for hits in got[r]], N_QUERIES)
        require(got[r] == want[r], f"I1 {what}: the search results (rerank {r}) differ from "
                                   f"the eager route's")


def _i1_new_weights(model, tok, g, clips, before: np.ndarray) -> str:
    """Every parameter's storage replaced (its values scaled by I1_SCALE):
    the graph index drops its graphs and, reused, adds ``clips`` and
    searches bitwise as an index built after the change, their embeddings
    other than ``before`` (theirs before it). The parameters are restored
    after."""
    params = list(model.parameters())
    saved = [p.data for p in params]
    with torch.no_grad():
        for p in params:
            p.data = p.data * I1_SCALE
    try:
        fresh = VideoRetrievalIndex(model, tok, "cuda", batch_size=BATCH, store_full=True)
        n = len(g)
        got = _i1_requests(g, clips, "n")
        require(not g.check_weights() and g.capturer.captures == 6,
                f"I1: {g.capturer.captures} captures after the weights' storage moved, not 3 "
                f"more")
        fresh.add(clips, ids=g.ids[n:])
        require(np.array_equal(g.video_emb[n:], fresh.video_emb)
                and np.array_equal(g.vis_full[n:], fresh.vis_full),
                "I1: after the weights' storage moved, the reused graphs encode otherwise than "
                "a fresh index")
        fresh.ids, fresh.video_emb, fresh.vis_full, fresh.vm_full = (
            g.ids, g.video_emb, g.vis_full, g.vm_full)
        want = {r: fresh.search(QUERIES, top_k=TOP_K, rerank=r) for r in (0, RERANK)}
        require(got == want, "I1: after the weights' storage moved, the reused graphs search "
                             "otherwise than a fresh index")
        require(not np.array_equal(g.video_emb[n:], before),
                "I1: scaling the weights changed no embedding")
    finally:
        with torch.no_grad():
            for p, data in zip(params, saved):
                p.data = data
    return "every parameter's storage replaced: the graphs dropped, then as a fresh index"


def _i1_computing(by_name: dict) -> dict:
    """A profile's kernels by name without fills and copies: deterministic
    mode fills every new allocation, and the eager route allocates its
    inputs at every call where a graph's static inputs were allocated once;
    the graph route copies a rerank tile's text rows into its static input,
    a device copy the driver may run as a kernel (``memcpy32_post``)."""
    return {n: c for n, c in by_name.items()
            if "FillFunctor" not in n and not n.startswith("memcpy")}


def _i1_unequal(named: dict) -> dict:
    """The kernel names whose counts differ between the routes' profiles."""
    out = {}
    for q in named["graph"]:
        g, e = (_i1_computing(named[r][q]["by_name"] or {}) for r in ("graph", "eager"))
        out[q] = {n[:100]: (g.get(n), e.get(n)) for n in set(g) | set(e) if g.get(n) != e.get(n)}
    return out


I1_PROFILE_GAP_S = 0.25  # a request's host work (the store's growth) idles the card for longer


def _i1_profiled(index, clips, route: str, attempt: int) -> dict:
    """An add and a search with rerank RERANK, each profiled as a request
    (the adds' ids the same on both routes)."""
    calls = {"add": lambda j: index.add(clips, ids=_i1_ids(f"p{attempt}-{j}-")),
             "search": lambda j: index.search(QUERIES, top_k=TOP_K, rerank=RERANK)}
    return {req: _profiled_steps(run, 1, f"I1 {route} {req}", ("eval_attention_mma_kernel",),
                                 I1_PROFILE_GAP_S)
            for req, run in calls.items()}


def phase_index_graphs(vocab: str, clips) -> dict:
    """I1: VideoRetrievalIndex on its CUDA-graph route (the card's default)
    against graph=False, the same seeded weights, UniVLConfig.base in bf16
    (--train_sim_after_cross --rerank_store_full, 48 words, 48 frames, batch
    BATCH). In deterministic mode: the stores (pooled embeddings, the full
    visual outputs, their masks) and each search's ids and scores, with and
    without rerank, bitwise equal after a first add and search (the graphs'
    eager first uses and captures) and after a second (replays only, no
    capture); the kernels by name of a replayed add and search equal an
    eager one's, #1 as many as the batches imply; every parameter's storage
    replaced, the reused graphs as a fresh index. In the default mode:
    I1_PAIRS alternating pairs of an add and a search on each route, peak
    memory. Returns the timings."""
    tok = WordPieceTokenizer(vocab)
    cfg = UniVLConfig.base(max_words=48, max_frames=48, train_sim_after_cross=True,
                           compute_dtype="bfloat16")
    model = UniVL(cfg, device="cuda")
    model.load_state_dict(seeded_weights(cfg), strict=True)
    model.eval()
    first, second = clips[:N_CLIPS], clips[N_CLIPS:2 * N_CLIPS]
    routes = ("eager", "graph")
    idx, peak, first_ms, res = {}, {}, {}, {}
    with deterministic_mode():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for route in routes:
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            idx[route] = VideoRetrievalIndex(model, tok, "cuda", batch_size=BATCH,
                                             store_full=True, graph=route == "graph")
            t0 = time.perf_counter()
            res[route] = _i1_requests(idx[route], first, "c")
            first_ms[route] = 1e3 * (time.perf_counter() - t0)
            peak[route] = (torch.cuda.max_memory_allocated() - held) / 2**30
        g, e = idx["graph"], idx["eager"]
        _i1_bitwise("first add and search", g, e, res["graph"], res["eager"])
        batches = -(-N_CLIPS // BATCH)
        require(g.graph and not e.graph and g.capturer.captures == 3 and not e.graphs
                and dict(g.replays) == {"video": batches - 1, "text": 1},
                f"I1: {g.capturer.captures} captures (video, text, rerank: 3), replays "
                f"{dict(g.replays)} after the first requests")
        got, want = (_i1_requests(i, second, "d") for i in (g, e))
        _i1_bitwise("second add and search", g, e, got, want)
        require(g.capturer.captures == 3
                and dict(g.replays) == {"video": 2 * batches - 1, "text": 3, "rerank": 1},
                f"I1: the second requests captured {g.capturer.captures - 3} graphs, replays "
                f"{dict(g.replays)}")
        implied = {"add": batches * cfg.visual.num_hidden_layers,
                   "search": (-(-N_QUERIES // BATCH) * cfg.bert.num_hidden_layers
                              + -(-N_QUERIES // RERANK_TILE) * cfg.cross.num_hidden_layers)}
        named = {}
        for attempt in range(PROFILE_ATTEMPTS):
            named = {route: _i1_profiled(idx[route], second, route, attempt)
                     for route in routes}
            same = all(named["graph"][q]["by_name"] is not None
                       and named["eager"][q]["by_name"] is not None
                       and _i1_computing(named["graph"][q]["by_name"])
                       == _i1_computing(named["eager"][q]["by_name"])
                       and named["graph"][q]["named"] == {"eval_attention_mma_kernel": n}
                       for q, n in implied.items())
            if same:
                break
            print(f"I1: kernels by name (fills left out) replayed "
                  f"{ {q: named['graph'][q]['named'] for q in implied} }, eager "
                  f"{ {q: named['eager'][q]['named'] for q in implied} }; unequal (name: "
                  f"replayed, eager) {_i1_unequal(named)} in profile {attempt + 1}; profiled "
                  f"again", flush=True)
        require(same, "I1: the kernels by name of a replayed add or search differ from an eager "
                      f"one's, or #1 from the {implied} the batches imply")
        _i1_bitwise("the profiled requests", g, e, {}, {})
    times = {r: {"add": [], "search": []} for r in routes}
    for pair in range(I1_PAIRS):  # in turns: graph then eager, then the reverse
        for route in (("graph", "eager"), ("eager", "graph"))[pair % 2]:
            index = idx[route]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.add(second, ids=_i1_ids(f"t{pair}-"))
            t1 = time.perf_counter()
            index.search(QUERIES, top_k=TOP_K, rerank=RERANK)
            t2 = time.perf_counter()
            times[route]["add"].append(1e3 * (t1 - t0))
            times[route]["search"].append(1e3 * (t2 - t1))
    require(g.capturer.captures == 3, "I1: the timed requests captured")
    med = {r: {q: float(np.median(v)) for q, v in t.items()} for r, t in times.items()}
    size = len(g)
    with deterministic_mode():
        row = _i1_new_weights(model, tok, g, second, g.video_emb[N_CLIPS:2 * N_CLIPS])
    print(f"I1: bitwise the eager route in deterministic mode (the first add of {N_CLIPS} clips "
          f"and searches of {N_QUERIES} queries, rerank 0 and {RERANK}: the eager first uses "
          f"and 3 captures; the second: replays {dict(g.replays)}, no capture; {row}); "
          f"kernels by name a request equal on both routes (fills and copies left out: "
          f"deterministic mode fills the inputs the eager route allocates at every call), #1 "
          f"{implied}", flush=True)
    for q in implied:
        print(f"I1 profile {q}: replayed {_profiled_text(named['graph'][q])}; eager "
              f"{_profiled_text(named['eager'][q])} (a request as one step, records short of "
              f"the fullest run {named['graph'][q]['lost']} and {named['eager'][q]['lost']})",
              flush=True)
    for q in ("add", "search"):
        what = (f"{N_CLIPS} clips in batches of {BATCH}" if q == "add" else
                f"{N_QUERIES} queries, top_k {TOP_K}, rerank {RERANK}")
        print(f"I1 {q} ({what}; default mode, {I1_PAIRS} alternating pairs, index "
              f"{size - N_CLIPS * I1_PAIRS} -> {size} clips): ms a request, graph "
              f"{[round(x, 3) for x in times['graph'][q]]} median {med['graph'][q]:.3f}, eager "
              f"{[round(x, 3) for x in times['eager'][q]]} median {med['eager'][q]:.3f} "
              f"({med['eager'][q] / med['graph'][q]:.3f}x); busy share (deterministic mode's "
              f"profile) graph {named['graph'][q]['share']:.4f}, eager "
              f"{named['eager'][q]['share']:.4f}; launches graph {named['graph'][q]['launches']}, "
              f"eager {named['eager'][q]['launches']}", flush=True)
    print(f"I1 first add and searches (graphs: the eager first uses and the captures, "
          f"{g.capturer.seconds:.3f} s of captures in all): "
          f"{ {r: round(v, 3) for r, v in first_ms.items()} } ms, peak device memory "
          f"{ {r: round(v, 3) for r, v in peak.items()} } GiB", flush=True)
    del idx, g, e, model
    torch.cuda.empty_cache()
    return {"ms": med, "peak_gib": peak}


def make_train_data(tmp: str, vocab: str, n_videos: int = TRAIN_VIDEOS):
    """YouCook2-format fixtures (S3D width 1024) and the dataset over them."""
    files = fixtures.make_youcook(os.path.join(tmp, f"youcook{n_videos}"), n_videos=n_videos,
                                  clips_per_video=TRAIN_CLIPS, video_dim=1024,
                                  seconds_per_video=TRAIN_SECONDS, seed=0)
    ds = YoucookRetrievalDataset(*files, WordPieceTokenizer(vocab), max_words=48, max_frames=48,
                                 seed=0)
    return files, ds


def _step_route(out: str, want: str = "graph") -> str:
    """The step route a CLI run recorded in its metrics.jsonl, required to
    start with ``want``."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        [mesh] = [r for r in map(json.loads, f) if r["kind"] == "mesh"]
    require(mesh["step_route"].startswith(want),
            f"{out}: step_route {mesh['step_route']!r}, not {want!r}")
    return mesh["step_route"]


def _launches_per_step(route: str, dtype: str = "bfloat16") -> dict:
    """What one training step launches on a route: #2 in every layer's
    attention, forward and backward (in bf16 its tensor-core kernels, in f32
    its CUDA-core ones: 48 and 96 positions fit the whole-head backward); on
    FT-Align's block route #4 and #5, on its pallas route #3, in every layer
    of the three towers (#3-#5 on their wgmma kernels in bf16, their
    CUDA-core kernels in f32)."""
    cfg = UniVLConfig.base(max_words=48, max_frames=48)
    layers = cfg.bert.num_hidden_layers + cfg.visual.num_hidden_layers
    if route != "ft_joint":
        layers += cfg.cross.num_hidden_layers
    suffix = "" if dtype == "bfloat16" else "_cuda_cores"
    want = {f"train_attention_fwd{suffix}": layers, f"train_attention_bwd{suffix}": layers}
    ffn_kernels = {"ft_joint": (), "ft_align_xla": (), "ft_align": ("ffn_block", "dense_block"),
                   "ft_align_pallas": ("ffn",)}[route]
    for name in ffn_kernels:
        want[f"{name}_fwd{suffix}"] = want[f"{name}_bwd{suffix}"] = layers
    return want


TRAIN_ROUTES = {  # route -> (label, extra flags)
    "ft_joint": ("FT-Joint", []),
    "ft_align_xla": ("FT-Align (--fused_ffn xla)", ["--train_sim_after_cross"]),
    "ft_align": ("FT-Align (--fused_ffn block)",
                 ["--train_sim_after_cross", "--fused_ffn", "block"]),
    "ft_align_pallas": ("FT-Align (--fused_ffn pallas)",
                        ["--train_sim_after_cross", "--fused_ffn", "pallas", "--n_display", "1"]),
}


def phase_train(tmp: str, vocab: str, files, route: str = "ft_joint") -> dict:
    """Retrieval training through the CLI at full width on a route; returns
    the kernels' launches."""
    label, extra = TRAIN_ROUTES[route]
    out = os.path.join(tmp, f"train_out_{route}")
    csv, data, feats = files
    argv = ["--do_train", "--device", "cuda", "--datatype", "youcook", "--vocab_file", vocab,
            "--train_csv", csv, "--data_path", data, "--features_path", feats,
            "--output_dir", out, *TRAIN_FLAGS, *extra]
    display = int(extra[extra.index("--n_display") + 1]) if "--n_display" in extra \
        else TRAIN_DISPLAY
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # still held by the earlier phases
    reset_launches()
    t0 = time.perf_counter()
    steps, _ = task_retrieval.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    loop_route = _step_route(out)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    shown = [r for r in records if r["kind"] == "train"]
    for r in shown:
        print(f"{label} train step {r['step']}: loss {r['loss']:.6f}", flush=True)
    require(all(math.isfinite(r["loss"]) for r in shown) and len(shown) == steps // display
            and len(shown) >= 2, f"display points {[(r['step'], r['loss']) for r in shown]}")
    # display points read the loss, so each is a synchronized host time
    first, last = shown[0], shown[-1]
    rate = (last["step"] - first["step"]) * TRAIN_BATCH / (last["ts"] - first["ts"])
    cfg = UniVLConfig.base(max_words=48, max_frames=48, train_sim_after_cross=route != "ft_joint")
    towers = (f"text {cfg.bert.num_hidden_layers} + visual {cfg.visual.num_hidden_layers}"
              + (f" + cross {cfg.cross.num_hidden_layers}" if route != "ft_joint" else ""))
    per_step = _launches_per_step(route)
    print(f"{label} training (CLI, bf16, batch {TRAIN_BATCH}, {towers} layers, step route "
          f"{loop_route}: one train_steps call a step, replays from the second): {steps} steps "
          f"in {wall:.3f} s including set-up; steady {rate:.3f} clips/s over steps "
          f"{first['step']}-{last['step']} (host clock between synchronized display points); "
          f"peak device memory {(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} "
          f"GiB held before the run; launches (counted by replay) {counts}, per step "
          f"{per_step}", flush=True)
    want = {**{k: 0 for k in KERNELS}, **{k: n * steps for k, n in per_step.items()}}
    require(counts == want, f"{label} launches {counts}, {steps} steps imply {want}")
    model = UniVL(cfg)
    sd = load_reference_bin(os.path.join(out, "pytorch_model.bin.0"))
    model.load_state_dict(sd, strict=True)
    require(all(bool(torch.isfinite(v).all()) for v in sd.values()), "non-finite saved weights")
    print(f"{label} pytorch_model.bin.0: {len(sd)} tensors, loads with strict=True, all finite",
          flush=True)
    return counts


_SEEDED = {}  # a parameter layout's seed-0 weights, drawn once for every phase that uses it


def seeded_weights(cfg, seed: int = 0) -> dict:
    """``init_state_dict(cfg, seed)``, drawn once for all the configs with
    the same parameters in the same order and the same initializer ranges
    (the draw depends on nothing else); callers copy it, never change it.
    main() makes it the CLIs' and the servers' ``init_state_dict`` too (their
    ``load_init_params`` copies what it returns into the model)."""
    layout = UniVL(cfg, device="meta").state_dict()
    key = (tuple((name, tuple(t.shape)) for name, t in layout.items()),
           tuple(c.initializer_range for c in (cfg.bert, cfg.visual, cfg.cross, cfg.decoder)),
           seed)
    if key not in _SEEDED:
        _SEEDED[key] = init_state_dict(cfg, seed=seed)
    return _SEEDED[key]


def _train_batches(ds, n: int, device, batch: int = TRAIN_BATCH) -> list:
    """The first n batches of the batcher's epochs 0, 1, ..., each [1, batch, ...]."""
    batcher = Batcher(ds, batch, seed=0, num_workers=8)
    out = []
    for epoch in range(n):
        for b in batcher.epoch(epoch):
            out.append({k: torch.from_numpy(v[None]).to(device) for k, v in b.items()})
            if len(out) == n:
                return out
    raise RuntimeError(f"fewer than {n} batches")


PROFILE_GROUPS = {  # label -> kernel-name needles, matched in this order
    "#1": TRACE_NAMES["eval_attention"],
    "#1, CUDA cores": TRACE_NAMES["eval_attention_cuda_cores"],
    "#2 forward": TRACE_NAMES["train_attention_fwd"],
    "#2 backward": TRACE_NAMES["train_attention_bwd"],
    "#2 forward, CUDA cores": TRACE_NAMES["train_attention_fwd_cuda_cores"],
    "#2 backward, CUDA cores": TRACE_NAMES["train_attention_bwd_cuda_cores"],
    "#2 backward, tiled (CUDA cores)": TRACE_NAMES["train_attention_bwd_tiled"],
    "#6 forward": ("layernorm_fwd_kernel",),
    "#6 backward": TRACE_NAMES["layernorm_bwd"],
    # on the block route #4's kernels, on the pallas route #3's (one body)
    "#3/#4 forward": TRACE_NAMES["ffn_block_fwd"],
    "#3/#4 backward": TRACE_NAMES["ffn_block_bwd"],
    "#3/#4, CUDA cores": ("ffn_fwd_kernel", "ffn_bwd_kernel", "ffn_block_fwd_kernel",
                          "ffn_block_bwd_kernel"),
    "#5 forward": TRACE_NAMES["dense_block_fwd"],
    "#5 backward": TRACE_NAMES["dense_block_bwd"],
    "#5, CUDA cores": ("dense_block_fwd_kernel", "dense_block_bwd_kernel"),
    "GEMMs": ("gemm", "nvjet", "xmma", "cutlass", "splitK"),
    "optimizer (foreach)": ("multi_tensor_apply", "foreach"),
}


def kernel_groups(kernels, n_units: int):
    """The kernels' time by PROFILE_GROUPS and the five largest of the rest:
    (text for the log, each group's ms per unit)."""
    kernel_ms = ms(kernels)
    parts, rest, groups = [], list(kernels), {}
    for group, needles in PROFILE_GROUPS.items():
        hit = [any(n in e["name"] for n in needles) for e in rest]
        mine = [e for e, h in zip(rest, hit) if h]
        rest = [e for e, h in zip(rest, hit) if not h]
        if mine:
            groups[group] = ms(mine) / n_units
            parts.append(f"{group} {ms(mine):.3f} ms in {len(mine)} "
                         f"({ms(mine) / kernel_ms:.4f} of kernel time)")
    parts.append(f"the rest {ms(rest):.3f} ms in {len(rest)}")
    top = {}
    for e in rest:
        top[e["name"][:60]] = top.get(e["name"][:60], 0.0) + e["dur"] / 1e3
    biggest = sorted(top.items(), key=lambda kv: -kv[1])[:5]
    return (f"kernel time over the window: {'; '.join(parts)}; largest of the rest: "
            f"{', '.join(f'{n} {t:.3f} ms' for n, t in biggest)}", groups)


def _agreement_run(cfg, sd, host, device: str, dtype: str, steps: int, fused_ln: bool = False):
    """The seeded weights in ``dtype`` on ``device``: (loss, gradients of the
    first batch, parameters after 2 BertAdam steps, losses of ``steps``
    steps, the first batch's dict of losses), all f32 on the CPU. A
    parameter off the loss's path gets a zero gradient."""
    model = UniVL(cfg.replace(compute_dtype=dtype), device=device)
    model.load_state_dict(sd, strict=True)
    set_fused_layer_norm(model, fused_ln)
    batches = [{k: v.to(device) for k, v in b.items()} for b in host[:steps]]
    out = model.train()({k: v[0] for k, v in batches[0].items()})
    out["loss"].backward()
    # copies: on the CPU .float().cpu() would return the live tensors
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).to(
        "cpu", torch.float32, copy=True) for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = make_univl_optimizer(model, lr=3e-5, t_total=AGREE_BF16_STEPS,
                               warmup_proportion=0.0, coef_lr=0.1)
    trainer = Trainer(model, opt, seed=0)
    losses, params = [], None
    for i, b in enumerate(batches):
        losses.append(float(trainer.train_step(b, i)["loss"]))
        if i == 1:
            params = {n: p.detach().to("cpu", torch.float32, copy=True)
                      for n, p in model.named_parameters()}
    return out["loss"].item(), grads, params, losses, {k: v.item() for k, v in out.items()}


def phase_train_agreement(ds, route: str = "ft_joint", control=None, f32_launches=None):
    """Card against CPU at full width, seeded weights, dropout 0: FT-Joint
    with text 2 + visual 1 layers at batch 32, or FT-Align with text 2 +
    visual 1 + cross 1 layers at batch 8 on the route's FFN kernels. f32
    loss, gradients and parameters after 2 BertAdam steps (warmup 0, so both
    steps move them); bf16 losses over AGREE_BF16_STEPS steps. The FT-Align
    xla route is the control: its worst gradient and parameter disagreement
    are returned, and ``control`` gives them to the kernel routes. The card's
    f32 launches go into ``f32_launches`` under the route's name (kept apart
    from the main paths' counts)."""
    align, is_control = route != "ft_joint", route == "ft_align_xla"
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    batch = AGREE_ALIGN_BATCH if align else TRAIN_BATCH
    cfg = UniVLConfig.base(text_num_hidden_layers=2, visual_num_hidden_layers=1,
                           cross_num_hidden_layers=1, max_words=48, max_frames=48,
                           batch_size_per_device=batch, train_sim_after_cross=align,
                           use_fused_ffn={"ft_joint": False, "ft_align_xla": False,
                                          "ft_align": "block", "ft_align_pallas": True}[route])
    cfg = cfg.replace(bert=cfg.bert.replace(**off), visual=cfg.visual.replace(**off),
                      cross=cfg.cross.replace(**off))
    sd = seeded_weights(cfg)
    host = _train_batches(ds, AGREE_BF16_STEPS, "cpu", batch)

    def run(device: str, dtype: str, steps: int):
        return _agreement_run(cfg, sd, host, device, dtype, steps)

    cpu = run("cpu", "float32", 2 if is_control else AGREE_BF16_STEPS)
    reset_launches()
    card = run("cuda", "float32", 2)
    counts = read_launches()
    ran = [k for k, n in _launches_per_step(route, "float32").items() if n]
    if f32_launches is not None:
        f32_launches[route] = counts
    require(all(counts[k] > 0 for k in ran),
            f"the card's f32 run did not launch the route's kernels {ran}: {counts}")
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    key, sim_bias = "attention.self.key.bias", "similarity_dense.bias"
    zero = (key, sim_bias) if align else (key,)
    floor = AGREE_GRAD_FLOOR * max(float(g.norm()) for g in cpu[1].values()) if align else 0.0

    def worst(a: dict, b: dict, floor: float = 0.0):
        return max((float((a[n] - b[n]).norm()) / max(float(b[n].norm()), floor), n) for n in b
                   if not n.endswith(zero))

    grad_rel = worst(card[1], cpu[1], floor)
    param_rel = worst(card[2], cpu[2])
    zero_grad = max(float(card[1][n].norm()) for n in card[1] if n.endswith(zero))
    zero_param = max(float((card[2][n] - cpu[2][n]).abs().max()) for n in cpu[2]
                     if n.endswith(zero))
    zero_limit = AGREE_ZERO_PARAM if align else AGREE_KEY_PARAM
    grad_limit, param_limit = AGREE_GRAD_RTOL, AGREE_PARAM_RTOL
    if control is not None:
        grad_limit = max(grad_limit, AGREE_CONTROL_FACTOR * control[0])
        param_limit = max(param_limit, AGREE_CONTROL_FACTOR * control[1])
    label = TRAIN_ROUTES[route][0]
    shape = (f"text 2 + visual 1 + cross 1 layers, batch {batch} ({batch * batch} pairs)"
             if align else f"text 2 + visual 1 layers, batch {batch}")
    limits = ("measured as the control" if is_control
              else f"limits {grad_limit:.3e} and {param_limit:.3e}")
    print(f"training agreement {label}, card f32 (kernels, TF32 off) vs CPU f32 (plain "
          f"versions), full width, {shape}, dropout 0: loss rel {loss_rel:.3e} (limit "
          f"{AGREE_LOSS_RTOL}); worst gradient rel to its norm{' or the floor' if align else ''} "
          f"{grad_rel[0]:.3e} ({grad_rel[1]}{f'; floor {floor:.3e}' if align else ''}); worst "
          f"parameter rel after 2 BertAdam steps {param_rel[0]:.3e} ({param_rel[1]}); {limits}; "
          f"zero-gradient parameters {zero}: gradient norm at most {zero_grad:.3e} (limit "
          f"{AGREE_ZERO_GRAD}), parameter difference at most {zero_param:.3e} (limit "
          f"{zero_limit}); card launches {counts}", flush=True)
    require(loss_rel <= AGREE_LOSS_RTOL and zero_grad <= AGREE_ZERO_GRAD
            and zero_param <= zero_limit, f"card f32 {label} training disagrees with the CPU")
    if is_control:
        return grad_rel[0], param_rel[0]
    require(grad_rel[0] <= grad_limit and param_rel[0] <= param_limit,
            f"card f32 {label} gradients or parameters disagree with the CPU")
    bf16 = run("cuda", "bfloat16", AGREE_BF16_STEPS)[3]
    rel = [abs(a - b) / abs(b) for a, b in zip(bf16, cpu[3])]
    print(f"training agreement {label}, card bf16 vs CPU f32 over {AGREE_BF16_STEPS} steps: "
          f"losses {[round(x, 6) for x in bf16]} vs {[round(x, 6) for x in cpu[3]]}; worst rel "
          f"{max(rel):.3e} (limit {LOSS_BF16_RTOL})", flush=True)
    require(all(math.isfinite(x) for x in bf16) and max(rel) <= LOSS_BF16_RTOL,
            f"card bf16 {label} training loss strays from the CPU's f32")
    return grad_rel[0], param_rel[0]


def make_caption_data(tmp: str, vocab: str):
    """YouCook2-format fixtures (S3D width 1024) of CAP_VIDEOS + CAP_VAL_VIDEOS
    videos with transcripts; the csv of the first CAP_VIDEOS (train), one of
    the rest (val), and the caption dataset over the train split."""
    csv, data, feats = fixtures.make_youcook(
        os.path.join(tmp, "caption"), n_videos=CAP_VIDEOS + CAP_VAL_VIDEOS,
        clips_per_video=TRAIN_CLIPS, video_dim=1024, seconds_per_video=TRAIN_SECONDS, seed=1)
    with open(csv) as f:
        header, *rows = f.read().splitlines()
    paths = {}
    for split, part in (("train", rows[:CAP_VIDEOS]), ("val", rows[CAP_VIDEOS:])):
        paths[split] = os.path.join(tmp, "caption", f"{split}.csv")
        with open(paths[split], "w") as f:
            f.write("\n".join([header, *part]) + "\n")
    ds = YoucookCaptionDataset(paths["train"], data, feats, WordPieceTokenizer(vocab),
                               max_words=CAP_WORDS, max_frames=CAP_FRAMES, seed=0)
    return (paths["train"], paths["val"], data, feats), ds


def _caption_cfg(**kw) -> UniVLConfig:
    return UniVLConfig.base(max_words=CAP_WORDS, max_frames=CAP_FRAMES, stage_two=True,
                            task_type="caption", **kw)


def _caption_launches_per_step(model) -> dict:
    """#2 in every attention over keys, forward and backward, on its
    tensor-core kernels at every length (text 128, visual 96, cross 224, the
    decoder's encoder attention 128 x 224), and #6 in every LayerNorm,
    forward and backward."""
    cfg, D = model.cfg, model.cfg.bert.hidden_size // model.cfg.bert.num_attention_heads
    W, Fr = CAP_WORDS, CAP_FRAMES
    attn = [(cfg.bert.num_hidden_layers, W, W), (cfg.visual.num_hidden_layers, Fr, Fr),
            (cfg.cross.num_hidden_layers, W + Fr, W + Fr),
            (cfg.decoder.num_decoder_layers, W, W + Fr)]
    require(all(ta.cuda_route(torch.bfloat16, D, lq, lk) == ta.TENSOR_CORES
                for _, lq, lk in attn), f"a bf16 caption head leaves the tensor cores: {attn}")
    n_attn = sum(n for n, _, _ in attn)
    n_ln = sum(isinstance(m, LayerNormTF) for m in model.modules())
    return {"train_attention_fwd": n_attn, "train_attention_bwd": n_attn,
            "layernorm_fwd": n_ln, "layernorm_bwd": n_ln}


def phase_caption_train(tmp: str, vocab: str, files) -> dict:
    """Caption fine-tuning through univl_tpu_torch.cli.task_caption --do_train
    --fused_ln at full width, then --do_eval of its pytorch_model.bin.0 over
    the val split; returns the two runs' launches."""
    train_csv, val_csv, data, feats = files
    out = os.path.join(tmp, "caption_out")
    common = ["--device", "cuda", "--stage_two", "--datatype", "youcook", "--vocab_file", vocab,
              "--train_csv", train_csv, "--val_csv", val_csv, "--data_path", data,
              "--features_path", feats, *CAP_FLAGS, "--fused_ln"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    steps, _ = task_caption.main(["--do_train", "--output_dir", out, *common])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    route = _step_route(out)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        shown = [r for r in map(json.loads, f) if r["kind"] == "train"]
    for r in shown:
        print(f"caption train step {r['step']}: loss {r['loss']:.6f}", flush=True)
    require(all(math.isfinite(r["loss"]) for r in shown) and len(shown) == steps // TRAIN_DISPLAY
            and len(shown) >= 2, f"display points {[(r['step'], r['loss']) for r in shown]}")
    first, last = shown[0], shown[-1]
    rate = (last["step"] - first["step"]) * CAP_BATCH / (last["ts"] - first["ts"])
    cfg = _caption_cfg()
    model = UniVL(cfg)
    sd = load_reference_bin(os.path.join(out, "pytorch_model.bin.0"))
    model.load_state_dict(sd, strict=True)
    require(all(bool(torch.isfinite(v).all()) for v in sd.values()), "non-finite saved weights")
    per_step = _caption_launches_per_step(model)
    print(f"caption training (CLI, --fused_ln, bf16, batch {CAP_BATCH}, {CAP_WORDS} words, "
          f"{CAP_FRAMES} frames, text {cfg.bert.num_hidden_layers} + visual "
          f"{cfg.visual.num_hidden_layers} + cross {cfg.cross.num_hidden_layers} + decoder "
          f"{cfg.decoder.num_decoder_layers} layers, step route {route}): {steps} steps in "
          f"{wall:.3f} s including set-up; steady {rate:.3f} clips/s over steps {first['step']}-{last['step']} (host "
          f"clock between synchronized display points); peak device memory "
          f"{(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held before the "
          f"run; launches (counted by replay) {counts}, per step {per_step}", flush=True)
    want = {**{k: 0 for k in KERNELS}, **{k: n * steps for k, n in per_step.items()}}
    require(counts == want, f"caption training launches {counts}, {steps} steps imply {want}")
    print(f"caption pytorch_model.bin.0: {len(sd)} tensors, loads with strict=True, all finite",
          flush=True)
    del model, sd

    reset_launches()
    t0 = time.perf_counter()
    _, metrics = task_caption.main(["--do_eval", "--fused_decode", "--fused_vocab",
                                    "--output_dir", os.path.join(tmp, "caption_eval"),
                                    "--init_model", os.path.join(out, "pytorch_model.bin.0"),
                                    *common])
    eval_counts = read_launches()
    with open(os.path.join(tmp, "caption_eval", "hyp.txt")) as f:
        hyps = f.read().split("\n")
    n_val = CAP_VAL_VIDEOS * TRAIN_CLIPS
    print(f"caption eval (CLI --do_eval, --fused_ln, beam 5, {n_val} clips) in "
          f"{time.perf_counter() - t0:.3f} s: {metrics}; first captions {hyps[:3]}; launches "
          f"{eval_counts}", flush=True)
    require(len(hyps) == n_val and all(isinstance(h, str) for h in hyps)
            and all(math.isfinite(metrics[k]) for k in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr")),
            f"caption eval: {len(hyps)} captions, metrics {metrics}")
    require(eval_counts["layernorm_fwd"] > 0 and eval_counts["eval_attention"] > 0
            and eval_counts["layernorm_bwd"] == 0,
            f"caption eval launches {eval_counts}")

    # the same eval with the classifier transform inside the vocab kernel
    reset_launches()
    t0 = time.perf_counter()
    _, metrics_cls = task_caption.main(["--do_eval", "--fused_decode", "--fused_vocab",
                                        "--fused_cls", "--output_dir",
                                        os.path.join(tmp, "caption_eval_cls"), "--init_model",
                                        os.path.join(out, "pytorch_model.bin.0"), *common])
    cls_counts = read_launches()
    with open(os.path.join(tmp, "caption_eval_cls", "hyp.txt")) as f:
        hyps_cls = f.read().split("\n")
    same = sum(a == b for a, b in zip(hyps, hyps_cls))
    print(f"caption eval with --fused_cls (CLI --do_eval, beam 5, {n_val} clips) in "
          f"{time.perf_counter() - t0:.3f} s: {metrics_cls}; {same} of {n_val} captions as "
          f"without it; launches {cls_counts}", flush=True)
    _require_fused_cls_steps(cls_counts, "caption eval --fused_cls (YouCook2)")
    require(len(hyps_cls) == n_val, f"{len(hyps_cls)} captions for {n_val} clips")
    return {"caption_train": counts, "caption_eval": eval_counts,
            "caption_eval_fused_cls": cls_counts}


def _require_fused_cls_steps(counts: dict, what: str) -> None:
    """A --fused_cls decode in bf16: #10t once (on the tensor-core tile
    kernel) and #9 three times a decode step, #10 and the CUDA-core route
    never."""
    steps = counts["vocab_topk_transform"]
    require(steps > 0 and counts["vocab_topk"] == 0
            and counts["vocab_topk_cuda_cores"] == counts["vocab_topk_transform_cuda_cores"] == 0
            and counts["beam_decode_self_attention"] == DECODER_LAYERS * steps,
            f"{what}: launches {counts}, want #10t once and #9 {DECODER_LAYERS} times a step")


def _graph_trainer(cfg, sd, accum: int = 1, mesh=None) -> Trainer:
    """A trainer of ``cfg`` on the card from the weights of ``sd`` it holds
    (stage I's are a subset of stage II's): BertAdam, or on ``mesh`` ZeRO-1."""
    model = UniVL(cfg, device="cuda")
    model.load_state_dict({k: sd[k] for k in model.state_dict()}, strict=True)
    opt = (make_univl_zero1_optimizer(model, mesh, **GRAPH_LR) if mesh is not None
           else make_univl_optimizer(model, **GRAPH_LR))
    return Trainer(model, opt, grad_accum_steps=accum, seed=0, mesh=mesh)


def _stacked(batches: list) -> dict:
    """[accum, B, ...] batches stacked into train_steps' [K, accum, B, ...]."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def _graph_bitwise(graph: Trainer, eager: Trainer, got: list, want: list) -> list:
    """What differs between the two trainers after the same steps: metrics,
    parameters, moments, step counts (empty when all is bitwise equal)."""
    off = [f"metric {k}" for k in want[0]
           if not torch.equal(torch.cat([g[k] for g in got]), torch.stack([w[k] for w in want]))]
    return off + _state_differs(graph, eager)


def _state_differs(graph: Trainer, eager: Trainer) -> list:
    """The step counts, parameters and moments that differ between two
    trainers (empty when all are bitwise equal)."""
    off = []
    if graph.optimizer.steps != eager.optimizer.steps:
        off.append(f"steps {graph.optimizer.steps} against {eager.optimizer.steps}")
    for (name, p), q in zip(graph.model.named_parameters(), eager.model.parameters()):
        if not torch.equal(p, q):
            off.append(name)
        sp, sq = graph.optimizer.state.get(p, {}), eager.optimizer.state.get(q, {})
        off += [f"{name} {k}" for k in ("m", "v") if (k in sp) != (k in sq)
                or (k in sp and not torch.equal(sp[k], sq[k]))]
    if isinstance(graph.optimizer, Zero1BertAdam):  # the shard's moments and f32 master
        off += [f"ZeRO-1 {k}" for k in ("m", "v", "master")
                if not torch.equal(getattr(graph.optimizer, k), getattr(eager.optimizer, k))]
    return off


# the kernels of #2, #4 and #5 by name (bf16): a replayed step must launch as
# many of each as an eager step
TRAIN_KERNEL_NAMES = tuple(sorted({n for k in ("train_attention_fwd", "train_attention_bwd",
                                               "ffn_block_fwd", "ffn_block_bwd",
                                               "dense_block_fwd", "dense_block_bwd")
                                    for n in TRACE_NAMES[k]}))


# torch.profiler (CUPTI) loses kernel records at the start of a session:
# late in the whole script a profile's first run came out 7-67 records short
# and its second whole, and the records an eager FT-Align --zero1 step lost
# held one of its 20 #2 forwards in 3 of 3 profiles. A profile runs its steps
# PROFILE_RUNS times, the card idle PROFILE_GAP_S before, between and after
# them, tells the runs apart by those gaps and keeps each kernel name's
# largest count over the runs (a lost record lowers a count, none adds one);
# a route takes up to PROFILE_ATTEMPTS profiles before its kernels by name
# must agree
PROFILE_GAP_S = 0.1
PROFILE_RUNS = 2
PROFILE_ATTEMPTS = 3


def _device_runs(prof, gap: float = PROFILE_GAP_S):
    """A profile's kernel names (copies and fills left out) in PROFILE_RUNS
    groups, split at its idle gaps of half ``gap`` or more; None where
    there are not PROFILE_RUNS - 1 such gaps (a run idled that long within)."""
    events = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA)
    cuts, end = [], None
    for i, (start, stop, _) in enumerate(events):
        if end is not None and start - end >= gap * 5e8:
            cuts.append(i)
        end = stop if end is None else max(end, stop)
    if len(cuts) != PROFILE_RUNS - 1:
        return None
    bounds = [0, *cuts, len(events)]
    return [[name for _, _, name in events[a:b] if not name.startswith(("Memcpy", "Memset"))]
            for a, b in zip(bounds, bounds[1:])]


def _profiled_steps(run, k: int, label: str, names=TRAIN_KERNEL_NAMES,
                    gap: float = PROFILE_GAP_S) -> dict:
    """``run(j)`` (k steps) for j < PROFILE_RUNS under one CUDA-only profiler,
    the card idle ``gap`` s before, between and after them: wall and
    device busy ms a step, the busy share, kernel launches a step, and the
    launches of each kernel of ``names`` in k steps (each count the
    largest over the runs; ``lost`` the records short of the fullest run;
    the counts None where the runs cannot be told apart); ``by_name`` every
    kernel name's count so, copies and fills left out."""
    from torch.profiler import ProfilerActivity, profile

    wall = 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for j in range(PROFILE_RUNS):
            time.sleep(gap)
            t0 = time.perf_counter()
            run(j)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        time.sleep(gap)
    busy = busy_seconds(prof, label)
    groups = _device_runs(prof, gap)
    out = {"wall_ms": 1e3 * wall / (k * PROFILE_RUNS),
           "busy_ms": 1e3 * busy / (k * PROFILE_RUNS),
           "share": busy / wall, "launches": None, "lost": None, "named": None, "by_name": None}
    if groups is not None:
        full = max(len(g) for g in groups)
        out.update(launches=full / k, lost=[full - len(g) for g in groups],
                   named={n: max(sum(n in name for name in g) for g in groups)
                          for n in names},
                   by_name={n: max(g.count(n) for g in groups)
                            for n in set().union(*map(set, groups))})
    return out


def _profiled_text(r: dict) -> str:
    launches = ("launches not counted (runs not told apart)" if r["launches"] is None
                else f"{r['launches']:.1f} kernel launches a step")
    return (f"wall {r['wall_ms']:.3f} ms a step, device busy {r['busy_ms']:.3f} ms a step "
            f"({r['share']:.4f} of wall), {launches}")


def _profile_routes(phase: str, label: str, replayed, eager, k: int) -> tuple:
    """``replayed(j, attempt)`` (k replayed steps) and ``eager(j, attempt)``
    (one eager step) profiled by ``_profiled_steps``, up to PROFILE_ATTEMPTS
    times, until #2's, #4's and #5's kernels by name come out as many a step
    in both (each name's largest count over the profiles), which is
    required; returns (the last profiles, those counts, the attempt)."""
    named = {"replayed": {}, "eager": {}}  # each name's largest count so far
    for attempt in range(PROFILE_ATTEMPTS):
        prof = {"replayed": _profiled_steps(lambda j: replayed(j, attempt), k,
                                            f"{phase} {label} replayed"),
                "eager": _profiled_steps(lambda j: eager(j, attempt), 1,
                                         f"{phase} {label} eager")}
        for side, r in prof.items():
            if r["named"] is not None:
                named[side] = {n: max(c / (k if side == "replayed" else 1), named[side].get(n, 0))
                               for n, c in r["named"].items()}
        if named["eager"] and named["replayed"] == named["eager"]:
            break
        print(f"{phase} {label}: #2's, #4's and #5's kernels a step, replayed "
              f"{named['replayed']} against eager {named['eager']} after profile {attempt + 1} "
              f"(records short of each profile's fullest run: replayed "
              f"{prof['replayed']['lost']}, eager {prof['eager']['lost']}; None: runs not told "
              f"apart); profiled again", flush=True)
    require(named["replayed"] == named["eager"] and all(named["eager"].get(n, 0) > 0 for n in (
        TRACE_NAMES["train_attention_fwd"] + TRACE_NAMES["train_attention_bwd"])),
        f"{phase} {label}: #2's, #4's and #5's kernels a step, replayed {named['replayed']} "
        f"against eager {named['eager']}")
    return prof, named, attempt


def phase_train_steps(ds) -> dict:
    """K1: Trainer.train_steps on its CUDA-graph route against the eager
    loop on FT-Joint at K1_K; returns the launches (counted by replay)."""
    cfg = UniVLConfig.base(max_words=48, max_frames=48, compute_dtype="bfloat16",
                           batch_size_per_device=TRAIN_BATCH)
    require(cfg.bert.hidden_dropout_prob == 0.1, f"K1: dropout {cfg.bert}")
    with deterministic_mode():
        r = _graph_route("K1", "FT-Joint, 48 words, 48 frames", cfg, seeded_weights(cfg),
                         _train_batches(ds, 2 * K1_K, "cuda", TRAIN_BATCH),
                         _launches_per_step("ft_joint"))
    return {"train_steps_ft_joint": r["counts"]}


def make_msrvtt_data(tmp: str):
    """MSRVTT-format fixtures at S3D width 1024, 48 frames a clip: the
    retrieval files (EVAL_CLIPS videos) and the caption files (EVAL_CAP_CLIPS
    videos with EVAL_REFS captions each, in the caption test layout)."""
    kw = dict(sentences_per_video=EVAL_REFS, video_dim=1024, frames=48)
    t0 = time.perf_counter()
    ret = fixtures.make_msrvtt(os.path.join(tmp, "msrvtt_ret"), n_videos=EVAL_CLIPS, seed=2, **kw)
    cap = fixtures.make_msrvtt(os.path.join(tmp, "msrvtt_cap"), n_videos=EVAL_CAP_CLIPS, seed=3,
                               caption_test_layout=True, **kw)
    print(f"MSRVTT fixtures: {EVAL_CLIPS} retrieval clips ({os.path.getsize(ret[3]) / 2**20:.1f} "
          f"MiB of features) and {EVAL_CAP_CLIPS} caption clips in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ret, cap


def _msrvtt_argv(files, vocab: str, out: str) -> list:
    train_csv, test_csv, json_path, feats = files
    return ["--do_eval", "--device", "cuda", "--datatype", "msrvtt", "--vocab_file", vocab,
            "--train_csv", train_csv, "--val_csv", test_csv, "--data_path", json_path,
            "--features_path", feats, "--output_dir", out, "--max_words", str(MAX_WORDS),
            "--max_frames", "48", "--seed", "0"]


def phase_caption_eval_msrvtt(tmp: str, vocab: str, files) -> dict:
    """task_caption --do_eval --fused_cls --datatype msrvtt at full width with
    the seeded weights: captions of the test split, scored against every
    reference of a clip."""
    out = os.path.join(tmp, "msrvtt_caption_eval")
    argv = _msrvtt_argv(files, vocab, out) + ["--fused_decode", "--fused_vocab", "--fused_cls",
                                              "--batch_size_val", "32"]
    reset_launches()
    t0 = time.perf_counter()
    _, metrics = task_caption.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    with open(os.path.join(out, "hyp.txt")) as f:
        hyps = f.read().split("\n")
    cfg = UniVLConfig.base(stage_two=True)
    per_batch = (cfg.bert.num_hidden_layers + cfg.visual.num_hidden_layers
                 + cfg.cross.num_hidden_layers)
    batches = -(-EVAL_CAP_CLIPS // 32)
    print(f"MSRVTT caption eval (CLI --do_eval --fused_cls, beam {BEAM}, batch 32, "
          f"{EVAL_CAP_CLIPS} clips x {EVAL_REFS} references, bf16) in {wall:.3f} s including "
          f"set-up ({EVAL_CAP_CLIPS / wall:.3f} clips/s): {metrics}; first captions {hyps[:2]}; "
          f"launches {counts}", flush=True)
    require(len(hyps) == EVAL_CAP_CLIPS and all(isinstance(h, str) for h in hyps)
            and all(math.isfinite(metrics[k]) for k in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr")),
            f"MSRVTT caption eval: {len(hyps)} captions, metrics {metrics}")
    _require_fused_cls_steps(counts, "MSRVTT caption eval")
    require(counts["eval_attention"] == per_batch * batches,
            f"eval_attention {counts['eval_attention']}, want {per_batch} x {batches} batches")
    return counts


def phase_retrieval_eval(tmp: str, vocab: str, files, mode: str) -> dict:
    """task_retrieval --do_eval --datatype msrvtt at full width with the seeded
    weights over EVAL_CLIPS clips: joint, or cross (--train_sim_after_cross:
    the device-resident FT-Align rescoring of every pair)."""
    out = os.path.join(tmp, f"msrvtt_retrieval_{mode}")
    argv = _msrvtt_argv(files, vocab, out) + ["--batch_size_val", str(EVAL_BATCH)]
    if mode == "cross":
        argv.append("--train_sim_after_cross")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    _, metrics = task_retrieval.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    cfg = UniVLConfig.base(train_sim_after_cross=True)
    tb, vb = 8, 64  # RetrievalEvaluator's blocks
    encode = -(-EVAL_CLIPS // EVAL_BATCH) * (cfg.bert.num_hidden_layers
                                             + cfg.visual.num_hidden_layers)
    cross = (-(-EVAL_CLIPS // tb) * -(-EVAL_CLIPS // vb) * cfg.cross.num_hidden_layers
             if mode == "cross" else 0)
    want = {**{k: 0 for k in KERNELS}, "eval_attention": encode + cross}
    rates = f"encode {EVAL_CLIPS / metrics['encode_s']:.3f} clips/s ({metrics['encode_s']:.3f} s)"
    if mode == "cross":
        rates += (f"; FT-Align rescoring {EVAL_CLIPS ** 2 / metrics['similarity_s']:.1f} pairs/s "
                  f"({EVAL_CLIPS ** 2} pairs in {metrics['similarity_s']:.3f} s, blocks of "
                  f"{tb} texts x {vb} videos: #1 at {[tb * vb, 12, 96, 64]})")
    print(f"MSRVTT retrieval eval ({mode}; CLI --do_eval, bf16, {EVAL_CLIPS} clips, 48 words, 48 "
          f"frames, batch {EVAL_BATCH}) in {wall:.3f} s including set-up: R@1 {metrics['R1']}, "
          f"R@5 {metrics['R5']}, R@10 {metrics['R10']}, MedR {metrics['MR']}, MeanR "
          f"{metrics['MeanR']}; {rates}; peak device memory {(peak - held) / 2**30:.3f} GiB "
          f"above the {held / 2**30:.3f} GiB held before; launches {counts}, the passes imply "
          f"{want}", flush=True)
    require(metrics["mode"] == mode and all(math.isfinite(metrics[k]) for k in
                                            ("R1", "R5", "R10", "MR", "MeanR")),
            f"retrieval eval ({mode}): {metrics}")
    require(counts == want, f"retrieval eval ({mode}) launches {counts}, want {want}")
    return counts, metrics


def phase_eval_profile(vocab: str, files, tmp: str) -> None:
    """torch.profiler over the retrieval eval's two device passes at full
    width in bf16 (seeded weights, FT-Align): the encode of one batch of
    EVAL_BATCH clips, and the rescoring of those clips against each other
    (8 stripes of one block of 8 texts x 64 videos): device busy share and
    the kernels' time by group."""
    from torch.profiler import ProfilerActivity, profile

    _, test_csv, _, feats = files
    cfg = UniVLConfig.base(max_words=MAX_WORDS, max_frames=48, train_sim_after_cross=True,
                           compute_dtype="bfloat16")
    model = UniVL(cfg, device="cuda")
    model.load_state_dict(seeded_weights(cfg), strict=True)
    ev = RetrievalEvaluator(model.eval(), batch_size=EVAL_BATCH)
    ds = MsrvttRetrievalEvalDataset(test_csv, feats, WordPieceTokenizer(vocab),
                                    max_words=MAX_WORDS, max_frames=48, seed=0)
    batch = collate([ds[i] for i in range(EVAL_BATCH)])
    passes = {"encode": lambda: ev.encode_dataset_device([batch]),
              "rescoring": lambda: ev.cross_sim_matrix_device(enc)}
    enc = passes["encode"]()
    for name, fn in passes.items():
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events, busy_us = device_events(prof, os.path.join(tmp, f"eval_{name}.json"), name)
        kernels = [e for e in events if e["cat"] == "kernel"]
        what = (f"{EVAL_BATCH} clips" if name == "encode"
                else f"{EVAL_BATCH ** 2} pairs in {EVAL_BATCH // 8} blocks of 512")
        text, _ = kernel_groups(kernels, 1)
        print(f"profile retrieval eval {name} ({what}, profiler on): wall {wall_ms:.3f} ms; "
              f"device busy {busy_us / 1e3:.3f} ms ({busy_us / 1e3 / wall_ms:.4f} of wall); "
              f"{len(kernels)} kernel launches; {text}", flush=True)


def phase_retrieval_agreement(vocab: str, files) -> None:
    """RetrievalEvaluator on the card in f32 (#1) against the CPU in f32 (its
    plain version), the same weights and clips, in both modes."""
    _, test_csv, _, feats = files
    cfg = UniVLConfig.base(max_words=MAX_WORDS, max_frames=48, train_sim_after_cross=True,
                           text_num_hidden_layers=2, visual_num_hidden_layers=1,
                           cross_num_hidden_layers=1)
    sd = seeded_weights(cfg)
    ds = MsrvttRetrievalEvalDataset(test_csv, feats, WordPieceTokenizer(vocab),
                                    max_words=MAX_WORDS, max_frames=48, seed=0)
    batch = collate([ds[i] for i in range(EVAL_AGREE_CLIPS)])
    sims = {}
    for dev in ("cpu", "cuda"):
        model = UniVL(cfg, device=dev)
        model.load_state_dict(sd, strict=True)
        ev = RetrievalEvaluator(model.eval(), batch_size=EVAL_AGREE_CLIPS)
        t0 = time.perf_counter()
        sims[dev] = {"joint": ev.joint_sim_matrix(ev.encode_dataset([batch], store_full=False)),
                     "cross": ev.cross_sim_matrix_device(ev.encode_dataset_device([batch]))}
        print(f"retrieval agreement: {dev} f32 similarity matrices in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del model
    for mode, limit in EVAL_AGREE_ATOL.items():
        card, cpu = sims["cuda"][mode], sims["cpu"][mode]
        err = float(np.abs(card - cpu).max())
        m_card, m_cpu = compute_retrieval_metrics(card), compute_retrieval_metrics(cpu)
        print(f"retrieval agreement ({mode}), card f32 vs CPU f32 at full width, text 2 + visual "
              f"1 + cross 1 layers, {EVAL_AGREE_CLIPS} clips: max |dsim| {err:.3e} (limit "
              f"{limit}; scores span {float(np.ptp(cpu)):.4f}); metrics card {m_card}, CPU "
              f"{m_cpu}", flush=True)
        require(np.isfinite(card).all() and card.shape == (EVAL_AGREE_CLIPS,) * 2,
                f"card similarity ({mode}) shape {card.shape}")
        require(err <= limit, f"retrieval agreement ({mode}): max |dsim| {err} > {limit}")
        require(m_card == m_cpu, f"retrieval agreement ({mode}): metrics differ")


def phase_caption_agreement(ds, f32_launches: dict) -> None:
    """Caption training, card against CPU at full width (text 2 + visual 1 +
    cross 1 + decoder 1 layers, batch 4, dropout 0), card f32 with and
    without --fused_ln, then card bf16 with it over AGREE_BF16_STEPS steps,
    all against one CPU f32 run (its plain LayerNorm is #6's plain version's
    math). The card's f32 launches go into ``f32_launches``."""
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg = _caption_cfg(text_num_hidden_layers=2, visual_num_hidden_layers=1,
                       cross_num_hidden_layers=1, decoder_num_hidden_layers=1,
                       batch_size_per_device=AGREE_CAP_BATCH)
    cfg = cfg.replace(bert=cfg.bert.replace(**off), visual=cfg.visual.replace(**off),
                      cross=cfg.cross.replace(**off), decoder=cfg.decoder.replace(**off))
    sd = seeded_weights(cfg)
    host = _train_batches(ds, AGREE_BF16_STEPS, "cpu", AGREE_CAP_BATCH)
    cpu = _agreement_run(cfg, sd, host, "cpu", "float32", AGREE_BF16_STEPS)
    zero = ("attention.self.key.bias", "att.key.bias")
    live = [n for n, g in cpu[1].items() if float(g.norm()) > 0 and not n.endswith(zero)]
    limits = (AGREE_GRAD_RTOL, AGREE_CAP_PARAM_RTOL)  # the control's
    for fused in (False, True):
        reset_launches()
        card = _agreement_run(cfg, sd, host, "cuda", "float32", 2, fused)
        counts = read_launches()
        f32_launches[f"caption{' --fused_ln' if fused else ''}"] = counts
        ran = ([k for k in F32_ROUTE if k.startswith("train_attention")]  # no #1 in training
               + (["layernorm_fwd", "layernorm_bwd"] if fused else []))
        require(all(counts[k] > 0 for k in ran) and (fused or counts["layernorm_fwd"] == 0),
                f"the card's f32 caption run launched {counts}")
        loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
        grad_rel = max((float((card[1][n] - cpu[1][n]).norm()) / float(cpu[1][n].norm()), n)
                       for n in live)
        param_rel = max((float((card[2][n] - cpu[2][n]).norm())  # zero biases off the path
                         / max(float(cpu[2][n].norm()), 1e-12), n)
                        for n in cpu[2] if not n.endswith(zero))
        idle = max(float(card[1][n].norm()) for n in cpu[1] if n not in live
                   and not n.endswith(zero))
        zero_grad = max(float(card[1][n].norm()) for n in card[1] if n.endswith(zero))
        zero_param = max(float((card[2][n] - cpu[2][n]).abs().max()) for n in cpu[2]
                         if n.endswith(zero))
        if fused:
            limits = (max(AGREE_GRAD_RTOL, AGREE_CAP_FUSED_FACTOR * limits[0]),
                      max(AGREE_PARAM_RTOL, AGREE_CAP_FUSED_FACTOR * limits[1]))
        print(f"caption training agreement, card f32 ({'--fused_ln' if fused else 'PyTorch '
              'LayerNorm, the control'}, TF32 off) vs CPU f32 (plain versions), full width, "
              f"text 2 + visual 1 + cross 1 + decoder 1 layers, batch {AGREE_CAP_BATCH}, dropout "
              f"0: loss rel {loss_rel:.3e} (limit {AGREE_LOSS_RTOL}); worst gradient rel to its "
              f"norm {grad_rel[0]:.3e} ({grad_rel[1]}; limit {limits[0]:.3e}); worst parameter "
              f"rel after 2 BertAdam steps {param_rel[0]:.3e} ({param_rel[1]}; limit "
              f"{limits[1]:.3e}); key biases: gradient norm at most {zero_grad:.3e} (limit "
              f"{AGREE_ZERO_GRAD}), parameter difference at most {zero_param:.3e} (limit "
              f"{AGREE_ZERO_PARAM}); parameters off the loss's path: gradient norm {idle:.3e}; "
              f"card launches {counts}", flush=True)
        require(loss_rel <= AGREE_LOSS_RTOL and grad_rel[0] <= limits[0]
                and param_rel[0] <= limits[1] and zero_grad <= AGREE_ZERO_GRAD
                and zero_param <= AGREE_ZERO_PARAM and idle == 0.0,
                f"card f32 caption training disagrees with the CPU (fused_ln {fused})")
        limits = (grad_rel[0], param_rel[0])  # the control's disagreement
    bf16 = _agreement_run(cfg, sd, host, "cuda", "bfloat16", AGREE_BF16_STEPS, True)[3]
    rel = [abs(a - b) / abs(b) for a, b in zip(bf16, cpu[3])]
    print(f"caption training agreement, card bf16 (--fused_ln) vs CPU f32 over "
          f"{AGREE_BF16_STEPS} steps: losses {[round(x, 6) for x in bf16]} vs "
          f"{[round(x, 6) for x in cpu[3]]}; worst rel {max(rel):.3e} (limit {LOSS_BF16_RTOL})",
          flush=True)
    require(all(math.isfinite(x) for x in bf16) and max(rel) <= LOSS_BF16_RTOL,
            "card bf16 caption training loss strays from the CPU's f32")


def phase_agreement(vocab: str, clips) -> None:
    """The card against the CPU with the same weights."""
    tok = WordPieceTokenizer(vocab)
    base = dict(max_words=MAX_WORDS, max_frames=48, stage_two=True, task_type="caption")
    cfg32 = UniVLConfig.base(**base)
    sd = seeded_weights(cfg32)
    models = {}
    for name, dev, dtype in (("cpu", "cpu", "float32"), ("card_bf16", "cuda", "bfloat16"),
                             ("card_f32", "cuda", "float32")):
        m = UniVL(cfg32.replace(compute_dtype=dtype), device=dev)
        m.load_state_dict(sd, strict=True)
        models[name] = (m.eval(), torch.device(dev))

    services = {}
    for name, (model, dev) in (("cpu", models["cpu"]), ("card_f32", models["card_f32"])):
        for cls in (False, True):  # on the CPU --fused_cls needs the vocab top-k's plain version
            services[name + ("_cls" if cls else "")] = CaptionService(
                model, tok, dev, beam_size=BEAM, batch_size=8, fused_vocab=True if cls else None,
                fused_cls=cls)
    require(services["card_f32"].fused_decode and services["card_f32"].fused_vocab,
            "the card's f32 caption service is not on the fused path")
    require(services["card_f32_cls"].fused_cls and services["cpu_cls"].fused_cls,
            "a --fused_cls caption service does not take the transform into the vocab kernel")

    # teacher-forced trajectory through the KV-cache decoder; with fused_cls the
    # step returns the raw hidden and #10t gives the top-5 of its logp
    n, steps = 8, MAX_WORDS - 1
    batch = services["cpu"]._build_batch(clips[:n], None)
    tokens = np.random.RandomState(4).randint(5, 30522, (n, steps))

    def trajectory(name: str, fused_cls: bool = False):
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
                h, cache = fd.step_fused(tok_t, t, cache, enc_kv, bias, identity, 1,
                                         return_hidden="raw" if fused_cls else False)
                if fused_cls:
                    logp, idx = vocab_topk.classify_topk(h, *fd.classifier_padded, BEAM,
                                                         transform=fd.cls_transform)
                    out.append((logp.cpu(), idx.cpu()))
                else:
                    out.append(torch.log_softmax(h, dim=-1).cpu())
        if fused_cls:
            return tuple(torch.stack(x) for x in zip(*out))
        return torch.stack(out)

    cpu = trajectory("cpu")
    card = trajectory("card_bf16")
    dlogp = float((card - cpu).abs().max())
    require(bool(torch.isfinite(card).all()), "non-finite logp on the card")
    print(f"agreement: teacher-forced {steps}-step trajectory of {n} clips through the KV-cache "
          f"decoder (decode-attention kernel, identity permutation), card bf16 vs CPU f32: max "
          f"|dlogp| {dlogp:.4e} over all {cpu.numel()} entries (limit {DLOGP_LIMIT})",
          flush=True)
    require(dlogp <= DLOGP_LIMIT, f"card vs CPU |dlogp| {dlogp} > {DLOGP_LIMIT}")
    logp_cls, idx_cls = trajectory("card_bf16", fused_cls=True)
    dlogp_cls = float((logp_cls - cpu.gather(2, idx_cls)).abs().max())
    top1 = float((idx_cls[..., 0] == cpu.argmax(dim=2)).float().mean())
    print(f"agreement: the same trajectory with --fused_cls (raw hidden, #10t), card bf16 top-"
          f"{BEAM} logp vs CPU f32 log_softmax at the card's tokens: max |dlogp| "
          f"{dlogp_cls:.4e} over {logp_cls.numel()} entries (limit {DLOGP_LIMIT}); top-1 the "
          f"CPU's argmax at {top1:.4f} of the steps", flush=True)
    require(bool(torch.isfinite(logp_cls).all()) and dlogp_cls <= DLOGP_LIMIT,
            f"--fused_cls card vs CPU |dlogp| {dlogp_cls} > {DLOGP_LIMIT}")

    # top-beam captions of 8 clips, card f32 (its kernels) vs CPU f32 (plain
    # versions), with the transform outside and inside the vocab kernel
    captions = {name: svc.caption(clips[:8]) for name, svc in services.items()}
    for suffix, what in (("", "fused kernels"), ("_cls", "--fused_cls, #10t")):
        same = sum(a == b for a, b in zip(captions["cpu" + suffix],
                                          captions["card_f32" + suffix]))
        print(f"agreement: top-beam captions of 8 clips, card f32 ({what}) vs CPU f32 (plain "
              f"versions): {same} of 8 the same (at least {SAME_CAPTIONS_MIN} required)",
              flush=True)
        require(same >= SAME_CAPTIONS_MIN, f"only {same} of 8 captions agree ({what})")


def make_pretrain_data(tmp: str):
    """HowTo100M-format fixtures at S3D width 1024 (one .npy of features a
    video); the csv of all PRE_VIDEOS (stage I) and one of the first
    PRE2_VIDEOS (stage II)."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "howto100m")
    csv, data, feats = fixtures.make_howto100m(root, n_videos=PRE_VIDEOS,
                                               clips_per_video=PRE_CLIPS, video_dim=1024,
                                               seconds_per_video=PRE_SECONDS, seed=3,
                                               corrupt_last=False)
    with open(csv) as f:
        lines = f.read().splitlines()
    csv2 = os.path.join(root, "howto100m_stage2.csv")
    with open(csv2, "w") as f:
        f.write("\n".join(lines[: PRE2_VIDEOS + 1]) + "\n")
    print(f"HowTo100M fixtures: {PRE_VIDEOS} videos x {PRE_CLIPS} clips, {PRE_SECONDS} s of "
          f"1024-wide features each, written in {time.perf_counter() - t0:.1f} s", flush=True)
    return csv, csv2, data, feats


def _pretrain_argv(files, vocab: str, out: str, stage: int, *extra) -> list:
    csv1, csv2, data, feats = files
    clips, accum = (PRE1_CLIPS, PRE1_ACCUM) if stage == 1 else (PRE2_CLIPS, PRE2_ACCUM)
    argv = ["--do_pretrain", "--device", "cuda", "--vocab_file", vocab,
            "--train_csv", csv1 if stage == 1 else csv2, "--data_path", data,
            "--features_path", feats, "--output_dir", out, "--batch_size", str(clips * accum),
            "--gradient_accumulation_steps", str(accum), *PRE_FLAGS]
    if stage == 2:
        argv += ["--stage_two", "--pretrain_enhance_vmodal", "--fused_ffn", "block"]
    return argv + list(extra)


def _pretrain_cfg(stage: int, **kw) -> UniVLConfig:
    return UniVLConfig.base(max_words=PRE_WORDS, max_frames=PRE_FRAMES, n_pair=PRE_PAIRS,
                            use_mil=True, sampled_use_mil=True, do_pretrain=True,
                            stage_two=stage == 2, **kw)


def _pretrain_launches_per_step(stage: int) -> dict:
    """What one update step launches, from the layer counts: #2 in every
    attention over keys, forward and backward. Stage I: the text and visual
    towers. Stage II: both towers twice (the clean and the masked input),
    the cross tower three times (the masked encode's, the decoder's, and
    the cross similarity's over all pairs) and the decoder's encoder
    attention (its causal self-attention is PyTorch's SDPA, as JAX's is
    XLA's); #4 and #5 in every layer of the three towers' runs (the
    decoder's FFN is unfused). Every head on the tensor cores."""
    cfg = _pretrain_cfg(stage)
    t, v = cfg.bert.num_hidden_layers, cfg.visual.num_hidden_layers
    c, d = cfg.cross.num_hidden_layers, cfg.decoder.num_decoder_layers
    W, Fr, L = PRE_WORDS, PRE_FRAMES, PRE_WORDS + PRE_FRAMES
    if stage == 1:
        heads, accum, ffn_layers = [(t, W, W), (v, Fr, Fr)], PRE1_ACCUM, 0
    else:
        heads = [(2 * t, W, W), (2 * v, Fr, Fr), (3 * c, L, L), (d, W, L)]
        accum, ffn_layers = PRE2_ACCUM, 2 * t + 2 * v + 3 * c
    require(all(ta.cuda_route(torch.bfloat16, TA_D, lq, lk) == ta.TENSOR_CORES
                for _, lq, lk in heads), f"a bf16 pretraining head leaves the tensor cores")
    n = sum(k for k, _, _ in heads) * accum
    want = {"train_attention_fwd": n, "train_attention_bwd": n}
    for name in ("ffn_block_fwd", "ffn_block_bwd", "dense_block_fwd", "dense_block_bwd"):
        if ffn_layers:
            want[name] = ffn_layers * accum
    return want


def _train_losses(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train"]


def phase_pretrain(tmp: str, vocab: str, files, stage: int, init: str = None):
    """Pretraining through univl_tpu_torch.cli.pretrain at full width, bf16
    (stage II from ``init``, stage I's last .bin); returns (the kernels'
    launches, the output dir)."""
    out = os.path.join(tmp, f"pretrain_stage{stage}")
    argv = _pretrain_argv(files, vocab, out, stage, *(["--init_model", init] if init else []))
    clips, accum = (PRE1_CLIPS, PRE1_ACCUM) if stage == 1 else (PRE2_CLIPS, PRE2_ACCUM)
    per_step = _pretrain_launches_per_step(stage)
    cfg = _pretrain_cfg(stage)
    layers = (f"text {cfg.bert.num_hidden_layers} + visual {cfg.visual.num_hidden_layers}"
              + (f" + cross {cfg.cross.num_hidden_layers} + decoder "
                 f"{cfg.decoder.num_decoder_layers}" if stage == 2 else ""))
    print(f"pretraining stage {'I' * stage} (CLI, bf16, {layers} layers, {clips} clips x "
          f"{PRE_PAIRS} pairs = {clips * PRE_PAIRS} rows a micro-step, accumulation {accum}): "
          f"launches required a step, from the layer counts: {per_step}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    steps, _ = pretrain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    route = _step_route(out)
    shown = _train_losses(out)
    names = [k for k in shown[0] if "loss" in k]
    for r in shown:
        print(f"pretraining stage {'I' * stage} step {r['step']} (epoch {r['epoch'] + 1}): "
              + ", ".join(f"{k} {r[k]:.6f}" for k in names), flush=True)
    require(steps == 4 and [r["step"] for r in shown] == [1, 2, 3, 4]
            and all(math.isfinite(r[k]) for r in shown for k in names),
            f"display points {[(r['step'], r['loss']) for r in shown]}")
    # display points read the losses, so each is a synchronized host time; the
    # steady rate leaves out the interval over the epoch's end (its saves)
    inside = [(a, b) for a, b in zip(shown, shown[1:]) if a["epoch"] == b["epoch"]]
    rate = len(inside) * clips * accum / sum(b["ts"] - a["ts"] for a, b in inside)
    print(f"pretraining stage {'I' * stage} (step route {route}): {steps} steps in {wall:.3f} s "
          f"including set-up and the epoch-end saves; steady {rate:.3f} clips/s ({rate * PRE_PAIRS:.3f} pairs/s) over "
          f"the steps within an epoch (host clock between synchronized display points); peak "
          f"device memory {(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held "
          f"before the run; launches (counted by replay) {counts}", flush=True)
    want = {**{k: 0 for k in KERNELS}, **{k: n * steps for k, n in per_step.items()}}
    require(counts == want, f"pretraining stage {stage} launches {counts}, {steps} steps imply "
                            f"{want}")
    sd = load_reference_bin(os.path.join(out, "pytorch_model.bin.1"))
    UniVL(cfg, device="meta").load_state_dict(sd, strict=True, assign=True)
    heads = sorted(k for k in sd if k.startswith(("cls.predictions.", "cls_visual.predictions.")))
    require(all(bool(torch.isfinite(v).all()) for v in sd.values()), "non-finite saved weights")
    require((len(heads) == 10) == (stage == 2), f"stage {stage} heads {heads}")
    print(f"pretraining stage {'I' * stage} pytorch_model.bin.1: {len(sd)} tensors, loads with "
          f"strict=True, all finite; heads {heads}", flush=True)
    return counts, out


def _pretrain_dataset(files, vocab: str, stage: int = 2) -> HowTo100MPretrainDataset:
    csv1, csv2, data, feats = files
    with open(data, "rb") as f:
        data_dict = pickle.load(f)
    return HowTo100MPretrainDataset(
        csv2 if stage == 2 else csv1, data_dict, feats, WordPieceTokenizer(vocab),
        max_words=PRE_WORDS, max_frames=PRE_FRAMES, min_time=5.0, n_pair=PRE_PAIRS,
        only_sim=stage == 1, sampled_use_mil=True, pretrain_enhance_vmodal=stage == 2,
        video_dim=1024, seed=0)


def _state_diff(a: str, b: str) -> dict:
    """The largest |difference| of two runs' final train states (parameters,
    moments) and per-step losses, BertAdam's step counts, whether the
    displayed steps agree, and the parameters that differ."""
    sa, _ = restore_checkpoint(os.path.join(a, "train_state.pt"))
    sb, _ = restore_checkpoint(os.path.join(b, "train_state.pt"))

    def worst(x: dict, y: dict):
        return max((float((x[k].float() - y[k].float()).abs().max()), k) for k in x)

    moments = {f"{i}.{key}": st[key] for i, st in sa["optimizer"]["state"].items()
               for key in ("m", "v")}
    moments_b = {f"{i}.{key}": st[key] for i, st in sb["optimizer"]["state"].items()
                 for key in ("m", "v")}
    la, lb = _train_losses(a), _train_losses(b)
    return {"params": worst(sa["model"], sb["model"]), "moments": worst(moments, moments_b),
            "steps": (sa["optimizer"]["steps"], sb["optimizer"]["steps"]),
            "losses": max(abs(x["loss"] - y["loss"]) for x, y in zip(la, lb)),
            "same_steps": [x["step"] for x in la] == [y["step"] for y in lb],
            "differing": [k for k, v in sa["model"].items() if not torch.equal(v, sb["model"][k])]}


def _bitwise(resumed: dict) -> bool:
    """P3's limit: the resumed run bitwise the uninterrupted one."""
    return (resumed["same_steps"] and resumed["steps"][0] == resumed["steps"][1] == 4
            and resumed["params"][0] == resumed["moments"][0] == resumed["losses"] == 0.0)


def phase_pretrain_resume(tmp: str, vocab: str, files) -> None:
    """P3: stage I at full width, 4 steps over 2 epochs, under
    torch.use_deterministic_algorithms: an uninterrupted run (the control)
    and one preempted after PRE_PREEMPT_AFTER steps (--inject_preempt_after)
    and resumed (--load_checkpoint) with the train state written on a thread
    (R3, --async_checkpointing), bitwise the control; the seconds each
    epoch-end save held the loop, synchronous (the control) and async. Two
    default-mode controls (their difference named the embedding backward's
    atomics) and a second deterministic one, bitwise the first in every run,
    were cut for D1-D3; the synchronous preempted and resumed pair, for T1
    and T2 (D2 resumes with a synchronous save on the card)."""

    def run(name: str, *extra):
        out = os.path.join(tmp, f"pretrain_resume_{name}")
        return pretrain.main(_pretrain_argv(files, vocab, out, 1, *extra))[0], out

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        _, a = run("deterministic")
        # R3: preempted and resumed, the train state written on a thread
        ka, _ = run("async", "--async_checkpointing", "--inject_preempt_after",
                    str(PRE_PREEMPT_AFTER))
        na, ca = run("async", "--async_checkpointing", "--load_checkpoint")
        resumed_async = _state_diff(a, ca)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"pretraining resume, torch.use_deterministic_algorithms (stage I, full width, 4 steps "
          f"over 2 epochs) in {time.perf_counter() - t0:.1f} s for the three runs", flush=True)

    def blocked(out: str, preempted: bool) -> list:
        with open(os.path.join(out, "metrics.jsonl")) as f:
            return [round(r["blocked_seconds"], 4) for r in map(json.loads, f)
                    if r["kind"] == "checkpoint" and r["preempted"] == preempted]

    print(f"R3 --async_checkpointing (preempted after {ka} step(s), resumed to step {na}): "
          f"differs from the control by {resumed_async} (limit: bitwise); seconds the loop "
          f"blocked at the epoch-end saves of ~2.4 GB: synchronous {blocked(a, False)}, async "
          f"{blocked(ca, False)}; at the preemption's save: async {blocked(ca, True)}",
          flush=True)
    require(ka == PRE_PREEMPT_AFTER and na == 4 and _bitwise(resumed_async),
            f"P3/R3: the resumed run strays from the uninterrupted one: {resumed_async}")
    for out in (a, ca):
        shutil.rmtree(out)


def phase_pretrain_agreement(files, vocab: str, f32_launches: dict) -> None:
    """P4: stage II, card against CPU at full width, text 2 + visual 1 +
    cross 1 + decoder 1 layers, PRE_AGREE_CLIPS clips x 3 pairs, dropout 0:
    card f32 on the unfused route (the control) and on --fused_ffn block
    against one CPU f32 run, then card bf16 on the block route over
    AGREE_BF16_STEPS steps; the limits stated at PRE_AGREE_CLIPS."""
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg = _pretrain_cfg(2, text_num_hidden_layers=2, visual_num_hidden_layers=1,
                        cross_num_hidden_layers=1, decoder_num_hidden_layers=1,
                        batch_size_per_device=PRE_AGREE_CLIPS)
    cfg = cfg.replace(bert=cfg.bert.replace(**off), visual=cfg.visual.replace(**off),
                      cross=cfg.cross.replace(**off), decoder=cfg.decoder.replace(**off))
    sd = seeded_weights(cfg)
    host = _train_batches(_pretrain_dataset(files, vocab), AGREE_BF16_STEPS, "cpu",
                          PRE_AGREE_CLIPS)
    cpu = _agreement_run(cfg, sd, host, "cpu", "float32", AGREE_BF16_STEPS)
    zero = ("attention.self.key.bias", "att.key.bias", "similarity_dense.bias")
    floor = AGREE_GRAD_FLOOR * max(float(g.norm()) for g in cpu[1].values())

    def worst(a: dict, b: dict, floor: float = 0.0):
        return max((float((a[n] - b[n]).norm()) / max(float(b[n].norm()), floor, 1e-30), n)
                   for n in b if not n.endswith(zero))

    control = None
    for route in (False, "block"):
        label = "--fused_ffn block" if route else "--fused_ffn xla, the control"
        reset_launches()
        card = _agreement_run(cfg.replace(use_fused_ffn=route), sd, host, "cuda", "float32", 2)
        counts = read_launches()
        f32_launches[f"pretrain stage II ({label})"] = counts
        ran = ["train_attention_fwd_cuda_cores"] + (
            [f"{n}_cuda_cores" for n in ("ffn_block_fwd", "ffn_block_bwd", "dense_block_fwd",
                                         "dense_block_bwd")] if route else [])
        require(all(counts[k] > 0 for k in ran)
                and counts["train_attention_bwd_cuda_cores"] + counts[
                    "train_attention_bwd_tiled"] > 0,
                f"the card's f32 pretraining run launched {counts}")
        loss_rel = {k: abs(card[4][k] - cpu[4][k]) / abs(cpu[4][k]) for k in cpu[4]}
        grad_rel, param_rel = worst(card[1], cpu[1], floor), worst(card[2], cpu[2])
        zero_grad = max(float(card[1][n].norm()) for n in card[1] if n.endswith(zero))
        zero_param = max(float((card[2][n] - cpu[2][n]).abs().max()) for n in cpu[2]
                         if n.endswith(zero))
        limits = None if control is None else (
            max(AGREE_GRAD_RTOL, AGREE_CONTROL_FACTOR * control[0]),
            max(AGREE_PARAM_RTOL, AGREE_CONTROL_FACTOR * control[1]))
        limit_text = ("measured as the control" if limits is None
                      else f"limits {limits[0]:.3e} and {limits[1]:.3e}")
        print(f"pretraining stage II agreement, card f32 ({label}, TF32 off) vs CPU f32 (plain "
              f"versions), full width, text 2 + visual 1 + cross 1 + decoder 1 layers, "
              f"{PRE_AGREE_CLIPS} clips x {PRE_PAIRS} pairs, dropout 0: losses rel "
              f"{ {k: float(f'{v:.3e}') for k, v in loss_rel.items()} } (limit "
              f"{AGREE_LOSS_RTOL}); worst gradient rel to its norm or the floor "
              f"{grad_rel[0]:.3e} ({grad_rel[1]}; floor {floor:.3e}); worst parameter rel after "
              f"2 BertAdam steps {param_rel[0]:.3e} ({param_rel[1]}); "
              f"{limit_text}; "
              f"zero-gradient parameters {zero}: gradient norm at most {zero_grad:.3e} (limit "
              f"{AGREE_ZERO_GRAD}), parameter difference at most {zero_param:.3e} (limit "
              f"{AGREE_ZERO_PARAM}); card launches {counts}", flush=True)
        require(max(loss_rel.values()) <= AGREE_LOSS_RTOL and zero_grad <= AGREE_ZERO_GRAD
                and zero_param <= AGREE_ZERO_PARAM,
                f"card f32 pretraining ({label}) disagrees with the CPU")
        if limits is not None:
            require(grad_rel[0] <= limits[0] and param_rel[0] <= limits[1],
                    f"card f32 pretraining ({label}) gradients or parameters disagree with "
                    f"the CPU")
        control = (grad_rel[0], param_rel[0])
    bf16 = _agreement_run(cfg.replace(use_fused_ffn="block"), sd, host, "cuda", "bfloat16",
                          AGREE_BF16_STEPS)[3]
    rel = [abs(a - b) / abs(b) for a, b in zip(bf16, cpu[3])]
    print(f"pretraining stage II agreement, card bf16 (--fused_ffn block) vs CPU f32 over "
          f"{AGREE_BF16_STEPS} steps: losses {[round(x, 6) for x in bf16]} vs "
          f"{[round(x, 6) for x in cpu[3]]}; worst rel {max(rel):.3e} (limit {LOSS_BF16_RTOL})",
          flush=True)
    require(all(math.isfinite(x) for x in bf16) and max(rel) <= LOSS_BF16_RTOL,
            "card bf16 pretraining loss strays from the CPU's f32")


def _remat_launches(cfg, remat) -> dict:
    """One micro-step's launches of #2, #4 and #5 from the layer counts: every
    tower layer's attention, dense block and FFN block (FT-Align: text,
    visual, cross; stage II: both towers twice and the cross tower three
    times), and stage II's decoder's encoder attention, which is not
    rematerialized; with remat each tower layer's forward kernels run twice."""
    t, v = cfg.bert.num_hidden_layers, cfg.visual.num_hidden_layers
    c, d = cfg.cross.num_hidden_layers, cfg.decoder.num_decoder_layers
    towers, decoder = (2 * t + 2 * v + 3 * c, d) if cfg.do_pretrain else (t + v + c, 0)
    again = towers if remat else 0
    want = {"train_attention_fwd": towers + decoder + again,
            "train_attention_bwd": towers + decoder}
    for name in ("ffn_block", "dense_block"):
        want[f"{name}_fwd"], want[f"{name}_bwd"] = towers + again, towers
    return want


def _remat_run(label: str, cfg, sd, batches, remat, reference=None) -> dict:
    """One remat mode: the check steps in deterministic mode (losses,
    launches, peak memory, the parameters after them against
    ``reference``'s), then the timed and the profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = UniVL(cfg.replace(remat=remat), device="cuda")
    model.load_state_dict(sd, strict=True)
    opt = make_univl_optimizer(model, lr=1e-4, t_total=40, warmup_proportion=0.1, coef_lr=0.1)
    trainer = Trainer(model, opt, seed=0)
    reset_launches()
    torch.use_deterministic_algorithms(True)
    try:
        losses = [{k: float(v) for k, v in trainer.train_step(batches[i], i).items()}
                  for i in range(REMAT_CHECK_STEPS)]
    finally:
        torch.use_deterministic_algorithms(False)
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() - held
    params = {n: p.detach() for n, p in model.named_parameters()}
    if reference is None:
        params = {n: p.clone() for n, p in params.items()}
        differing = []
    else:
        differing = [n for n, p in params.items() if not torch.equal(p, reference["params"][n])]
    steps = range(REMAT_CHECK_STEPS, REMAT_CHECK_STEPS + REMAT_TIMED_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in steps:
        trainer.train_step(batches[i % len(batches)], i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / REMAT_TIMED_STEPS
    first = REMAT_CHECK_STEPS + REMAT_TIMED_STEPS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + REMAT_PROFILE_STEPS):
            trainer.train_step(batches[i % len(batches)], i)
        torch.cuda.synchronize()
    busy = busy_seconds(prof, f"R1 {label} remat={remat}")
    del trainer, opt, model
    return {"losses": losses, "counts": counts, "peak_gib": peak / 2**30, "wall_ms": 1e3 * wall,
            "busy_ms": 1e3 * busy / REMAT_PROFILE_STEPS, "params": params,
            "differing": differing}


def phase_remat(ds, pre_files, vocab: str) -> tuple:
    """R1: P2's stage-II micro-step and phase 13's FT-Align step without
    remat, with remat=True and with "dots"; returns each run's launches by
    path and each route's (config, dataset, clips, seeded weights), which K2
    reuses."""
    configs = {
        "stage II": (_pretrain_cfg(2, compute_dtype="bfloat16", batch_size_per_device=PRE2_CLIPS,
                                   use_fused_ffn="block"), _pretrain_dataset(pre_files, vocab),
                     PRE2_CLIPS),
        "FT-Align": (UniVLConfig.base(max_words=48, max_frames=48, compute_dtype="bfloat16",
                                      batch_size_per_device=TRAIN_BATCH,
                                      train_sim_after_cross=True, use_fused_ffn="block"),
                     ds, TRAIN_BATCH),
    }
    by_path, inits = {}, {}
    for label, (cfg, data, batch) in configs.items():
        sd = seeded_weights(cfg)
        batches = _train_batches(data, REMAT_CHECK_STEPS + REMAT_TIMED_STEPS, "cuda", batch)
        reference = None
        for remat in REMAT_MODES:
            r = _remat_run(label, cfg, sd, batches, remat, reference)
            per_step = _remat_launches(cfg, remat)
            want = {**{k: 0 for k in KERNELS},
                    **{k: n * REMAT_CHECK_STEPS for k, n in per_step.items()}}
            mode = REMAT_FLAGS
            print(f"R1 remat, {label} ({batch} clips a step, bf16, {mode[remat]}): peak device "
                  f"memory {r['peak_gib']:.3f} GiB (parameters, gradients and moments "
                  f"included); wall {r['wall_ms']:.3f} ms a step, {1e3 * batch / r['wall_ms']:.3f} "
                  f"clips/s over {REMAT_TIMED_STEPS} steps; device busy {r['busy_ms']:.3f} ms a "
                  f"step over {REMAT_PROFILE_STEPS} profiled; losses of the "
                  f"{REMAT_CHECK_STEPS} deterministic steps {r['losses']}; launches a step "
                  f"{per_step} (from the layer counts), {REMAT_CHECK_STEPS} steps gave "
                  f"{ {k: v for k, v in r['counts'].items() if v} }", flush=True)
            require(r["counts"] == want, f"R1 {label} {mode[remat]}: launches {r['counts']}, "
                                         f"the layer counts imply {want}")
            if reference is None:
                reference = r
            else:
                require(r["losses"] == reference["losses"] and not r["differing"],
                        f"R1 {label} {mode[remat]}: not bitwise the run without remat: losses "
                        f"{r['losses']} against {reference['losses']}, parameters that differ "
                        f"{r['differing'][:8]}")
                print(f"R1 remat, {label}, {mode[remat]}: the losses and all {len(r['params'])} "
                      f"parameters after {REMAT_CHECK_STEPS} steps bitwise those without remat",
                      flush=True)
            by_path[f"remat_{label.replace(' ', '_').replace('-', '_').lower()}_{remat}"] = \
                r["counts"]
        del reference
        inits[label] = (cfg, data, batch, sd)
    return by_path, inits


def _k2_steps(ds, n: int, clips: int, accum: int) -> list:
    """n step batches of ``accum`` micro-batches of ``clips`` clips, [accum,
    clips, ...] on the card."""
    micro = _train_batches(ds, n * accum, "cuda", clips)
    return [{k: torch.cat([m[k] for m in micro[i:i + accum]]) for k in micro[0]}
            for i in range(0, len(micro), accum)]


def _graph_route(phase: str, label: str, cfg, sd, steps: list, per_step: dict,
                 mesh=None) -> dict:
    """One route of K1 or K2 (``phase``), in the caller's deterministic
    mode: two train_steps calls of K = len(steps) / 2 (the first runs the
    eager step and the capture, the second replays) against 2K train_step
    calls of another trainer, bitwise; the wrappers' counts by replay 2K
    times ``per_step``; PROFILE_RUNS more calls and eager steps profiled
    (``_profile_routes``), #2's, #4's and #5's kernels as many a step in
    both. Prints clips/s of the second call and of the last K eager steps,
    peak memory and the profiles; returns both trainers, their batches,
    those rates and the counts."""
    k, accum = len(steps) // 2, steps[0]["video"].shape[0]
    clips = steps[0]["video"].shape[1] * accum
    stacks = [_stacked(steps[:k]), _stacked(steps[k:])]

    def timed(fn) -> tuple:  # fn's result and the clips/s of its k steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, k * clips / (time.perf_counter() - t0)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    graph = _graph_trainer(cfg, sd, accum, mesh)
    got = [graph.train_steps(stacks[0], 0)]
    second, graph_rate = timed(lambda: graph.train_steps(stacks[1], k))
    got.append(second)
    counts = read_launches()
    peak_graph = torch.cuda.max_memory_allocated() - held
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager = _graph_trainer(cfg, sd, accum, mesh)
    want = [eager.train_step(steps[i], i) for i in range(k)]
    last, eager_rate = timed(lambda: [eager.train_step(steps[i], i) for i in range(k, 2 * k)])
    want += last
    peak_eager = torch.cuda.max_memory_allocated() - held
    off = _graph_bitwise(graph, eager, got, want)
    losses = [round(float(x), 6) for g in got for x in g["loss"]]
    require(not off, f"{phase} {label}: train_steps is not bitwise the train_step loop: {off[:8]} "
                     f"({len(off)} differ); losses {losses} against "
                     f"{[round(float(w['loss']), 6) for w in want]}")
    # counted by replay: the eager step and each replay, never the capture
    want_counts = {**{n: 0 for n in KERNELS}, **{n: 2 * k * c for n, c in per_step.items()}}
    require(counts == want_counts, f"{phase} {label}: launches {counts}, want {want_counts}")
    prof, named, attempt = _profile_routes(
        phase, label, lambda j, a: graph.train_steps(stacks[0], 2 * k + (a * PROFILE_RUNS + j) * k),
        lambda j, a: eager.train_step(steps[j], 2 * k + a * PROFILE_RUNS + j), k)
    state = "both moments" + (", the f32 master" if mesh is not None else "")
    print(f"{phase} train_steps, {label} (bf16, {clips} clips a step, accumulation {accum}, "
          f"K = {k}, dropout 0.1, deterministic mode): two calls bitwise {2 * k} train_step "
          f"calls (losses {losses}; every metric, all {len(list(graph.model.parameters()))} "
          f"parameters, {state}, steps {2 * k}); the wrappers' counts by replay {per_step} "
          f"a step; clips/s of the second call (replays) "
          f"{graph_rate:.3f} against the last {k} train_step calls {eager_rate:.3f}; peak "
          f"device memory {peak_graph / 2**30:.3f} GiB (train_steps: the eager step, the "
          f"capture and the graph's pool) against {peak_eager / 2**30:.3f} GiB (train_step); "
          f"profiled ({attempt + 1} profiles each, {PROFILE_RUNS} runs a profile; the last): "
          f"calls of {k} replays {_profiled_text(prof['replayed'])}, records short of the "
          f"fullest run {prof['replayed']['lost']}; train_step calls "
          f"{_profiled_text(prof['eager'])}, records short {prof['eager']['lost']}; #2's, #4's "
          f"and #5's kernels a step the same in both, {named['eager']}", flush=True)
    return {"graph": graph, "eager": eager, "stacks": stacks, "steps": steps, "k": k,
            "clips": clips, "counts": counts,
            "rates": {"train_steps": [graph_rate], "train_step": [eager_rate]}}


@torch.no_grad()
def _k2_default_diff(graph: Trainer, first: Trainer, second: Trainer) -> tuple:
    """Over every parameter and moment: the largest norm of the graph's
    difference from ``first``'s in units of its limit (the larger of
    K2_CONTROL_FACTOR times ``first``'s from ``second``'s and K2_NORM_RTOL
    of its norm), with its name; the largest of the loops' own differences
    relative to the norm; how many are bitwise equal; how many there are."""
    worst, control, bitwise, total = (0.0, ""), 0.0, 0, 0
    for (name, p), q, r in zip(graph.model.named_parameters(), first.model.parameters(),
                               second.model.parameters()):
        st = [t.optimizer.state[x] for t, x in ((graph, p), (first, q), (second, r))]
        for what, (a, b, c) in ((name, (p, q, r)),
                                *((f"{name} {m}", [x[m] for x in st]) for m in ("m", "v"))):
            diff = float((a.float() - b.float()).norm())
            own = float((b.float() - c.float()).norm())
            norm = float(b.float().norm())
            limit = max(K2_CONTROL_FACTOR * own, K2_NORM_RTOL * norm)
            total += 1
            bitwise += torch.equal(a, b)
            control = max(control, own / max(norm, 1e-30))
            ratio = diff / limit if limit > 0 else (0.0 if diff == 0 else float("inf"))
            worst = max(worst, (ratio, what))
    return worst, control, bitwise, total


def _k2_default(label: str, cfg, sd, steps: list) -> None:
    """The default mode (no deterministic algorithms): one train_steps call
    of K = len(steps) against two loops of K train_step calls, each from the
    same weights; each parameter and moment within the larger of
    K2_CONTROL_FACTOR times the loops' own difference and K2_NORM_RTOL of
    its norm (norms of the differences), every metric within K2_LOSS_RTOL."""
    k, accum = len(steps), steps[0]["video"].shape[0]
    require(not torch.are_deterministic_algorithms_enabled(), "K2's default mode")
    graph = _graph_trainer(cfg, sd, accum)
    got = graph.train_steps(_stacked(steps), 0)
    loops = []
    for _ in range(2):
        eager = _graph_trainer(cfg, sd, accum)
        loops.append((eager, [eager.train_step(steps[i], i) for i in range(k)]))
    (first, want), (second, _) = loops
    loss_rel = max(float(((got[n] - torch.stack([w[n] for w in want])).abs()
                          / torch.stack([w[n] for w in want]).abs()).max()) for n in want[0])
    worst, control, bitwise, total = _k2_default_diff(graph, first, second)
    print(f"K2 train_steps, {label} in the default mode (bf16, K = {k}, dropout 0.1): one call "
          f"against two train_step loops from the same weights: the metrics within "
          f"{loss_rel:.3e} rel (limit {K2_LOSS_RTOL}); {bitwise} of {total} parameters and "
          f"moments bitwise the first loop's; the largest difference {worst[0]:.4f} of its "
          f"limit ({worst[1]}; the limit the larger of {K2_CONTROL_FACTOR}x the loops' own and "
          f"{K2_NORM_RTOL} of the norm); the loops' own difference at most {control:.3e} of a "
          f"tensor's norm", flush=True)
    require(loss_rel <= K2_LOSS_RTOL and worst[0] <= 1.0,
            f"K2 {label} default mode: metrics {loss_rel:.3e} rel, {worst}")


def phase_train_steps_k2(configs: dict, pre_files, vocab: str) -> dict:
    """K2: train_steps on the routes K1 left out, from R1's seeded weights
    and datasets: FT-Align block with --remat and with "dots", pretraining
    stage I (P1's micro-step and accumulation) and stage II (P2's) with
    --remat, bitwise the eager loop in deterministic mode; FT-Align block
    in the default mode. Returns the deterministic routes' launches by path
    (ZeRO-1 runs in D3)."""
    align_cfg, ds, align_clips, align_sd = configs["FT-Align"]
    pre2_cfg, pre2_ds, pre2_clips, pre2_sd = configs["stage II"]
    align = _k2_steps(ds, 2 * K2_ALIGN_K, align_clips, 1)
    pre2 = _k2_steps(pre2_ds, 2 * K2_PRE2_K, pre2_clips, K2_PRE2_ACCUM)
    by_path = {}
    with deterministic_mode():
        for remat in (True, "dots"):
            cfg = align_cfg.replace(remat=remat)
            r = _graph_route("K2", f"FT-Align (--fused_ffn block {REMAT_FLAGS[remat]})", cfg,
                             align_sd, align, _remat_launches(cfg, remat))
            by_path[f"train_steps_ft_align_remat_{remat}"] = r.pop("counts")
            del r
        pre1 = _k2_steps(_pretrain_dataset(pre_files, vocab, stage=1), 2 * K2_PRE1_K,
                         PRE1_CLIPS, PRE1_ACCUM)
        r = _graph_route("K2", "pretraining stage I", _pretrain_cfg(
            1, compute_dtype="bfloat16", batch_size_per_device=PRE1_CLIPS), pre2_sd, pre1,
            _pretrain_launches_per_step(1))
        by_path["train_steps_pretrain_stage_one"] = r.pop("counts")
        del r, pre1
        cfg = pre2_cfg.replace(remat=True)  # without remat: L1, through the CLI
        per_step = {n: c * K2_PRE2_ACCUM for n, c in _remat_launches(cfg, True).items()}
        r = _graph_route("K2", f"pretraining stage II ({REMAT_FLAGS[True]})", cfg, pre2_sd, pre2,
                         per_step)
        by_path["train_steps_pretrain_stage_two_remat_True"] = r.pop("counts")
        del r
    _k2_default("FT-Align (--fused_ffn block)", align_cfg, align_sd, align[:K2_ALIGN_K])
    torch.cuda.empty_cache()
    return by_path


@contextlib.contextmanager
def _kept_loop():
    """cli.common.run_train_epochs patched to keep what a CLI run gives it
    (args, trainer, batcher, logger) and a graph=False twin of its trainer:
    cli.common.make_trainer over a copy of the model, taken before the
    first step."""
    kept = {}
    real = cli_common.run_train_epochs

    def keep(args, trainer, batcher, logger, device, **kw):
        twin = cli_common.make_trainer(args, copy.deepcopy(trainer.model), len(batcher), logger)
        twin.graph = False
        kept.update(args=args, trainer=trainer, batcher=batcher, logger=logger, twin=twin)
        return real(args, trainer, batcher, logger, device, **kw)

    cli_common.run_train_epochs = keep
    try:
        yield kept
    finally:
        cli_common.run_train_epochs = real


def _l1_run(cli: str, extra: list, tmp: str, vocab: str, data: dict, out: str) -> tuple:
    """A route's CLI run (one epoch, every step displayed, no train state
    kept but pretraining's): (the CLI's main, its argv, the launches of a
    step)."""
    if cli == "retrieval":
        csv, feats_data, feats = data["retrieval"]
        argv = ["--do_train", "--device", "cuda", "--datatype", "youcook", "--vocab_file", vocab,
                "--train_csv", csv, "--data_path", feats_data, "--features_path", feats,
                "--output_dir", out, *TRAIN_FLAGS, *extra]
        if "--train_sim_after_cross" in extra:  # an eval after the epoch, beside the graphs
            argv += ["--do_eval", "--val_csv", data["val"], "--batch_size_val", "16"]
        per_step = _launches_per_step("ft_align" if extra else "ft_joint")
        main = task_retrieval.main
    elif cli == "caption":
        train_csv, val_csv, feats_data, feats = data["caption"]
        argv = ["--do_train", "--device", "cuda", "--stage_two", "--datatype", "youcook",
                "--vocab_file", vocab, "--train_csv", train_csv, "--val_csv", val_csv,
                "--data_path", feats_data, "--features_path", feats, "--output_dir", out,
                *CAP_FLAGS, "--fused_ln", *extra]
        per_step = _caption_launches_per_step(UniVL(_caption_cfg(), device="meta"))
        main = task_caption.main
    else:
        argv = _pretrain_argv(data["pretrain"], vocab, out, 2, "--batch_size",
                              str(PRE2_CLIPS * L1_PRE2_ACCUM), "--gradient_accumulation_steps",
                              str(L1_PRE2_ACCUM), "--epochs", "1", *extra)
        per_step = {n: c * L1_PRE2_ACCUM
                    for n, c in _remat_launches(_pretrain_cfg(2), False).items()}
        main = pretrain.main
    return main, argv + ["--n_display", "1", "--no_preempt_checkpoint"], per_step


class _Timed:
    """``obj`` whose method ``name`` is timed on the host into ``seconds``;
    its other attributes are ``obj``'s."""

    def __init__(self, obj, name: str, seconds: list):
        self.obj, self.seconds = obj, seconds
        setattr(self, name, self._timed(getattr(obj, name)))

    def __getattr__(self, attr):
        return getattr(self.obj, attr)

    def _timed(self, fn):
        def timed(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            self.seconds.append(time.perf_counter() - t0)
            return out
        return timed


def _l1_window(kept: dict, trainer: Trainer, steps: int, display: int, out: str) -> tuple:
    """One CLI window: run_train_epochs with the run's args and batcher over
    ``steps`` update-batches (ended by --inject_crash_after, which saves
    nothing), displayed every ``display``: (clips/s between the first and
    the last display point, the host's seconds of each train_steps call)."""
    args = copy.copy(kept["args"])
    args.output_dir, args.n_display, args.epochs = out, display, 1
    args.inject_crash_after, args.inject_preempt_after, args.checkpoint_every_steps = steps, 0, 0
    args.load_checkpoint, args.no_preempt_checkpoint = False, True
    host, inner = [], trainer.train_steps

    def timed(batches, first_step):
        t0 = time.perf_counter()
        out = inner(batches, first_step)
        host.append(time.perf_counter() - t0)
        return out

    trainer.train_steps = timed
    try:
        cli_common.run_train_epochs(args, trainer, kept["batcher"], kept["logger"],
                                    torch.device("cuda"))
        raise RuntimeError(f"L1: a window of {steps} steps ran to its epoch's end")
    except RuntimeError as e:
        require("injected crash" in str(e), f"L1 window: {e}")
    finally:
        del trainer.train_steps  # the class's again
    _step_route(out, "eager: graph=False" if trainer.graph is False else "graph")
    shown = _train_losses(out)
    require(len(shown) == steps // display and len(shown) >= 2,
            f"L1 window: display points {[r['step'] for r in shown]}")
    clips = args.batch_size * args.gradient_accumulation_steps
    rate = (shown[-1]["step"] - shown[0]["step"]) * clips / (shown[-1]["ts"] - shown[0]["ts"])
    return rate, host


def _l1_route(label: str, cli: str, extra: list, window: tuple, tmp: str, vocab: str,
              data: dict) -> dict:
    """One L1 route (its constants' comment): returns the CLI run's launches."""
    steps_w, display, pairs = window
    out = os.path.join(tmp, f"l1_{cli}{'_align' if extra else ''}")
    main, argv, per_step = _l1_run(cli, extra, tmp, vocab, data, out)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _kept_loop() as kept:
        result = main(argv)
    torch.cuda.synchronize()
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() - held
    steps = result[0]
    trainer, twin, args = kept["trainer"], kept["twin"], kept["args"]
    route = _step_route(out)
    shown = _train_losses(out)
    # the twin: train_step over the batcher's epoch, the batches as the CLI moves them
    accum = args.gradient_accumulation_steps
    reset_launches()
    want, kept_batches = [], []
    for b in kept["batcher"].epoch(0):
        batch = {k: torch.from_numpy(v if accum > 1 else v[None]).to("cuda") for k, v in b.items()}
        want.append({k: float(v) for k, v in twin.train_step(batch, len(want)).items()})
        if len(kept_batches) < PROFILE_RUNS:
            kept_batches.append(batch)
    twin_counts = read_launches()
    done = trainer.optimizer.steps
    evaluated, eval_counts = "", {n: 0 for n in KERNELS}
    if "--do_eval" in argv:  # the per-epoch eval read the weights the replays updated
        with open(os.path.join(out, "metrics.jsonl")) as f:
            [metrics] = [r for r in map(json.loads, f) if r["kind"] == "eval"]
        tok = WordPieceTokenizer(vocab, do_lower_case=args.do_lower_case)
        ds = task_retrieval.build_datasets(args, tok)[1]  # the CLI's eval set
        reset_launches()
        eager = RetrievalEvaluator(twin.model, batch_size=args.batch_size_val,
                                   graph=False).evaluate(
            task_retrieval.eval_batches(ds, args.batch_size_val))
        eval_counts = read_launches()
        keys = ("R1", "R5", "R10", "MR", "MeanR")
        require(all(metrics[k] == eager[k] for k in keys),
                f"L1 {label}: the CLI's eval {metrics} against the twin's graph=False {eager}")
        evaluated = (f"; its eval after the epoch (evaluator graphs beside the step's; "
                     f"{len(ds)} clips, cross) {[metrics[k] for k in keys]}, the twin's weights "
                     f"through graph=False the same, its launches by replay those of "
                     f"graph=False, { {k: v for k, v in eval_counts.items() if v} }")
    got = [{k: r[k] for k in w} for r, w in zip(shown, want)]
    saved = torch.load(os.path.join(out, "pytorch_model.bin.0"), weights_only=True)
    off = [f"pytorch_model.bin.0 {k}" for k, v in twin.model.state_dict().items()
           if not torch.equal(saved[k], v.cpu())] + _state_differs(trainer, twin)
    require(steps == len(want) == len(shown) and got == want and not off,
            f"L1 {label}: the CLI's graph route is not bitwise the graph=False loop: {steps} "
            f"steps against {len(want)}; displayed {got[:3]} against {want[:3]}; {off[:8]} "
            f"({len(off)} differ)")
    step_counts = {**{n: 0 for n in KERNELS}, **{n: steps * c for n, c in per_step.items()}}
    require(twin_counts == step_counts and trainer.capturer.captures == 1
            and len(trainer._graphs) == 1
            and counts == {n: c + eval_counts[n] for n, c in step_counts.items()},
            f"L1 {label}: launches by replay {counts}, graph=False {twin_counts} (and its eval "
            f"{eval_counts}), {steps} steps imply {step_counts}; {trainer.capturer.captures} "
            f"captures")
    stacks = [{k: v[None] for k, v in b.items()} for b in kept_batches]
    prof, named, attempt = _profile_routes(
        "L1", label, lambda j, a: trainer.train_steps(stacks[j], 10_000 + a * PROFILE_RUNS + j),
        lambda j, a: twin.train_step(kept_batches[j], 10_000 + a * PROFILE_RUNS + j), 1)
    print(f"L1 {label} (CLI, bf16, {args.batch_size * accum} clips a step, accumulation "
          f"{accum}, deterministic mode; step route {route}): {steps} steps bitwise a "
          f"graph=False twin's train_step loop over the same batches (every displayed metric, "
          f"pytorch_model.bin.0, all {len(list(trainer.model.parameters()))} parameters, both "
          f"moments, steps {done}); losses "
          f"{[round(w['loss'], 6) for w in want]}; {trainer.capturer.captures} capture "
          f"({trainer.capturer.seconds:.3f} s with the eager step); launches by replay "
          f"{ {k: v for k, v in counts.items() if v} }, {per_step} a step, the twin's the same; "
          f"peak device memory of the run {peak / 2**30:.3f} GiB above the "
          f"{held / 2**30:.3f} held before{evaluated}; profiled ({attempt + 1} profiles, the "
          f"last): a replayed step {_profiled_text(prof['replayed'])}, an eager step "
          f"{_profiled_text(prof['eager'])}; #2's, #4's and #5's kernels a step the same in both, "
          f"{named['eager']}", flush=True)
    # the host's work in a graph window's train_steps calls, by part
    [key] = trainer._graphs
    entry, parts = trainer._graphs[key], {"replay": [], "seeds": [], "wait": []}
    trainer._graphs[key] = entry._replace(
        graph=_Timed(entry.graph, "replay", parts["replay"]),
        pool=[_Timed(g, "manual_seed", parts["seeds"]) for g in entry.pool],
        copied=_Timed(entry.copied, "synchronize", parts["wait"]))
    windows = data["windows"].get(cli)  # else the run's own epoch
    if windows is not None:
        kept["batcher"] = cli_common.make_batcher(args, windows, dp_mesh.Mesh())
    rates, host = {"graph": [], "graph=False": []}, []
    try:
        for pair in range(pairs):
            for name in (("graph", "graph=False") if pair % 2 == 0 else ("graph=False", "graph")):
                rate, calls = _l1_window(kept, trainer if name == "graph" else twin, steps_w,
                                         display, os.path.join(out, f"window{pair}_{name}"))
                rates[name].append(rate)
                if name == "graph":
                    host += calls
    finally:
        trainer._graphs[key] = entry
    per_call = {k: 1e3 * sum(v) / len(host) for k, v in parts.items()}
    stack = stacks[0]
    t0 = time.perf_counter()
    for _ in range(20):
        trainer._addresses()
    t1 = time.perf_counter()
    for _ in range(20):
        trainer._graph_key(stack)
    t2 = time.perf_counter()
    med = {k: float(np.median(v)) for k, v in rates.items()}
    print(f"L1 {label}: {pairs} alternating pair(s) of CLI windows of {steps_w} steps "
          f"(run_train_epochs, a display point every {display}, deterministic mode), clips/s "
          f"graph route {[round(x, 3) for x in rates['graph']]} median {med['graph']:.3f}, "
          f"graph=False {[round(x, 3) for x in rates['graph=False']]} median "
          f"{med['graph=False']:.3f} ({med['graph'] / med['graph=False']:.3f}x); the host's ms "
          f"a train_steps call of K = 1 on the graph route: median "
          f"{1e3 * float(np.median(host)):.3f}, mean {1e3 * float(np.mean(host)):.3f} over "
          f"{len(host)} calls; of it a call's replay launch {per_call['replay']:.3f}, the "
          f"generators' seeds {per_call['seeds']:.3f} ({len(entry.pool)} generators), the wait "
          f"for the last replay's copies out of the pinned staging (the host held to a replay "
          f"or two ahead) {per_call['wait']:.3f}, the state's addresses "
          f"{1e3 * (t1 - t0) / 20:.3f}, the graph's key {1e3 * (t2 - t1) / 20:.3f}; the rest "
          f"the key table's derivation, the batch and staging copies and the metrics' clones",
          flush=True)
    if label == X1_ROUTE:  # X1 holds its traced run of the same epoch against this one
        data["x1"] = {"argv": argv, "shown": shown, "bin": os.path.join(tmp, "l1_x1.bin")}
        os.replace(os.path.join(out, "pytorch_model.bin.0"), data["x1"]["bin"])
    shutil.rmtree(out)
    return counts


def _head_csv(csv: str, n: int, path: str) -> str:
    """A csv of ``csv``'s first ``n`` rows, at ``path``."""
    with open(csv) as f:
        header, *rows = f.read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join([header, *rows[:n]]) + "\n")
    return path


def phase_cli_graphs(tmp: str, vocab: str, files, ds, cap_files, cap_ds, pre_files) -> tuple:
    """L1 (the comment at L1_ROUTES) over the first videos of phase 10's
    ``files`` and phase 16's ``cap_files``, its windows over ``ds`` and
    ``cap_ds``: returns each route's launches by path, and X1's reference
    (X1_ROUTE's argv, displayed metrics and .bin)."""
    data = {"retrieval": (_head_csv(files[0], L1_VIDEOS, os.path.join(tmp, "l1_train.csv")),
                          *files[1:]),
            "val": _head_csv(files[0], L1_VAL_VIDEOS, os.path.join(tmp, "l1_val.csv")),
            "caption": (_head_csv(cap_files[0], L1_CAP_VIDEOS,
                                  os.path.join(tmp, "l1_caption.csv")), *cap_files[1:]),
            "pretrain": pre_files, "windows": {"retrieval": ds, "caption": cap_ds}}
    by_path = {}
    with deterministic_mode():
        for label, (cli, extra, *window) in L1_ROUTES.items():
            name = label.split(" (")[0].lower().replace("-", "_").replace(" ", "_")
            by_path[f"cli_graph_{name}"] = _l1_route(label, cli, extra, tuple(window), tmp,
                                                     vocab, data)
            torch.cuda.empty_cache()
    return by_path, data["x1"]


def _shown(records: list) -> list:
    """Display points without the clock's fields."""
    return [{k: v for k, v in r.items() if k not in ("ts", "clips_per_sec")} for r in records]


def _x1_trace(path: str) -> dict:
    """X1's reading of a trace file: the step ranges, each one's kernels as
    (name, stream), the kernels launched in none, the copies and fills
    launched before the first and after the last, the device busy time over
    the steps' span (the union of their events' intervals), and how far the
    card's clock ran past the host's at a step's end. A device event belongs
    to the step whose range holds the host call that launched it (its
    ``correlation``; a replay's kernels carry their ``cudaGraphLaunch``'s):
    the trace puts the card's timestamps on the host's clock only up to a
    drift, so a step's last kernels can show after its range although the
    step synchronizes at its end."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    # the host's ranges (the card's projection of each is a gpu_user_annotation)
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith(STEP_RANGE)), key=lambda e: e["ts"])
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])
    start = ranges[0]["ts"] if ranges else float("inf")
    end = ranges[-1]["ts"] + ranges[-1]["dur"] if ranges else float("-inf")
    steps, before, after, outside = [[] for _ in ranges], [], [], []
    for e in device:
        ts = launched.get(e.get("args", {}).get("correlation"))
        held = [i for i, r in enumerate(ranges)
                if ts is not None and r["ts"] <= ts <= r["ts"] + r["dur"]]
        if held:
            steps[held[0]].append(e)
        elif e["cat"] == "kernel":
            outside.append(e)
        elif ts is not None and ts < start:
            before.append(e)
        else:
            after.append(e)
    drift = [max(e["ts"] + e["dur"] for e in step) - (r["ts"] + r["dur"])
             for r, step in zip(ranges, steps) if step]
    mine = sorted((e for step in steps for e in step), key=lambda e: e["ts"])
    busy_us, last = 0.0, start
    for e in mine:
        busy_us += max(0.0, e["ts"] + e["dur"] - max(e["ts"], last))
        last = max(last, e["ts"] + e["dur"])
    return {"steps": [int(r["name"][len(STEP_RANGE):]) for r in ranges],
            "wall_us": [r["dur"] for r in ranges], "span_us": max(end, last) - start,
            "busy_us": busy_us, "drift_us": max(drift, default=0.0),
            "kernels": [[(e["name"], e.get("args", {}).get("stream")) for e in step
                         if e["cat"] == "kernel"] for step in steps],
            "outside": [(e["name"], e.get("args", {}).get("stream")) for e in outside],
            "copies_before": len(before), "copies_after": len(after)}


def _x1_kernels(steps: list, per_kernel: dict) -> tuple:
    """Each traced step's kernels, (name, stream) pairs, read for X1: the
    counts of ``per_kernel``'s names a step, the streams they run on, each
    step's kernel names on those streams and on the others, and each later
    step's names beyond the first's and short of them."""
    named = [{n: sum(n in name for name, _ in step) for n in per_kernel} for step in steps]
    # the step's own kernels: those on #2's stream (the replays'); the input
    # thread's copies of the batches to come run on a stream of their own
    streams = {s for step in steps for name, s in step if any(n in name for n in per_kernel)}
    own = [sorted(name for name, s in step if s in streams) for step in steps]
    other = [sorted(name for name, s in step if s not in streams) for step in steps]
    apart = [(dict(Counter(k) - Counter(own[0])), dict(Counter(own[0]) - Counter(k)))
             for k in own[1:]]
    return named, streams, own, other, apart


def phase_cli_trace(tmp: str, reference: dict) -> dict:
    """X1 (the comment at X1_STEPS): returns the traced run's launches."""
    out, prof_dir = os.path.join(tmp, "x1"), os.path.join(tmp, "x1_trace")
    argv = list(reference["argv"])
    argv[argv.index("--output_dir") + 1] = out
    logged = []  # the loop's log, for its "profiler trace written" line
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    logger = logging.getLogger("univl_tpu_torch")
    logger.addHandler(handler)
    reset_launches()
    try:
        with deterministic_mode():
            t0 = time.perf_counter()
            steps = task_retrieval.main(argv + ["--profile_dir", prof_dir])[0]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    counts = read_launches()
    per_step = _launches_per_step("ft_joint")
    want_counts = {**{n: 0 for n in KERNELS}, **{n: steps * c for n, c in per_step.items()}}
    route = _step_route(out)
    got, want = _shown(_train_losses(out)), _shown(reference["shown"])
    require(steps == len(want) and got == want and counts == want_counts,
            f"X1: {steps} steps, displayed {got[:3]} against L1's {want[:3]}; launches by "
            f"replay {counts}, {steps} steps imply {want_counts}")
    traced = torch.load(os.path.join(out, "pytorch_model.bin.0"), weights_only=True)
    l1 = torch.load(reference["bin"], weights_only=True)
    off = sorted(set(traced) ^ set(l1)) + [k for k in l1 if k in traced
                                            and not torch.equal(traced[k], l1[k])]
    require(not off, f"X1: pytorch_model.bin.0 is not L1's: {off[:8]} ({len(off)} differ)")
    files = os.listdir(prof_dir)
    written = [m for m in logged if m.startswith("profiler trace written to ")]
    export = [re.fullmatch(rf"profiler trace written to {re.escape(prof_dir)} "
                           rf"\({re.escape(f)}, exported in ([0-9.]+) s\)", m)
              for m in written for f in files]
    require(len(files) == 1 and files[0].startswith("rank0.")
            and files[0].endswith(".pt.trace.json") and len(written) == 1 and export[0],
            f"X1: trace files {files}, logged {written}")
    path, export_seconds = os.path.join(prof_dir, files[0]), float(export[0].group(1))
    t = _x1_trace(path)
    per_kernel = {n: per_step[k] for k in ("train_attention_fwd", "train_attention_bwd")
                  for n in TRACE_NAMES[k]}
    named, streams, own, other, apart = _x1_kernels(t["kernels"], per_kernel)
    fills = all(FILL in name for k in other for name in k)
    # a kernel launched between the ranges can only be the input thread's
    stray = [name for name, s in t["outside"] if s in streams or FILL not in name]
    require(tuple(t["steps"]) == X1_STEPS and not stray
            and all(k == own[0] for k in own) and all(n == per_kernel for n in named) and fills,
            f"X1: ranges for steps {t['steps']} (want {X1_STEPS}); kernels launched outside "
            f"them {len(t['outside'])}, on #2's stream or no fill {stray[:8]}; kernels a step on "
            f"#2's stream(s) {streams} {[len(k) for k in own]} (each later step's names beyond "
            f"the first's and short of them: {apart}), on others {[len(k) for k in other]} "
            f"({sorted(set(sum(other, [])))[:8]}); #2's by name a step {named}, want {per_kernel}")
    print(f"X1 {CARD[0]}: task_retrieval --do_train --profile_dir (FT-Joint, {X1_ROUTE} epoch of "
          f"L1: {steps} steps of {TRAIN_BATCH} clips, bf16, deterministic mode; step route "
          f"{route}; {seconds:.1f} s the run): every displayed metric and pytorch_model.bin.0 "
          f"bitwise L1's untraced run, launches by replay {steps} steps'; one trace "
          f"{os.path.basename(path)}, {os.path.getsize(path) / 2**20:.3f} MiB, exported in "
          f"{export_seconds:.3f} s, ranges for global steps {t['steps']} and no other; "
          f"the traced steps' wall {np.mean(t['wall_us']) / 1e3:.3f} ms a step "
          f"({[round(w / 1e3, 3) for w in t['wall_us']]}), the device busy "
          f"{t['busy_us'] / t['span_us']:.4f} of the steps' span (the union of the steps' "
          f"kernels, copies and fills); each event read into the step whose range holds its "
          f"launch (the card's clock ran up to {t['drift_us']:.1f} us past a range's end on "
          f"the host's); {len(own[0])} kernels in each step on #2's stream, every step's the "
          f"same by name, and on other streams {[len(k) for k in other]} a step "
          f"({sorted(set(sum(other, [])))[:8]}); launched outside the steps {len(t['outside'])} "
          f"kernels, all fills off #2's stream; #2's tensor-core kernels "
          f"{ {n: c * len(X1_STEPS) for n, c in per_kernel.items()} } in the trace "
          f"({per_kernel} a step); the input thread's copies {t['copies_before']} launched "
          f"before the first step and {t['copies_after']} after the last", flush=True)
    shutil.rmtree(out)
    shutil.rmtree(prof_dir)
    os.remove(reference["bin"])
    return counts


def phase_eval_graphs(vocab: str, files) -> dict:
    """I2 (the comment at I2_CLIPS): returns the graph route's launches."""
    _, test_csv, _, feats = files
    cfg = UniVLConfig.base(max_words=MAX_WORDS, max_frames=48, train_sim_after_cross=True,
                           compute_dtype="bfloat16")
    model = UniVL(cfg, device="cuda")
    model.load_state_dict(seeded_weights(cfg), strict=True)
    model.eval()
    ds = MsrvttRetrievalEvalDataset(test_csv, feats, WordPieceTokenizer(vocab),
                                    max_words=MAX_WORDS, max_frames=48, seed=0)
    batches = [collate([ds[i] for i in range(j, min(j + EVAL_BATCH, I2_CLIPS))])
               for j in range(0, I2_CLIPS, EVAL_BATCH)]
    evs = {"graph": RetrievalEvaluator(model, batch_size=EVAL_BATCH),
           "graph=False": RetrievalEvaluator(model, batch_size=EVAL_BATCH, graph=False)}
    require(evs["graph"].graph and not evs["graph=False"].graph, "I2: the evaluators' routes")
    layers = cfg.bert.num_hidden_layers + cfg.visual.num_hidden_layers
    tb, vb = evs["graph"].tb, evs["graph"].vb
    want = {**{k: 0 for k in KERNELS}, "eval_attention": 2 * len(batches) * layers
            + -(-I2_CLIPS // tb) * -(-I2_CLIPS // vb) * cfg.cross.num_hidden_layers}
    out, counts = {}, {}
    with deterministic_mode():
        for name, ev in evs.items():
            reset_launches()
            joint = ev.joint_sim_matrix(ev.encode_dataset(iter(batches), store_full=False))
            cross = ev.cross_sim_matrix_device(ev.encode_dataset_device(iter(batches)))
            counts[name] = read_launches()
            host = ev.cross_sim_matrix(ev.encode_dataset(iter(batches), store_full=True))
            out[name] = {"joint": joint, "cross": cross, "host tiles": host}
        g = evs["graph"]
        captures, replays = g.capturer.captures, dict(g.replays)
        reset_launches()
        again = g.cross_sim_matrix_device(g.encode_dataset_device(iter(batches)))
        again_counts = read_launches()
    off = [k for k in out["graph"] if not np.array_equal(out["graph"][k], out["graph=False"][k])]
    require(not off and np.array_equal(again, out["graph"]["cross"]),
            f"I2: the graph route is not bitwise graph=False: {off}")
    tiles = float(np.abs(out["graph"]["host tiles"] - out["graph"]["cross"]).max())
    require(counts["graph"] == counts["graph=False"] == want and captures == 3
            and g.capturer.captures == 3 and again_counts["eval_attention"]
            == want["eval_attention"] - len(batches) * layers,
            f"I2: #1 by replay {counts['graph']}, graph=False {counts['graph=False']}, the "
            f"passes imply {want}; {captures} captures, then {g.capturer.captures}; the second "
            f"evaluation {again_counts}")
    print(f"I2 RetrievalEvaluator, FT-Align (bf16, {I2_CLIPS} clips, batch {EVAL_BATCH}, "
          f"stripes of {tb} texts x {I2_CLIPS} videos in blocks of {vb}, deterministic mode): "
          f"the graph route bitwise graph=False (the joint matrix, the device-resident "
          f"rescoring, the host tiles' rescoring, {tiles:.3e} at most from the device-resident "
          f"one); {captures} captures (the "
          f"encode, a stripe, a tile; {g.capturer.seconds:.3f} s with their eager first runs), "
          f"replays {replays}; a second evaluation captured nothing and replayed "
          f"{ {k: v - replays.get(k, 0) for k, v in g.replays.items()} }; #1 by replay "
          f"{counts['graph']['eval_attention']} for a joint and a cross pass, as graph=False "
          f"launches it", flush=True)
    rates = {name: {"encode": [], "rescoring": []} for name in evs}
    for pair in range(I2_PAIRS):
        for name in (("graph", "graph=False") if pair % 2 == 0 else ("graph=False", "graph")):
            ev = evs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = ev.encode_dataset_device(iter(batches))  # ends in a copy to the host
            t1 = time.perf_counter()
            ev.cross_sim_matrix_device(enc)
            t2 = time.perf_counter()
            rates[name]["encode"].append(I2_CLIPS / (t1 - t0))
            rates[name]["rescoring"].append(I2_CLIPS ** 2 / (t2 - t1))
            del enc
    med = {name: {k: float(np.median(v)) for k, v in r.items()} for name, r in rates.items()}
    print(f"I2 {I2_PAIRS} alternating pairs (default mode, {I2_CLIPS} clips): encode clips/s "
          f"graph {[round(x, 1) for x in rates['graph']['encode']]} median "
          f"{med['graph']['encode']:.1f}, graph=False "
          f"{[round(x, 1) for x in rates['graph=False']['encode']]} median "
          f"{med['graph=False']['encode']:.1f}; rescoring pairs/s graph "
          f"{[round(x) for x in rates['graph']['rescoring']]} median "
          f"{med['graph']['rescoring']:.0f}, graph=False "
          f"{[round(x) for x in rates['graph=False']['rescoring']]} median "
          f"{med['graph=False']['rescoring']:.0f}", flush=True)
    del evs, model
    torch.cuda.empty_cache()
    return counts["graph"]


def _input_args(**kw):
    return SimpleNamespace(**{"gradient_accumulation_steps": 1, "transfer_dtype": "float32",
                              "no_prefetch": False, **kw})


def _input_run(trainer, batcher, args, epoch: int, steps: int) -> list:
    """The losses of ``steps`` training steps of ``batcher``'s epoch through
    cli.common.make_input_iter, each one train_steps call of K = 1 as the
    CLIs' loop steps (on the card a replay from the second)."""
    losses = []
    with contextlib.closing(cli_common.make_input_iter(args, batcher, epoch,
                                                       torch.device("cuda"))) as batches:
        for i, batch in enumerate(batches):
            losses.append(trainer.train_steps({k: v[None] for k, v in batch.items()},
                                              epoch * 1000 + i)["loss"][0])
            if i + 1 == steps:
                break
    return [float(x) for x in losses]


def phase_input_pipeline(ds, vocab: str, ret_files, tmp: str, joint_metrics: dict) -> dict:
    """R2: FT-Joint (phase 10's config) through make_input_iter; returns the
    launches."""
    cfg = UniVLConfig.base(max_words=48, max_frames=48, compute_dtype="bfloat16",
                           batch_size_per_device=TRAIN_BATCH)
    sd = seeded_weights(cfg)
    batcher = Batcher(ds, TRAIN_BATCH, seed=0, num_workers=8)

    def trainer():
        model = UniVL(cfg, device="cuda")
        model.load_state_dict(sd, strict=True)
        opt = make_univl_optimizer(model, lr=3e-5, t_total=40, warmup_proportion=0.1,
                                   coef_lr=0.1)
        return Trainer(model, opt, seed=0)

    reset_launches()
    torch.use_deterministic_algorithms(True)
    try:
        runs = {name: _input_run(trainer(), batcher, _input_args(**kw), 0, INPUT_CHECK_STEPS)
                for name, kw in (("prefetch", {}), ("no_prefetch", {"no_prefetch": True}),
                                 ("bf16", {"transfer_dtype": "bfloat16"}))}
    finally:
        torch.use_deterministic_algorithms(False)
    worst = max(abs(a - b) / abs(b) for a, b in zip(runs["bf16"], runs["prefetch"]))
    print(f"R2 input pipeline, FT-Joint (batch {TRAIN_BATCH}, bf16, deterministic mode, "
          f"{INPUT_CHECK_STEPS} steps): losses with the prefetch {runs['prefetch']}, with "
          f"--no_prefetch {runs['no_prefetch']}; --transfer_dtype bfloat16 {runs['bf16']}, at "
          f"most {worst:.3e} rel from the f32 transfer's (limit {TRANSFER_BF16_RTOL})", flush=True)
    require(runs["prefetch"] == runs["no_prefetch"],
            "R2: the prefetch's losses are not bitwise --no_prefetch's")
    require(all(math.isfinite(x) for x in runs["bf16"]) and worst <= TRANSFER_BF16_RTOL,
            f"R2: --transfer_dtype bfloat16 losses {worst:.3e} rel from f32's")
    counts = read_launches()
    steps = 3 * INPUT_CHECK_STEPS
    want = {**{k: 0 for k in KERNELS},
            **{k: n * steps for k, n in _launches_per_step("ft_joint").items()}}
    require(counts == want, f"R2 launches (counted by replay) {counts}, {steps} steps imply "
                            f"{want}")
    out = os.path.join(tmp, "msrvtt_retrieval_joint_no_prefetch")
    argv = _msrvtt_argv(ret_files, vocab, out) + ["--batch_size_val", str(EVAL_BATCH),
                                                  "--no_prefetch"]
    _, metrics = task_retrieval.main(argv)
    keys = ("R1", "R5", "R10", "MR", "MeanR")
    print(f"R2 retrieval eval (joint) with --no_prefetch: "
          f"{ {k: metrics[k] for k in keys} }; phase 20 (prefetched) "
          f"{ {k: joint_metrics[k] for k in keys} }", flush=True)
    require(all(metrics[k] == joint_metrics[k] for k in keys),
            "R2: the prefetched eval's metrics differ from --no_prefetch's")
    return counts


def phase_converter(tmp: str) -> None:
    """R4: a full-width reference .bin (every module) through
    univl_tpu_torch.cli.convert_checkpoint to flax params and back."""
    flags = ["--stage_two", "--do_pretrain"]
    cfg = convert_checkpoint.build_config(convert_checkpoint.parse_args(
        flags + ["--torch_bin", "-", "--output", "-"]))
    src, flax_file, back = (os.path.join(tmp, n) for n in ("src.bin", "params.msgpack",
                                                           "back.bin"))
    torch.save(reference_state_dict(init_state_dict(cfg, seed=5)), src)
    t0 = time.perf_counter()
    convert_checkpoint.main(flags + ["--torch_bin", src, "--output", flax_file])
    t1 = time.perf_counter()
    convert_checkpoint.main(["--export_torch", "--flax_params", flax_file, "--output", back])
    t2 = time.perf_counter()
    a, b = (torch.load(p, weights_only=True) for p in (src, back))
    same = list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    print(f"R4 converter (no JAX on this machine): a reference .bin of {len(a)} tensors "
          f"({os.path.getsize(src) / 2**20:.1f} MiB, UniVLConfig.base stage II with the heads) "
          f"to flax params ({os.path.getsize(flax_file) / 2**20:.1f} MiB) in {t1 - t0:.3f} s and "
          f"back with --export_torch in {t2 - t1:.3f} s: bitwise equal {same}", flush=True)
    require(same, "R4: the converter's round trip changed the .bin")
    for path in (src, flax_file, back):
        os.remove(path)


_STAMPS = [time.perf_counter()]


def stamp(label: str) -> None:
    """The seconds since the script started and since the last stamp."""
    now = time.perf_counter()
    print(f"[time] {label}: done at {now - _STAMPS[0]:.1f} s ({now - _STAMPS[-1]:.1f} s for "
          f"this stretch)", flush=True)
    _STAMPS.append(now)


PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pycache")


def keep_bytecode() -> threading.Thread:
    """Where Python runs with PYTHONDONTWRITEBYTECODE over packages shipped
    without compiled bytecode, every process compiles PyTorch's modules
    from source: seconds of CPU in each rank that D1, D2, T1, T2 and G1/E1
    spawn. From here on this process writes the bytecode it compiles under
    PYCACHE and the ranks read it there (and add to it); the modules already
    imported are compiled into it on the returned thread, which runs beside
    the kernels' build."""
    sys.pycache_prefix, sys.dont_write_bytecode = PYCACHE, False
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sources = [f for f in (getattr(m, "__file__", None) for m in list(sys.modules.values()))
               if f and f.endswith(".py") and os.path.isabs(f) and os.path.isfile(f)]

    def compile_all():
        for src in sources:
            cfile = importlib.util.cache_from_source(src)
            if not os.path.exists(cfile):
                py_compile.compile(src, cfile=cfile, quiet=2)

    thread = threading.Thread(target=compile_all, daemon=True)
    thread.start()
    return thread


def _launch_key(entry) -> str:
    """A KERNELS entry's name in ``parallel/mesh.py:kernel_launches``."""
    fn, attr = _counter(entry)
    return f"{fn.__module__.rsplit('.', 1)[1]}.{fn.__name__}.{attr}"


def ranks_launches(reports) -> dict:
    """The launches of every kernel summed over a spawned run's ranks."""
    return {name: sum(r["launches"][_launch_key(entry)] for r in reports)
            for name, (entry, _, _) in KERNELS.items()}


def _dp_argv(files, vocab: str, out: str, *extra) -> list:
    csv, data, feats = files
    return ["--do_train", "--device", "cuda", "--datatype", "youcook", "--vocab_file", vocab,
            "--train_csv", csv, "--data_path", data, "--features_path", feats,
            "--output_dir", out, *TRAIN_FLAGS, *DP_FLAGS, *extra]


def _rel_diff(got: dict, want: dict):
    """(the largest norm-relative difference over the tensors, its name)."""
    return max((float((got[k].float() - want[k].float()).norm())
                / max(float(want[k].float().norm()), 1e-30), k) for k in want)


@contextlib.contextmanager
def deterministic_mode():
    """torch.use_deterministic_algorithms in this process and in the ranks
    it spawns (mesh.spawn passes the setting on), lifted after."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def phase_dp_train(tmp: str, vocab: str, files, init: str):
    """D1: FT-Align on two ranks sharing the card (gloo), replicated and
    --zero1, through task_retrieval in deterministic mode from the weights in
    ``init``, each against one process accumulating two micro-batches over the
    same steps. Returns the launches by path and the accumulated run's
    (weights, losses), T1's reference."""
    with deterministic_mode():
        return _dp_train(tmp, vocab, files, init)


def _dp_train(tmp: str, vocab: str, files, init: str):
    per_step = _launches_per_step("ft_align")  # a rank's 16 rows launch a step's count
    ranks = ["--n_gpu", str(DP_RANKS), "--dist_backend", "gloo", "--init_model", init]
    ref = os.path.join(tmp, "dp_accum")
    task_retrieval.main(_dp_argv(files, vocab, ref, "--n_gpu", "1", "--init_model", init,
                                 "--gradient_accumulation_steps", str(DP_RANKS)))
    want = load_reference_bin(os.path.join(ref, "pytorch_model.bin.0"))
    want_losses = [r["loss"] for r in _train_losses(ref)]
    shutil.rmtree(ref)
    by_path = {}
    for zero1 in (False, True):
        name = "dp_ft_align" + ("_zero1" if zero1 else "")
        label = f"D1 FT-Align --n_gpu {DP_RANKS}" + (" --zero1" if zero1 else "")
        out = os.path.join(tmp, name)
        t0 = time.perf_counter()
        steps, _ = task_retrieval.main(_dp_argv(files, vocab, out, *ranks,
                                                *(["--zero1"] if zero1 else [])))
        wall = time.perf_counter() - t0
        reports = dp_mesh.spawn.ranks
        _step_route(out, f"eager: a mesh of {DP_RANKS} ranks")  # gloo ranks: train_step
        shown = _train_losses(out)
        require(steps == DP_STEPS and len(shown) == steps
                and all(math.isfinite(r["loss"]) for r in shown),
                f"{label}: display points {[(r['step'], r['loss']) for r in shown]}")
        first, last = shown[1], shown[-1]  # the first step's interval holds the warm-up
        rate = (last["step"] - first["step"]) * TRAIN_BATCH / (last["ts"] - first["ts"])
        counts = ranks_launches(reports)
        want_counts = {**{k: 0 for k in KERNELS},
                       **{k: n * steps * DP_RANKS for k, n in per_step.items()}}
        print(f"{label} (CLI, gloo, deterministic mode, bf16, global batch {TRAIN_BATCH}, "
              f"{TRAIN_BATCH // DP_RANKS} a rank): {steps} steps in {wall:.3f} s including the "
              f"ranks' start; steady {rate:.3f} clips/s over steps {first['step']}-"
              f"{last['step']} (rank 0's synchronized display points), {rate / DP_RANKS:.3f} a "
              f"rank", flush=True)
        print(f"{label}: two ranks share one card through gloo (host-staged collectives), so "
              f"these rates are not a scaling number", flush=True)
        for r in reports:
            mine = {k: r["launches"][_launch_key(KERNELS[k][0])] for k in per_step}
            print(f"{label} rank {r['rank']}: peak device memory "
                  f"{r['peak_bytes'] / 2**30:.3f} GiB; launches {mine}", flush=True)
            require(mine == {k: n * steps for k, n in per_step.items()},
                    f"{label} rank {r['rank']} launches {mine}")
        require(counts == want_counts, f"{label} launches {counts}, {steps} steps imply "
                                       f"{want_counts}")
        by_path[name] = counts
        got = load_reference_bin(os.path.join(out, "pytorch_model.bin.0"))
        losses = [r["loss"] for r in shown]
        same = [k for k in want if torch.equal(got[k], want[k])]
        worst = _rel_diff(got, want)
        print(f"{label} against one process with --gradient_accumulation_steps {DP_RANKS} "
              f"(deterministic mode, dropout 0.1, {steps} steps): losses {losses} against "
              f"{want_losses}; {len(same)} of {len(want)} tensors bitwise equal, the largest "
              f"difference {worst[0]:.3e} of its tensor's norm ({worst[1]}; limit "
              f"{DP_PARAM_RTOL if zero1 else 'bitwise'})", flush=True)
        if zero1:
            require(worst[0] <= DP_PARAM_RTOL and max(
                abs(a - b) / abs(b) for a, b in zip(losses, want_losses)) <= DP_PARAM_RTOL,
                f"D1: --zero1 strays from the accumulated run: {worst}")
        else:
            require(len(same) == len(want) and losses == want_losses,
                    "D1: two ranks are not bitwise one process accumulating two micro-batches")
        shutil.rmtree(out)
    return by_path, (want, want_losses)


def phase_dp_pretrain(tmp: str, vocab: str, files, init: str) -> dict:
    """D2: stage I on two ranks with --zero1 from the weights in ``init``,
    preempted, resumed without it, in deterministic mode; returns the two
    spawns' launches."""
    with deterministic_mode():
        return _dp_pretrain(tmp, vocab, files, init)


def _dp_pretrain(tmp: str, vocab: str, files, init: str) -> dict:
    ranks = ["--n_gpu", str(DP_RANKS), "--dist_backend", "gloo", "--epochs", "1", "--batch_size",
             str(PRE1_CLIPS), "--init_model", init]

    def run(name: str, *extra, accum: int = 1):
        out = os.path.join(tmp, f"dp_pretrain_{name}")
        argv = _pretrain_argv(files, vocab, out, 1) + ranks + list(extra)
        argv[argv.index("--gradient_accumulation_steps") + 1] = str(accum)
        steps = pretrain.main(argv)[0]
        return steps, out, (ranks_launches(dp_mesh.spawn.ranks) if accum == 1 else None)

    t0 = time.perf_counter()
    # the uninterrupted run: one process accumulating the two ranks'
    # micro-batches (D1: bitwise two replicated ranks), not a third spawn
    n, a, _ = run("uninterrupted", "--n_gpu", "1", accum=DP_RANKS)
    k, _, first = run("resumed", "--zero1", "--inject_preempt_after", str(DP_PREEMPT_AFTER))
    m, c, then = run("resumed", "--load_checkpoint")
    counts = {key: first[key] + then[key] for key in first}
    sa, _ = restore_checkpoint(os.path.join(a, "train_state.pt"))
    sc, _ = restore_checkpoint(os.path.join(c, "train_state.pt"))

    def moments(state):
        return {f"{i}.{key}": st[key] for i, st in state["optimizer"]["state"].items()
                for key in ("m", "v")}

    params, moms = _rel_diff(sc["model"], sa["model"]), _rel_diff(moments(sc), moments(sa))
    la, lc = _train_losses(a), _train_losses(c)
    loss_rel = max(abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(lc, la))
    print(f"D2 pretraining stage I, {DP_RANKS} ranks --zero1 ({PRE1_CLIPS // DP_RANKS} clips x "
          f"{PRE_PAIRS} pairs a rank, deterministic mode, {n} steps in one epoch; three runs in "
          f"{time.perf_counter() - t0:.1f} s): preempted after {k} step(s), resumed without "
          f"--zero1 to step {m}; against the uninterrupted run (one process accumulating the "
          f"ranks' {DP_RANKS} micro-batches): parameters "
          f"{params[0]:.3e} of their tensor's norm ({params[1]}), moments {moms[0]:.3e} "
          f"({moms[1]}), losses {loss_rel:.3e} rel, BertAdam's steps "
          f"{sc['optimizer']['steps']} and {sa['optimizer']['steps']} (limit {DP_PARAM_RTOL})",
          flush=True)
    require(k == DP_PREEMPT_AFTER and n == m == 4
            and sc["optimizer"]["steps"] == sa["optimizer"]["steps"] == 4
            and [r["step"] for r in lc] == [r["step"] for r in la]
            and max(params[0], moms[0], loss_rel) <= DP_PARAM_RTOL,
            "D2: the run resumed across layouts strays from the uninterrupted one")
    want = {**{k: 0 for k in KERNELS},
            **{key: v * DP_RANKS * n // PRE1_ACCUM
               for key, v in _pretrain_launches_per_step(1).items()}}
    require(counts == want, f"D2 launches {counts} (preempted and resumed), {n} steps imply "
                            f"{want}")
    for out in (a, c):
        shutil.rmtree(out)
    return counts


def phase_dp_nccl(tmp: str, vocab: str, check, init: str, ds) -> tuple:
    """D3: --n_gpu 1 --zero1 in a process group of one rank on NCCL: FT-Align
    through the CLI (in this process, from the weights in ``init``), then the
    ZeRO-1 probe at FT-Align's parameters, profiled; then K2's ZeRO-1 route
    in such a group (``ds``'s batches). Returns the CLI run's launches and
    the route's."""
    out = os.path.join(tmp, "dp_nccl")
    reset_launches()
    steps, _ = task_retrieval.main(_dp_argv(check, vocab, out, "--n_gpu", "1", "--zero1",
                                            "--init_model", init))
    counts = read_launches()
    want = {**{k: 0 for k in KERNELS},
            **{k: n * steps for k, n in _launches_per_step("ft_align").items()}}
    with open(os.path.join(out, "metrics.jsonl")) as f:
        [mesh] = [r for r in map(json.loads, f) if r["kind"] == "mesh"]
    shown = _train_losses(out)
    print(f"D3 FT-Align --n_gpu 1 --zero1 (CLI): {steps} steps, losses "
          f"{[round(r['loss'], 6) for r in shown]}; the run's mesh record {mesh}", flush=True)
    require(steps == DP_CHECK_STEPS and all(math.isfinite(r["loss"]) for r in shown)
            and mesh["backend"] == "nccl" and mesh["ranks"] == 1 and mesh["zero1"]
            and mesh["step_route"] == "graph", f"D3: the CLI run ({steps} steps, {mesh})")
    require(counts == want, f"D3 launches {counts}, {steps} steps imply {want}")
    shutil.rmtree(out)
    [rep] = zero1_ab.main(["--device", "cuda", "--n_gpu", "1", "--train_sim_after_cross",
                           "--steps", "2", "--profile", "2"])  # cut from 3 and 3
    print(f"D3 ZeRO-1 against BertAdam at FT-Align's {rep['params']:,} parameters, one rank on "
          f"{rep['backend']}, f32 moments: the largest parameter difference "
          f"{max(x['max_rel_diff'] for x in rep['steps']):.3e} of its tensor's scale; device ms "
          f"an update (torch.profiler, collectives included) ZeRO-1 "
          f"{rep['zero1_device_ms']:.3f}, BertAdam {rep['replicated_device_ms']:.3f} (phase "
          f"13's FT-Align profile, PERF.md: 9.54); CUDA events around the update (host-paced) "
          f"{[round(x['zero1_ms'], 3) for x in rep['steps']]} against "
          f"{[round(x['replicated_ms'], 3) for x in rep['steps']]}; optimizer state "
          f"{rep['zero1_state_bytes'] / 2**30:.3f} GiB (m, v, the f32 master and the gradient "
          f"shard) against {rep['replicated_state_bytes'] / 2**30:.3f} GiB (m, v)", flush=True)
    require(rep["backend"] == "nccl"
            and all(x["max_rel_diff"] <= 1e-5 for x in rep["steps"]),
            f"D3: ZeRO-1 strays from BertAdam: {rep['steps']}")
    return counts, phase_k2_zero1(load_reference_bin(init), ds)


def phase_k2_zero1(sd: dict, ds) -> dict:
    """K2's ZeRO-1 route: FT-Align block --zero1 from the weights ``sd`` in a
    process group of one rank on NCCL (as --n_gpu 1 --zero1 joins), on
    ``ds``'s batches, in deterministic mode; returns its launches."""
    mesh = dp_mesh.init("cuda")
    try:
        require(mesh.backend == "nccl" and mesh.size == 1, f"K2's ZeRO-1 group: {mesh}")
        cfg = UniVLConfig.base(max_words=48, max_frames=48, compute_dtype="bfloat16",
                               batch_size_per_device=TRAIN_BATCH, train_sim_after_cross=True,
                               use_fused_ffn="block")
        with deterministic_mode():
            r = _graph_route("K2", "FT-Align (--fused_ffn block --zero1, a one-rank NCCL group)",
                             cfg, sd, _k2_steps(ds, 2 * K2_ALIGN_K, TRAIN_BATCH, 1),
                             _launches_per_step("ft_align"), mesh=mesh)
        counts = r.pop("counts")
        del r
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    return counts


def write_seeded_bins(tmp: str, vocab: str) -> tuple:
    """The seeded inits (seed 0, the CLIs' --seed here) that D1, D3 and T1
    (FT-Align), D2 (stage I) and T2 (caption) start from, drawn once and
    written as .bin files (--init_model), so no rank draws the 168 M
    weights on the CPU: the same weights each rank would draw. Stage I's
    model is FT-Align's first modules (bert, visual, normalize_video, drawn
    first in the same order), so its file is FT-Align's first keys."""
    t0 = time.perf_counter()
    n_vocab = len(WordPieceTokenizer(vocab))

    def seeded(**kw):
        cfg = UniVLConfig.base(**kw)
        return seeded_weights(cfg.replace(bert=cfg.bert.replace(vocab_size=n_vocab),
                                          decoder=cfg.decoder.replace(vocab_size=n_vocab)))

    paths = tuple(os.path.join(tmp, f"{name}_seed0.bin") for name in ("ft_align", "stage1",
                                                                      "caption"))
    align = seeded(train_sim_after_cross=True)
    torch.save(align, paths[0])
    torch.save({k: v for k, v in align.items() if k.startswith(("bert.", "visual.",
                                                                 "normalize_video."))},
               paths[1])
    del align
    torch.save(seeded(stage_two=True, task_type="caption"), paths[2])
    print(f"seeded inits for D1-D3 and T1-T2 written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


def _zero_grad_param(name: str) -> bool:
    """Parameters whose gradient is zero in exact arithmetic (the key biases;
    FT-Align's similarity_dense.bias)."""
    return name.endswith(("key.bias", "similarity_dense.bias"))


def _tp_launches_per_step() -> dict:
    """What a T1 rank launches in a step (its 16 rows): #2 as one process
    does (on the rank's heads), and for every #4 and #5 call of one process
    the split pieces: each GEMM piece once a call, the rows kernel and the
    LayerNorm head once for each of #4 and #5."""
    one = _launches_per_step("ft_align")
    n = one["ffn_block_fwd"]
    return {"train_attention_fwd": one["train_attention_fwd"],
            "train_attention_bwd": one["train_attention_bwd"],
            "ffn_split_fwd": n, "dense_split_fwd": n, "split_rows": 2 * n, "split_bwd_ln": 2 * n,
            "ffn_split_bwd": n, "ffn_split_bwd_rows": n, "dense_split_bwd": n}


def phase_tp_train(tmp: str, vocab: str, files, init: str, reference) -> dict:
    """T1: FT-Align at dp 2 x tp 2 with sequence parallelism and ZeRO-1,
    four gloo ranks on the card, deterministic mode, against D1's
    accumulated run (``reference``: its weights and losses). Returns the
    ranks' launches."""
    with deterministic_mode():
        return _tp_train(tmp, vocab, files, init, reference)


def _tp_train(tmp: str, vocab: str, files, init: str, reference) -> dict:
    want, want_losses = reference
    label = (f"T1 FT-Align --n_gpu {TP_RANKS} --tensor_parallel {TP_SIZE} --sequence_parallel "
             f"--zero1")
    out = os.path.join(tmp, "tp_ft_align")
    t0 = time.perf_counter()
    steps, _ = task_retrieval.main(_dp_argv(files, vocab, out, *TP_FLAGS, "--init_model", init))
    wall = time.perf_counter() - t0
    reports = dp_mesh.spawn.ranks
    _step_route(out, "eager: tensor and sequence parallelism")
    shown = _train_losses(out)
    require(steps == DP_STEPS and len(shown) == steps
            and all(math.isfinite(r["loss"]) for r in shown),
            f"{label}: display points {[(r['step'], r['loss']) for r in shown]}")
    first, last = shown[1], shown[-1]
    rate = (last["step"] - first["step"]) * TRAIN_BATCH / (last["ts"] - first["ts"])
    print(f"{label} (CLI, gloo, deterministic mode, bf16, global batch {TRAIN_BATCH}, "
          f"{TRAIN_BATCH * TP_SIZE // TP_RANKS} a dp rank): {steps} steps in {wall:.3f} s "
          f"including the ranks' start; steady {rate:.3f} clips/s over steps {first['step']}-"
          f"{last['step']} (rank 0's synchronized display points); four ranks share one card "
          f"through gloo (host-staged collectives): not a scaling number", flush=True)
    per_step = _tp_launches_per_step()
    for r in reports:
        mine = {k: r["launches"][_launch_key(KERNELS[k][0])] for k in KERNELS}
        print(f"{label} rank {r['rank']}: peak device memory {r['peak_bytes'] / 2**30:.3f} GiB; "
              f"launches { {k: v for k, v in mine.items() if v} }", flush=True)
        require(mine == {**{k: 0 for k in KERNELS}, **{k: n * steps for k, n in per_step.items()}},
                f"{label} rank {r['rank']} launches {mine}, {steps} steps imply "
                f"{ {k: n * steps for k, n in per_step.items()} }")
    counts = ranks_launches(reports)
    got = load_reference_bin(os.path.join(out, "pytorch_model.bin.0"))
    init_sd = load_reference_bin(init)
    losses = [r["loss"] for r in shown]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    diff = {k: float((got[k].float() - v.float()).norm()) for k, v in want.items()}
    moved = {k: max(float((v.float() - init_sd[k].float()).norm()), 1e-30)
             for k, v in want.items()}
    of_norm = {k: diff[k] / max(float(v.float().norm()), 1e-30) for k, v in want.items()
               if not _zero_grad_param(k)}
    of_move = {k: diff[k] / moved[k] for k in of_norm}
    zero = {k: float((got[k].float() - v.float()).abs().max()) for k, v in want.items()
            if _zero_grad_param(k)}
    top = sorted(of_move.items(), key=lambda kv: -kv[1])[:5]
    worst_norm = max(of_norm.items(), key=lambda kv: kv[1])
    worst_zero = max(zero.items(), key=lambda kv: kv[1])
    print(f"{label} against D1's one process with --gradient_accumulation_steps {DP_RANKS} "
          f"(deterministic mode, dropout 0.1, {steps} steps): losses {losses} against "
          f"{want_losses} ({loss_rel:.3e} rel, limit {TP_LOSS_RTOL}); the largest parameter "
          f"differences as a share of the tensor's movement over the run "
          f"{[(k, float(f'{v:.3e}')) for k, v in top]} (limit {TP_MOVE_FRAC}); the largest of "
          f"its norm {worst_norm[1]:.3e} ({worst_norm[0]}); zero-gradient parameters "
          f"{worst_zero[1]:.3e} absolute ({worst_zero[0]}; limit {TP_ZERO_PARAM}); "
          f"{sum(torch.equal(got[k], want[k]) for k in want)} of {len(want)} tensors bitwise "
          f"equal", flush=True)
    require(loss_rel <= TP_LOSS_RTOL and top[0][1] <= TP_MOVE_FRAC
            and worst_zero[1] <= TP_ZERO_PARAM, "T1 strays from D1's reference")
    shutil.rmtree(out)
    return counts


def phase_tp_caption(tmp: str, vocab: str, files, init: str) -> dict:
    """T2: caption fine-tuning (stage two, --fused_ln) at --n_gpu 2
    --tensor_parallel 2 in f32 against one process, deterministic mode.
    Returns the ranks' launches (an f32 run: not a main path)."""
    with deterministic_mode():
        return _tp_caption(tmp, vocab, files, init)


def _tp_caption(tmp: str, vocab: str, files, init: str) -> dict:
    train_csv, _, data, feats = files
    with open(train_csv) as f:
        header, first = f.read().splitlines()[:2]  # one video of TRAIN_CLIPS clips
    csv = os.path.join(tmp, "t2.csv")
    with open(csv, "w") as f:
        f.write(f"{header}\n{first}\n")
    flags = ["--do_train", "--device", "cuda", "--stage_two", "--datatype", "youcook",
             "--vocab_file", vocab, "--train_csv", csv, "--data_path", data, "--features_path",
             feats, "--fused_ln", "--compute_dtype", "float32", "--lr", "3e-5",
             "--warmup_proportion", "0.1", "--coef_lr", "0.1", "--epochs", "1", "--batch_size",
             str(T2_BATCH), "--max_words", str(T2_WORDS), "--max_frames", str(T2_FRAMES),
             "--n_display", "1", "--seed", "0", "--no_preempt_checkpoint", "--init_model", init]
    one, two = os.path.join(tmp, "t2_one"), os.path.join(tmp, "t2_tp")
    t0 = time.perf_counter()
    n = task_caption.main([*flags, "--output_dir", one, "--n_gpu", "1"])[0]
    m = task_caption.main([*flags, "--output_dir", two, "--n_gpu", str(TP_SIZE),
                           "--tensor_parallel", str(TP_SIZE), "--dist_backend", "gloo"])[0]
    counts = ranks_launches(dp_mesh.spawn.ranks)
    want, got = (load_reference_bin(os.path.join(d, "pytorch_model.bin.0")) for d in (one, two))
    lw, lg = ([r["loss"] for r in _train_losses(d)] for d in (one, two))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lw))
    rel = {k: float((got[k] - v).norm()) / max(float(v.norm()), 1e-30)
           for k, v in want.items() if not _zero_grad_param(k)}
    zero = max(float((got[k] - v).abs().max()) for k, v in want.items() if _zero_grad_param(k))
    worst = max(rel.items(), key=lambda kv: kv[1])
    print(f"T2 caption --stage_two --fused_ln f32, --n_gpu {TP_SIZE} --tensor_parallel "
          f"{TP_SIZE} (gloo, deterministic mode, {T2_BATCH} clips a step, {T2_WORDS} words, "
          f"{T2_FRAMES} frames, full width) against one process, {n} and {m} steps in "
          f"{time.perf_counter() - t0:.1f} s: losses {lg} against {lw} ({loss_rel:.3e} rel); "
          f"the largest parameter difference {worst[1]:.3e} of its tensor's norm ({worst[0]}), "
          f"the key biases {zero:.3e} absolute (limits {T2_RTOL}, {AGREE_ZERO_PARAM}); the ranks' "
          f"launches { {k: v for k, v in counts.items() if v} }", flush=True)
    require(n == m == T2_CLIPS // T2_BATCH and loss_rel <= T2_RTOL and worst[1] <= T2_RTOL
            and zero <= AGREE_ZERO_PARAM and counts["train_attention_fwd_cuda_cores"] > 0
            and counts["layernorm_fwd"] > 0, "T2 strays from one process")
    for d in (one, two):
        shutil.rmtree(d)
    return counts


PP_KERNELS = {"bfloat16": ("train_attention_fwd", "train_attention_bwd", "ffn_block_fwd",
                           "ffn_block_bwd", "dense_block_fwd", "dense_block_bwd"),
              "float32": ("train_attention_fwd_cuda_cores", "train_attention_bwd_cuda_cores",
                          "ffn_block_fwd_cuda_cores", "ffn_block_bwd_cuda_cores",
                          "dense_block_fwd_cuda_cores", "dense_block_bwd_cuda_cores")}


def _tower(dropout: float):
    return UniVLConfig.base().bert.replace(hidden_dropout_prob=dropout,
                                           attention_probs_dropout_prob=dropout)


def _pp_sequential(sd: dict, x: np.ndarray, probe: np.ndarray, dtype: str) -> dict:
    """G1's reference: the sequential stack in this process on the same
    weights and rows, dropout 0, the same loss; its output, gradients, step
    times and peak memory."""
    dt = pp_replay.DTYPES[dtype]
    stack = TransformerStack(_tower(0.0), dt, "cuda", use_fused_ffn="block")
    stack.load_state_dict(sd, strict=True)
    stack.train()
    xt = torch.from_numpy(x).cuda().to(dt)
    pt = torch.from_numpy(probe).cuda()
    mask = torch.ones(PP_BATCH, PP_WORDS, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    seconds = []
    for _ in range(PP_TIMED if dtype == "bfloat16" else 1):
        stack.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = stack(xt, mask)
        (y.float() * pt).mean().backward()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    out = {"y": y.detach().float().cpu(), "seconds": seconds,
           "grads": {k: p.grad.detach().cpu() for k, p in stack.named_parameters()},
           "peak_bytes": torch.cuda.max_memory_allocated() - held,
           "param_bytes": sum(p.numel() * p.element_size() for p in stack.parameters())}
    del stack
    torch.cuda.empty_cache()
    return out


def _pp_agreement(dtype: str, want: dict, ranks: list) -> None:
    """The two ranks' delivered output (bitwise equal on both) and gradients
    (each layer's from the stage that holds it) against the sequential run."""
    runs = [r["pipelines"][dtype] for r in ranks]
    require(all(torch.equal(run["y"], runs[0]["y"]) for run in runs),
            f"G1 {dtype}: the ranks' delivered outputs differ")
    got_y = runs[0]["y"].float()
    y_rel = float((got_y - want["y"]).norm()) / float(want["y"].norm())
    grads = {k: g for run in runs for k, g in run["grads"].items()}
    require(sorted(grads) == sorted(want["grads"]), f"G1 {dtype}: gradients of {len(grads)} "
                                                     f"tensors, the stack has {len(want['grads'])}")
    rel = {}
    for k, g in want["grads"].items():
        scale = want["grads"][k.replace("key.bias", "query.bias")] if k.endswith("key.bias") else g
        rel[k] = float((grads[k] - g).norm()) / max(float(scale.norm()), 1e-30)
    worst = max(rel.items(), key=lambda kv: kv[1])
    limit = PP_RTOL[dtype]
    same = sum(torch.equal(grads[k], g) for k, g in want["grads"].items())
    print(f"G1 {dtype} against the sequential stack (dropout 0): output {y_rel:.3e} of its norm, "
          f"the largest gradient difference {worst[1]:.3e} of its norm ({worst[0]}; the key "
          f"biases of their query bias's); {same} of {len(rel)} gradients bitwise equal; limit "
          f"{limit}", flush=True)
    require(y_rel <= limit and worst[1] <= limit, f"G1 {dtype} strays from the sequential stack")


def _rank_counts(launches: dict) -> dict:
    return {name: launches[_launch_key(entry)] for name, (entry, _, _) in KERNELS.items()}


def phase_pipeline(tmp: str, vocab: str, ret_files, init: str, caption_bin: str,
                   clips) -> tuple:
    """G1 (GPipe on two ranks) and E1 (the fan-out of the evaluator, the
    retrieval index and the caption generator) in one spawn of
    parallel/pp_replay, each against one process. Returns (the main paths'
    launches by path, the f32 run's launches)."""
    with deterministic_mode():
        return _pipeline(tmp, vocab, ret_files, init, caption_bin, clips)


def _fanout_references(model, init: str, vocab: str, caption_bin: str, clips) -> dict:
    """E1's index and caption fan-outs in one process that runs a rank's
    BATCH / 2 rows a call: the index's store and searches (``model``, the
    FT-Align weights ``init``), the captions of one BATCH-clip request in two halves
    (the caption weights, the server's fused path), each on its default
    (CUDA-graph) route; and the specs of their fan-outs."""
    tok, half = WordPieceTokenizer(vocab), BATCH // PP_STAGES
    ids = [f"e{i}" for i in range(E1_INDEX_CLIPS)]
    index = VideoRetrievalIndex(model, tok, "cuda", batch_size=half, store_full=True)
    index.add(clips[:E1_INDEX_CLIPS], ids=ids)
    results = {r: index.search(QUERIES, top_k=TOP_K, rerank=r) for r in (0, RERANK)}
    cap_cfg = UniVLConfig.base(max_words=MAX_WORDS, max_frames=48, stage_two=True,
                               task_type="caption", compute_dtype="bfloat16")
    cap_model = UniVL(cap_cfg, device="cuda")
    cap_model.load_state_dict(load_reference_bin(caption_bin), strict=True)
    options = dict(beam_size=BEAM, max_len=MAX_WORDS, fused_decode=True, fused_vocab=True)
    gen = CaptionGenerator(cap_model.eval(), tok, "cuda", **options)
    batch = _caption_batch(tok, clips, BATCH, 0, transcripts=True)
    parts = [gen.decode({k: v[i:i + half] for k, v in batch.items()}) for i in (0, half)]
    out = {"store": (index.video_emb, index.vis_full, index.vm_full), "results": results,
           "tokens": torch.cat([t for t, _, _ in parts]).cpu(),
           "scores": torch.cat([x for _, x, _ in parts]).cpu(), "steps": [n for _, _, n in parts],
           "specs": {"indexes": [dict(name="e1", config=model.cfg, weights=init, vocab=vocab,
                                      batch_size=BATCH, videos=clips[:E1_INDEX_CLIPS], ids=ids,
                                      queries=QUERIES, top_k=TOP_K, reranks=(0, RERANK))],
                     "captions": [dict(name="e1", config=cap_cfg, weights=caption_bin,
                                       vocab=vocab, batches=[batch],
                                       options=dict(batch_size=BATCH, **options))]}}
    del index, gen, cap_model
    return out


def _fanout_agreement(ranks: list, want: dict) -> dict:
    """E1's index and caption fan-outs on each rank against one process,
    with the limits stated before the first run: the store, every search's
    ids and scores (with and without rerank), the tokens and the scores
    bitwise; each rank's steps those of its half in one process; the
    launches on the device (replays counted) what the traffic implies.
    Returns the launches by path over the ranks."""
    cfg = UniVLConfig.base()
    index_launches = {**{k: 0 for k in KERNELS}, "eval_attention": (
        -(-E1_INDEX_CLIPS // BATCH) * cfg.visual.num_hidden_layers
        + 2 * -(-N_QUERIES // BATCH) * cfg.bert.num_hidden_layers
        + -(-N_QUERIES // RERANK_TILE) * cfg.cross.num_hidden_layers)}
    paths = {"index_fanout": {k: 0 for k in KERNELS}, "caption_fanout": {k: 0 for k in KERNELS}}
    for r, res in enumerate(ranks):
        got = res["indexes"]["e1"]
        n = _rank_counts(got["launches"])
        require(all(np.array_equal(a, b) for a, b in zip(
            (got["video_emb"], got["vis_full"], got["vm_full"]), want["store"]))
                and got["results"] == want["results"] and n == index_launches,
                f"E1 index rank {r}: the store, the searches or the launches {n} stray from one "
                f"process's ({index_launches})")
        cap = res["captions"]["e1"]
        steps = cap["steps"][0]
        c = _rank_counts(cap["launches"])
        implied = {**{k: 0 for k in KERNELS}, **_decode_launches(steps, True, False)}
        require(torch.equal(cap["tokens"][0], want["tokens"])
                and torch.equal(cap["scores"][0], want["scores"])
                and steps == want["steps"][r] and c == implied,
                f"E1 captions rank {r}: tokens, scores, steps {steps} (one process "
                f"{want['steps'][r]}) or launches {c} ({implied}) stray")
        print(f"E1 index rank {r} of {PP_STAGES} ({E1_INDEX_CLIPS} clips in adds of {BATCH}, "
              f"{BATCH // PP_STAGES} a rank, bf16, CUDA graphs): the store and {N_QUERIES}-query "
              f"searches with rerank 0 and {RERANK} bitwise one process's; #1 "
              f"{n['eval_attention']} launches (replays counted); captions ({BATCH} clips, "
              f"{BATCH // PP_STAGES} a rank): tokens and scores bitwise one process's, "
              f"{steps} steps (its half in one process {want['steps'][r]}), launches "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
        for path, counts in (("index_fanout", n), ("caption_fanout", c)):
            for k, v in counts.items():
                paths[path][k] += v
    return paths


def _pipeline(tmp: str, vocab: str, ret_files, init: str, caption_bin: str, clips) -> tuple:
    t0 = time.perf_counter()
    full = torch.load(init, map_location="cpu", weights_only=True)
    sd = {k[len("bert.encoder."):]: v for k, v in full.items() if k.startswith("bert.encoder.")}
    del full
    stack_path = os.path.join(tmp, "g1_stack.pt")
    torch.save(sd, stack_path)
    rng = np.random.RandomState(5)
    x = rng.randn(PP_BATCH, PP_WORDS, 768).astype(np.float32)
    probe = rng.randn(PP_BATCH, PP_WORDS, 768).astype(np.float32)
    want = {dt: _pp_sequential(sd, x, probe, dt) for dt in ("float32", "bfloat16")}

    _, test_csv, _, feats = ret_files
    cfg = UniVLConfig.base(max_words=48, max_frames=48, train_sim_after_cross=True,
                           compute_dtype="bfloat16")
    ds = MsrvttRetrievalEvalDataset(test_csv, feats, WordPieceTokenizer(vocab), max_words=48,
                                    max_frames=48, seed=0)
    rows = collate([ds[i] for i in range(E1_CLIPS)])
    keys = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")

    def batches(n):
        return [{k: rows[k][i:i + n] for k in keys} for i in range(0, E1_CLIPS, n)]

    model = UniVL(cfg, device="cuda")
    model.load_state_dict(load_reference_bin(init), strict=True)
    one = RetrievalEvaluator(model.eval(), batch_size=E1_BATCH // PP_STAGES)
    e1_want = {}
    for mode in ("joint", "cross"):
        metrics = one.evaluate(iter(batches(E1_BATCH // PP_STAGES)), mode=mode)
        e1_want[mode] = (one.similarity, metrics, dict(one.seconds))
    fan_want = _fanout_references(model, init, vocab, caption_bin, clips)
    del model, one
    torch.cuda.empty_cache()
    print(f"G1/E1 references (one process: the sequential stack f32 and bf16, the evaluator, "
          f"the index, the captions) in {time.perf_counter() - t0:.1f} s", flush=True)

    tf = dict(kind="transformer", weights=stack_path, x=x, probe=probe,
              key_mask=np.ones((PP_BATCH, PP_WORDS), np.int32), microbatches=PP_MICRO)
    spec = {"pipelines": [
        dict(name="float32", config=_tower(0.0), compute_dtype="float32", **tf),
        dict(name="bfloat16", config=_tower(0.0), compute_dtype="bfloat16", repeat=PP_TIMED,
             **tf),
        dict(name="dropout", config=_tower(0.1), compute_dtype="bfloat16", repeat=2, **tf)],
        "evals": [dict(name="e1", config=cfg, weights=init, batches=batches(E1_BATCH),
                       modes=("joint", "cross"), batch_size=E1_BATCH, cross_text_block=8,
                       cross_video_block=64)], **fan_want["specs"]}
    spec_path, out = os.path.join(tmp, "pp_spec.pt"), os.path.join(tmp, "pp_out")
    torch.save(spec, spec_path)
    t1 = time.perf_counter()
    pp_replay.main(["--spec", spec_path, "--output", out, "--device", "cuda", "--n_gpu",
                    str(PP_STAGES), "--pipeline_parallel", str(PP_STAGES), "--dist_backend",
                    "gloo"])
    wall = time.perf_counter() - t1
    reports = dp_mesh.spawn.ranks
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(PP_STAGES)]
    shutil.rmtree(out)
    print(f"G1 + E1: one spawn of {PP_STAGES} gloo ranks sharing the card, {wall:.1f} s with "
          f"the ranks' start", flush=True)

    for dtype in ("float32", "bfloat16"):
        _pp_agreement(dtype, want[dtype], ranks)
    per_layer = PP_MICRO * (12 // PP_STAGES)
    counts = {}
    for name in ("float32", "bfloat16", "dropout"):
        dtype = "float32" if name == "float32" else "bfloat16"
        steps = len(ranks[0]["pipelines"][name]["seconds"])
        mine = [_rank_counts(r["pipelines"][name]["launches"]) for r in ranks]
        expect = {**{k: 0 for k in KERNELS}, **{k: per_layer * steps for k in PP_KERNELS[dtype]}}
        for r, got in enumerate(mine):
            require(got == expect, f"G1 {name} rank {r} launches "
                                   f"{ {k: v for k, v in got.items() if v} }, want {expect}")
        counts[name] = {k: sum(m[k] for m in mine) for k in KERNELS}
    for r, res in enumerate(ranks):
        drop = res["pipelines"]["dropout"]
        require(drop["repeat_equal"] and res["pipelines"]["bfloat16"]["repeat_equal"]
                and not torch.equal(drop["y"], res["pipelines"]["bfloat16"]["y"]),
                f"G1 rank {r}: two deterministic runs differ, or dropout 0.1 did nothing")
        run = res["pipelines"]["bfloat16"]
        require(2 * run["param_bytes"] == want["bfloat16"]["param_bytes"]
                and run["layers"] == list(range(r * 6, (r + 1) * 6)),
                f"G1 rank {r}: layers {run['layers']}, {run['param_bytes']} parameter bytes")
        print(f"G1 rank {r} (stage {r}, layers {run['layers'][0]}-{run['layers'][-1]}): "
              f"parameters {run['param_bytes'] / 2**20:.1f} MiB (the stack's "
              f"{want['bfloat16']['param_bytes'] / 2**20:.1f}); peak device memory f32 "
              f"{res['pipelines']['float32']['peak_bytes'] / 2**30:.3f} GiB, bf16 "
              f"{run['peak_bytes'] / 2**30:.3f} GiB; bf16 step s "
              f"{[round(t, 4) for t in run['seconds']]}, dropout 0.1 "
              f"{[round(t, 4) for t in drop['seconds']]}; two runs at 0.1 bitwise "
              f"equal; launches a step {per_layer} of #2, #4 and #5 forward and backward",
              flush=True)
    seq = want["bfloat16"]
    print(f"G1 step (bf16, {PP_BATCH} x {PP_WORDS}, forward and backward): pipeline "
          f"{float(np.median(ranks[0]['pipelines']['bfloat16']['seconds'][1:])) * 1e3:.3f} ms "
          f"against the sequential stack's {float(np.median(seq['seconds'][1:])) * 1e3:.3f} ms "
          f"(peak {seq['peak_bytes'] / 2**30:.3f} GiB above the weights held); two ranks on "
          f"one card with host-staged gloo hops: not a scaling number", flush=True)

    # #1 a rank: 18 encoder layers a batch; the cross tower's 2 in each of a
    # stripe's video blocks
    encode = -(-E1_CLIPS // E1_BATCH) * (cfg.bert.num_hidden_layers + cfg.visual.num_hidden_layers)
    cross = (-(-E1_CLIPS // (8 * PP_STAGES)) * -(-E1_CLIPS // 64) * cfg.cross.num_hidden_layers)
    per_rank = {"joint": encode, "cross": encode + cross}
    e1 = {k: 0 for k in KERNELS}
    for mode, (sim, metrics, seconds) in e1_want.items():
        for r, res in enumerate(ranks):
            got = res["evals"]["e1"][mode]
            err = float(np.abs(got["sim"] - sim).max())
            same = {k: got["metrics"][k] for k in metrics} == metrics
            n = _rank_counts(got["launches"])
            print(f"E1 {mode} rank {r} of {PP_STAGES} ({E1_CLIPS} clips, bf16): max |dsim| "
                  f"{err:.3e} against one process (limit {E1_ATOL[mode]}; scores span "
                  f"{float(np.ptp(sim)):.4f}); metrics {got['metrics']}, one process {metrics}; "
                  f"encode {got['seconds']['encode_s']:.3f} s, similarity "
                  f"{got['seconds']['similarity_s']:.3f} s (one process "
                  f"{seconds['encode_s']:.3f}, {seconds['similarity_s']:.3f}); #1 "
                  f"{n['eval_attention']} launches", flush=True)
            require(err <= E1_ATOL[mode] and same, f"E1 {mode} rank {r} strays from one process")
            require(n == {**{k: 0 for k in KERNELS}, "eval_attention": per_rank[mode]},
                    f"E1 {mode} rank {r} launches {n}, want {per_rank[mode]} of #1")
            e1["eval_attention"] += n["eval_attention"]
    by_path = {"pp_gpipe": {k: counts["bfloat16"][k] + counts["dropout"][k] for k in KERNELS},
               "eval_fanout": e1, **_fanout_agreement(ranks, fan_want)}
    # the ranks' reports hold the wrappers' counts: the fan-outs' graphs by capture
    total = ranks_launches(reports)
    runs = [res[kind]["e1"] for res in ranks for kind in ("indexes", "captions")]
    runs += [res["evals"]["e1"][mode] for res in ranks for mode in e1_want]
    wrappers = {k: sum(_rank_counts(run["wrapper_launches"])[k] for run in runs) for k in KERNELS}
    require(total == {k: by_path["pp_gpipe"][k] + counts["float32"][k] + wrappers[k]
                      for k in KERNELS},
            f"G1 + E1: the ranks' launches {total} are not the runs' sum")
    require(all(not {"jax", "univl_tpu"} & set(r["modules"]) for r in reports),
            "G1 + E1: a rank imported JAX")
    os.remove(stack_path)
    return by_path, counts["float32"]


def phase_native_tokenizer(vocab: str, youcook_data: str, msrvtt_json: str) -> None:
    """N1: the native tokenizer against the Python path on the fixture text."""
    tok = WordPieceTokenizer(vocab)
    os.environ["UNIVL_TPU_NO_NATIVE"] = "1"
    try:
        py = WordPieceTokenizer(vocab)
    finally:
        del os.environ["UNIVL_TPU_NO_NATIVE"]
    require(tok.native and not py.native, "N1: the native path is not active")
    with open(youcook_data, "rb") as f:
        texts = [str(t) for v in pickle.load(f).values() for k in ("text", "transcript")
                 for t in v[k]]
    with open(msrvtt_json) as f:
        texts += [s["caption"] for s in json.load(f)["sentences"]]
    texts += N1_UNICODE
    declined = sum(tok._native.tokenize_ids(t) is None for t in texts)
    rates = {}
    for name, t in (("native", tok), ("python", py)):
        t0 = time.perf_counter()
        ids = [t.convert_tokens_to_ids(t.tokenize(text)) for text in texts]
        rates[name] = (ids, sum(map(len, ids)) / (time.perf_counter() - t0))
    differ = sum(a != b for a, b in zip(rates["native"][0], rates["python"][0]))
    print(f"N1 native tokenizer ({native.library_path().split(os.sep)[-1]}): {len(texts)} texts "
          f"(YouCook2 and MSRVTT fixture captions and transcripts, {len(N1_UNICODE)} Unicode "
          f"strings), {differ} with ids other than the Python path's, {declined} declined by the "
          f"C++ path (Python path); {rates['native'][1]:,.0f} tokens/s native against "
          f"{rates['python'][1]:,.0f} Python (host clock, one thread)", flush=True)
    require(differ == 0 and declined == N1_DECLINED, "N1: the native path strays")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    CARD.append(smi.stdout.strip().splitlines()[0])
    print(CARD[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    nn_layers.fused_attention_masked = _recorded_attention
    beam_search.classify_topk = _recorded_topk
    # the CLIs and servers run in this process draw their seeded weights (168 M
    # numbers with numpy, seconds of CPU) once for each layout: the same draw
    cli_common.init_state_dict = seeded_weights
    LAUNCHES.__enter__()  # patches GraphCapture.record until the process ends
    t0 = time.perf_counter()
    bytecode = keep_bytecode()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {os.path.relpath(lib_path)} in {time.perf_counter() - t0:.1f} s", flush=True)
    bytecode.join()
    print(f"bytecode of {len(sys.modules)} loaded modules kept under {os.path.relpath(PYCACHE)} "
          f"for the spawned ranks, {time.perf_counter() - t0:.1f} s after the build began",
          flush=True)
    t0 = time.perf_counter()
    so = native.build()
    print(f"native tokenizer: {native.CXX} ({native.compiler_version()}) built "
          f"{os.path.relpath(so)} in {time.perf_counter() - t0:.1f} s", flush=True)

    stamp("build (phase 2)")
    measured = {**kernel_eval_attention(),
                "beam_reorder_groups": kernel_reorder(),
                "beam_decode_self_attention": kernel_decode_attention(),
                **kernel_vocab_topk(),
                **kernel_vocab_topk_transform(),
                **kernel_eval_attention_causal(),
                "reorder_rows": kernel_reorder_rows()}
    stamp("phase 3: #1, #7-#10")
    measured.update(kernel_train_attention())
    stamp("phase 3: #2")
    measured.update(kernel_ffn())
    stamp("phase 3: #3-#5")
    measured.update(kernel_layernorm())
    kernel_pretrain_shapes(measured)
    stamp("phase 3: #6 and the pretraining shapes")
    measured.update(kernel_tp_shapes())
    stamp("phase 3: the tensor-parallel shapes")
    by_path = {}  # main path: {kernel: launches}
    f32_runs = {}  # the f32 agreement runs (not main paths): {kernel: launches}
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
        stamp("retrieval serving (phases 4-6)")
        fused = phase_caption(tmp, vocab, paths, fused=True)
        fused_cls = phase_caption(tmp, vocab, paths, fused=True, fused_cls=True)
        unfused = phase_caption(tmp, vocab, paths, fused=False)
        by_path["caption"], by_path["caption_unfused"] = fused["launches"], unfused["launches"]
        by_path["retrieval_mode_both"] = unfused["mode_both"]
        by_path["caption_fused_cls"] = fused_cls["launches"]
        for name, other in (("unfused", unfused), ("--fused_cls", fused_cls)):
            same = sum(a == b for a, b in zip(fused["captions"], other["captions"]))
            print(f"fused vs {name} captions (bf16, same requests): {same} of "
                  f"{len(fused['captions'])} the same", flush=True)
        print(f"caption decode step, the transform unfused against --fused_cls (one profiled "
              f"request each): device busy {fused['per_step']['busy_ms']:.4f} against "
              f"{fused_cls['per_step']['busy_ms']:.4f} ms, kernel launches "
              f"{fused['per_step']['kernels']:.2f} against "
              f"{fused_cls['per_step']['kernels']:.2f}", flush=True)
        stamp("caption serving (phases 7-8)")
        reset_launches()
        phase_agreement(vocab, clips)
        f32_runs["serving agreement"] = read_launches()
        stamp("serving agreement (phase 9)")
        phase_caption_graphs(vocab, clips)
        stamp("C1")
        phase_index_graphs(vocab, clips)
        stamp("I1")
        files, ds = make_train_data(tmp, vocab)
        by_path["train"] = phase_train(tmp, vocab, files)
        phase_train_agreement(ds, f32_launches=f32_runs)
        stamp("FT-Joint (phases 10-12)")
        by_path["train_ft_align"] = phase_train(tmp, vocab, files, "ft_align")
        small, _ = make_train_data(tmp, vocab, n_videos=PALLAS_VIDEOS)
        by_path["train_ft_align_pallas"] = phase_train(tmp, vocab, small, "ft_align_pallas")
        control = phase_train_agreement(ds, "ft_align_xla")
        phase_train_agreement(ds, "ft_align", control, f32_runs)
        phase_train_agreement(ds, "ft_align_pallas", control, f32_runs)
        stamp("retrieval training (phases 10-15)")
        cap_files, cap_ds = make_caption_data(tmp, vocab)
        by_path.update(phase_caption_train(tmp, vocab, cap_files))
        phase_caption_agreement(cap_ds, f32_runs)
        stamp("caption training (phases 16-18)")
        by_path.update(phase_train_steps(ds))
        stamp("K1")
        ret_files, msrvtt_cap_files = make_msrvtt_data(tmp)
        by_path["caption_eval_msrvtt"] = phase_caption_eval_msrvtt(tmp, vocab, msrvtt_cap_files)
        eval_metrics = {}
        for mode in ("joint", "cross"):
            by_path[f"retrieval_eval_{mode}"], eval_metrics[mode] = phase_retrieval_eval(
                tmp, vocab, ret_files, mode)
        phase_eval_profile(vocab, ret_files, tmp)
        reset_launches()
        phase_retrieval_agreement(vocab, ret_files)
        f32_runs["retrieval eval agreement"] = read_launches()
        stamp("evaluation (phases 19-22)")
        by_path["eval_graphs"] = phase_eval_graphs(vocab, ret_files)
        stamp("I2")
        pre_files = make_pretrain_data(tmp)
        by_path["pretrain_stage_one"], stage1 = phase_pretrain(tmp, vocab, pre_files, 1)
        by_path["pretrain_stage_two"], stage2 = phase_pretrain(
            tmp, vocab, pre_files, 2, init=os.path.join(stage1, "pytorch_model.bin.1"))
        for out in (stage1, stage2):  # a train state is ~1.8 GB at this width
            shutil.rmtree(out)
        stamp("P1 and P2")
        phase_pretrain_resume(tmp, vocab, pre_files)
        stamp("P3 (with R3)")
        phase_pretrain_agreement(pre_files, vocab, f32_runs)
        stamp("pretraining (P1-P4)")
        remat_paths, remat_inits = phase_remat(ds, pre_files, vocab)
        by_path.update(remat_paths)
        stamp("R1")
        by_path.update(phase_train_steps_k2(remat_inits, pre_files, vocab))
        del remat_inits
        stamp("K2")
        l1_paths, x1_reference = phase_cli_graphs(tmp, vocab, files, ds, cap_files, cap_ds,
                                                  pre_files)
        by_path.update(l1_paths)
        stamp("L1")
        by_path["cli_trace_ft_joint"] = phase_cli_trace(tmp, x1_reference)
        stamp("X1")
        by_path["input_pipeline"] = phase_input_pipeline(ds, vocab, ret_files, tmp,
                                                         eval_metrics["joint"])
        phase_converter(tmp)
        stamp("R2-R4")
        dp_files, _ = make_train_data(tmp, vocab, n_videos=DP_STEPS * TRAIN_BATCH // TRAIN_CLIPS)
        check, _ = make_train_data(tmp, vocab, n_videos=DP_CHECK_STEPS * TRAIN_BATCH // TRAIN_CLIPS)
        align_bin, stage1_bin, caption_bin = write_seeded_bins(tmp, vocab)
        dp_counts, dp_reference = phase_dp_train(tmp, vocab, dp_files, align_bin)
        by_path.update(dp_counts)
        stamp("D1")
        by_path["tp_ft_align"] = phase_tp_train(tmp, vocab, dp_files, align_bin, dp_reference)
        stamp("T1")
        f32_runs["T2 caption tp 2"] = phase_tp_caption(tmp, vocab, cap_files, caption_bin)
        stamp("T2")
        by_path["dp_pretrain_zero1"] = phase_dp_pretrain(tmp, vocab, pre_files, stage1_bin)
        stamp("D2")
        by_path["dp_zero1_nccl"], by_path["train_steps_ft_align_zero1"] = phase_dp_nccl(
            tmp, vocab, check, align_bin, ds)
        stamp("D3 (with K2's ZeRO-1 route)")
        pp_paths, f32_runs["G1 f32"] = phase_pipeline(tmp, vocab, ret_files, align_bin,
                                                      caption_bin, clips)
        by_path.update(pp_paths)
        phase_native_tokenizer(vocab, files[1], ret_files[2])
        stamp("G1, E1 and N1")

    longest = check_attention_routes()
    check_vocab_routes()
    if longest not in ATTN_SHAPES:  # the caption eval's cross tower: timed here
        for name, row in kernel_eval_attention([longest]).items():
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"],
                                                row["max_abs_err"])
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        launches = sum(counts[name] for counts in by_path.values())
        if name in NO_ROUTE or name in F32_ROUTE:
            require(launches == 0, f"{name} launched on a main path: {launches}")
        else:
            require(launches > 0, f"{name} never launched on the main paths")
        f32 = {}
        if name in F32_ROUTE:
            f32 = {"f32_agreement_launches": {r: c[name] for r, c in f32_runs.items()}}
            require(sum(f32["f32_agreement_launches"].values()) > 0,
                    f"{name} never launched in the f32 agreement runs")
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches,
                     "launches_by_path": {p: c[name] for p, c in by_path.items()},
                     **f32, **measured[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
