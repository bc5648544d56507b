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
  8. the same server with --fused_cls (the classifier transform inside the
     vocab kernel, #10t, once a decode step in place of #10): launches,
     captions, a window, and one profiled request's device time and launches
     a decode step against phase 7's; then the unfused path: a server with
     --no-fused_decode --no-fused_vocab, in which the reorder kernel runs once
     per step;
  9. agreement with the CPU: a teacher-forced 47-step trajectory through the
     KV-cache decoder on the card in bf16 against the CPU in f32 (max |dlogp|
     under a stated limit), with and without --fused_cls, and the top-beam
     captions of 8 clips on the card in f32 against the CPU, with and without
     --fused_cls;
 10. the FT-Joint training slice: univl_tpu_torch.cli.task_retrieval
     --do_train at the full width of UniVLConfig.base (text 12, visual 6
     layers), bf16, batch 32, 40 steps on YouCook2-format fixtures: the loss
     at each display point, the steady clips/s, peak device memory, #2's
     launches (#2's tensor-core kernels, 18 forward and 18 backward a step)
     and a pytorch_model.bin.0 that loads back;
 11. torch.profiler over 3 steady training steps: device busy share, kernel
     time of #2, the GEMMs, the optimizer and the rest, launches per step;
 12. training agreement with the CPU at full width and text 2 + visual 1
     layers, dropout 0: card f32 (kernels) against CPU f32 (plain versions)
     for the loss, every gradient and the parameters after 2 BertAdam steps;
     card bf16 against CPU f32 losses over 10 steps;
 13. the FT-Align training slice: the same CLI with --train_sim_after_cross
     --fused_ffn block (text 12, visual 6, cross 2 layers; 1,024 text-video
     pairs of 96 tokens through the cross tower a step) on the same fixtures,
     40 steps: losses, steady clips/s, peak memory, launches (#2, #4 and #5
     20 forward and 20 backward a step; #3 and #4 on their wgmma kernels, the
     CUDA-core ones never) and a pytorch_model.bin.0 that loads back; then
     torch.profiler over 3 of its steps, and over 3 steps of the unfused
     route (--fused_ffn xla) beside them;
 14. a short --fused_ffn pallas run (5 steps): #3 20 + 20 a step;
 15. FT-Align agreement with the CPU at full width, text 2 + visual 1 +
     cross 1 layers, batch 8 (64 pairs), dropout 0, on the block and pallas
     routes, with the limits of phase 12;
 16. the caption fine-tuning slice: univl_tpu_torch.cli.task_caption
     --do_train --fused_ln at the full width of UniVLConfig.base (text 12,
     visual 6, cross 2, decoder 3 layers), bf16, batch 16, 128 words, 96
     frames, 40 steps on YouCook2-format fixtures with transcripts: losses,
     steady clips/s, peak memory, launches (#6 in every LayerNorm, #2's
     tensor-core kernels in every attention over keys, 23 forward and 23
     backward a step, the tiled backward never) and a pytorch_model.bin.0
     that loads back; then --do_eval of that file over 32 val clips (beam
     5: captions and BLEU, METEOR, ROUGE-L, CIDEr), and once more with
     --fused_cls;
 17. torch.profiler over 3 caption steps with --fused_ln and 3 without;
 18. caption agreement with the CPU at full width, text 2 + visual 1 +
     cross 1 + decoder 1 layers, batch 4, dropout 0: card f32 without
     --fused_ln (the control) and with it, card bf16 over 10 steps, with the
     limits of phase 12 and the control's;
 19. MSRVTT caption eval: univl_tpu_torch.cli.task_caption --do_eval
     --fused_cls --datatype msrvtt at full width, seeded weights, over 64
     fixture clips with 20 references each (the caption test layout):
     captions, BLEU/METEOR/ROUGE-L/CIDEr, #10t once a decode step;
 20. MSRVTT retrieval eval: univl_tpu_torch.cli.task_retrieval --do_eval
     --datatype msrvtt over 1,000 fixture clips (the JSFusion test size), 48
     words, 48 frames, batch 64: joint (encode clips/s, R@1/5/10, MedR,
     MeanR), then --train_sim_after_cross (the device-resident rescoring of
     all 1,000,000 pairs: pairs/s, #1's launches, peak memory);
 21. torch.profiler over the eval's encode of 64 clips and the rescoring of
     their 4,096 pairs (device busy share, kernel time by group);
 22. retrieval eval agreement: card f32 against CPU f32 at full width, text 2
     + visual 1 + cross 1 layers, 64 clips, both modes: the similarity
     matrices within stated limits and the metrics equal;
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
     #4 and #5 derived from the layer counts, a .bin with both heads; then
     torch.profiler over 3 of its micro-steps;
 P3. resume on the card: two uninterrupted stage-I runs (the controls), whose
     differing parameters name the operation that varies between runs; then,
     under torch.use_deterministic_algorithms, two controls and one run
     preempted (--inject_preempt_after) and resumed (--load_checkpoint): the
     parameters, moments, BertAdam's step count and losses of the resumed run
     within the controls' difference (bitwise where they are bitwise equal);
 P4. stage II agreement with the CPU at full width, text 2 + visual 1 +
     cross 1 + decoder 1 layers, 4 clips x 3 pairs, dropout 0: card f32 (the
     unfused route as the control, then --fused_ffn block) and card bf16
     against CPU f32, with the limits of phases 12 and 15.
Phase 3 also runs #2 at pretraining's [360, 64], [2304, 112] and q 48 / kv
112, and #4 and #5 at its 258,048 cross rows, in bf16.
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
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import os

# P3 runs under torch.use_deterministic_algorithms, which needs cuBLAS's
# fixed workspace (the size PyTorch gives Hopper by default), set before the
# first cuBLAS handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json
import math
import pickle
import shutil
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
from univl_tpu_torch.checkpoint.convert import init_state_dict, load_reference_bin
from univl_tpu_torch.checkpoint.io import restore_checkpoint
from univl_tpu_torch.cli import pretrain, task_caption, task_retrieval
from univl_tpu_torch.cli.serve import main as serve_main
from univl_tpu_torch.data import fixtures
from univl_tpu_torch.data.batching import Batcher, collate
from univl_tpu_torch.data.howto100m import HowTo100MPretrainDataset
from univl_tpu_torch.data.msrvtt import MsrvttRetrievalEvalDataset
from univl_tpu_torch.data.youcook import YoucookCaptionDataset, YoucookRetrievalDataset
from univl_tpu_torch.evals import beam as beam_search
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
    gelu_erf,
    set_fused_layer_norm,
)
from univl_tpu_torch.serving.captioning import CaptionService
from univl_tpu_torch.serving.index import RERANK_TILE, VideoRetrievalIndex
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer

# retrieval traffic
N_CLIPS, N_QUERIES, TOP_K, RERANK, BATCH = 64, 8, 5, 16, 16
N_FILES = 512  # distinct clip files; the sustained window cycles through them
SUSTAINED_INDEX, SUSTAINED_SEARCHES = 3328, 200  # YouCook2 val's clip count
# caption traffic: requests of BATCH clips, beam BEAM, max_len = max_words
BEAM, MAX_WORDS, DECODER_LAYERS = 5, 48, 3
CAPTION_WINDOW, UNFUSED_WINDOW, CONCURRENT = 20, 10, 16
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
# YouCook2-format fixtures of 160 videos x 8 clips = 1,280 pairs: 40 steps
TRAIN_BATCH, TRAIN_VIDEOS, TRAIN_CLIPS, TRAIN_SECONDS, TRAIN_DISPLAY = 32, 160, 8, 120, 5
PALLAS_VIDEOS = 20  # the short --fused_ffn pallas run: 160 pairs, 5 steps
TRAIN_FLAGS = ["--lr", "3e-5", "--warmup_proportion", "0.1", "--coef_lr", "0.1",
               "--epochs", "1", "--batch_size", str(TRAIN_BATCH), "--max_words", "48",
               "--max_frames", "48", "--n_display", str(TRAIN_DISPLAY), "--seed", "0"]
PROFILE_WARMUP, PROFILE_STEPS = 3, 3
# card vs CPU at full width, text 2 and visual 1 layers, dropout 0, stated
# before the first run: f32 (kernels, TF32 off) within the plain versions'
# rounding; bf16 loss over 10 steps within LOSS_BF16_RTOL of the CPU's f32
AGREE_LOSS_RTOL, AGREE_GRAD_RTOL, AGREE_PARAM_RTOL, AGREE_BF16_STEPS = 1e-5, 1e-4, 1e-5, 10
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
# fixtures of 80 videos x 8 clips = 640 clips (40 steps); 4 more videos (32
# clips) are the val split of a short --do_eval
CAP_BATCH, CAP_WORDS, CAP_FRAMES, CAP_VIDEOS, CAP_VAL_VIDEOS = 16, 128, 96, 80, 4
CAP_FLAGS = ["--lr", "3e-5", "--warmup_proportion", "0.1", "--coef_lr", "0.1", "--epochs", "1",
             "--batch_size", str(CAP_BATCH), "--batch_size_val", "32",
             "--max_words", str(CAP_WORDS), "--max_frames", str(CAP_FRAMES),
             "--n_display", str(TRAIN_DISPLAY), "--seed", "0"]
# caption agreement, card against CPU at full width: text 2 + visual 1 + cross
# 1 + decoder 1 layers, batch 4, dropout 0, with and without --fused_ln; the
# limits of phase 12 (stated before the first run): loss within 1e-5 rel,
# every gradient within 1e-4 of its norm, parameters after 2 BertAdam steps
# within 1e-5 of theirs; the key biases (zero gradient in exact arithmetic)
# to AGREE_ZERO_GRAD and, after BertAdam's per-element normalization,
# AGREE_ZERO_PARAM; card bf16 losses over 10 steps within LOSS_BF16_RTOL.
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
# version), and the metrics equal
EVAL_AGREE_CLIPS, EVAL_AGREE_ATOL = 64, {"joint": 1e-5, "cross": 1e-4}
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
PRE_FLAGS = ["--n_pair", str(PRE_PAIRS), "--sampled_use_mil", "--lr", "1e-4", "--coef_lr", "0.1",
             "--warmup_proportion", "0.1", "--max_words", str(PRE_WORDS), "--max_frames",
             str(PRE_FRAMES), "--epochs", "2", "--n_display", "1", "--seed", "0",
             "--num_thread_reader", "8"]
# P3, stated before the first run: the preempted and resumed stage-I run differs
# from an uninterrupted one by no more than two uninterrupted runs differ from
# each other (bitwise where they are bitwise equal): parameters, moments,
# BertAdam's step count and the per-step losses. The default mode's controls
# differ in the embedding tables (their backward adds repeated ids' rows with
# atomics), so the three runs compared go under torch.use_deterministic_algorithms
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
# AGREE_ZERO_GRAD and AGREE_ZERO_PARAM; bf16 losses over 10 steps within
# LOSS_BF16_RTOL
PRE_AGREE_CLIPS = 4
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


def reset_launches() -> None:
    for entry, _, _ in KERNELS.values():
        setattr(*_counter(entry), 0)


def read_launches() -> dict:
    return {name: getattr(*_counter(entry)) for name, (entry, _, _) in KERNELS.items()}


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


def _sdpa_train(q, k, v, keep):
    """The yardstick for #2: SDPA on [B, H, L, D] views, boolean key mask, prob dropout."""
    B, _, HD = q.shape
    heads = [t.view(B, t.shape[1], TA_HEADS, HD // TA_HEADS).transpose(1, 2) for t in (q, k, v)]
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
    t["fwd", "plain"] = cuda_time_ms(lambda: ta.train_attention_reference_fwd(*args), **timing)
    t["bwd", "plain"] = cuda_time_ms(lambda: ta.train_attention_reference_bwd(*args, m, l, grad),
                                     **timing)
    keep = mask.bool()
    keep[1] = True  # SDPA gives NaN on a row with no valid key
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    t["fwd", "sdpa"] = cuda_time_ms(lambda: _sdpa_train(*leaves, keep), **timing)
    out = _sdpa_train(*leaves, keep)
    g4 = grad.view(B, Lq, TA_HEADS, HD // TA_HEADS).transpose(1, 2)
    t["bwd", "sdpa"] = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, g4,
                                                                retain_graph=True), **timing)
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
            if before or cross or long_f32:
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
            lib = (cuda_time_ms(lambda: F.layer_norm(xl, (D,), sl, bl, LN_EPS)),
                   "torch.nn.functional.layer_norm, weight and bias in x's dtype")
            yl = F.layer_norm(xl, (D,), sl, bl, LN_EPS)
            lib_b = (cuda_time_ms(lambda: torch.autograd.grad(yl, [xl, sl, bl], dy,
                                                              retain_graph=True)),
                     "its autograd backward (dx, dweight, dbias)")
            del yl
            fwd = report("layernorm_fwd", f"[{N}, {D}]", dtype, err_f,
                         cuda_time_ms(lambda: ln_k.layer_norm_fwd(x, scale, bias, LN_EPS)),
                         cuda_time_ms(lambda: ln_k.layer_norm_reference_fwd(x, scale, bias,
                                                                            LN_EPS)),
                         bound_ms(2 * N * D * es + 2 * D * 4, 8.0 * N * D, dt),
                         (lib[0][0], lib[1]))
            bwd = report("layernorm_bwd", f"[{N}, {D}]", dtype, err_b,
                         cuda_time_ms(lambda: ln_k.layer_norm_bwd(x, scale, dy, LN_EPS)),
                         cuda_time_ms(lambda: ln_k.layer_norm_reference_bwd(x, scale, dy,
                                                                            LN_EPS)),
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
        plain_ms = cuda_time_ms(plain, **timing)
        leaf = x.detach().requires_grad_()
        if name.endswith("_fwd"):
            with torch.no_grad():
                chain_ms = cuda_time_ms(lambda: chains[chain](leaf), **timing)
        else:
            y = chains[chain](leaf)
            chain_ms = cuda_time_ms(
                lambda: torch.autograd.grad(y, leaf, g, retain_graph=True), **timing)
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


def phase_caption(tmp: str, vocab: str, paths, fused: bool, fused_cls: bool = False) -> dict:
    """The caption server on its default (fused) path, with --fused_cls (the
    classifier transform inside the vocab kernel, #10t), or with
    --no-fused_decode --no-fused_vocab; returns its launch counts, captions
    and, on the fused paths, one profiled request's device ms and launches
    a decode step."""
    label = "fused_cls" if fused_cls else "fused" if fused else "unfused"
    t0 = time.perf_counter()
    server, thread = start_server(
        ["--device", "cuda", "--mode", "caption", "--vocab_file", vocab,
         "--output_dir", os.path.join(tmp, f"out_{label}"), "--port", "0",
         "--max_words", str(MAX_WORDS), "--max_frames", "48", "--beam_size", str(BEAM),
         "--decoder_num_hidden_layers", str(DECODER_LAYERS), "--serve_batch_size", str(BATCH),
         "--seed", "0"] + ([] if fused else ["--no-fused_decode", "--no-fused_vocab"])
        + (["--fused_cls"] if fused_cls else []))
    port = server.server_address[1]
    svc = server.caption_service
    gen = svc.generator
    require((svc.fused_decode, svc.fused_vocab, svc.fused_cls) == (fused, fused, fused_cls),
            f"caption service fused_decode {svc.fused_decode}, fused_vocab {svc.fused_vocab}, "
            f"fused_cls {svc.fused_cls}")
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
        expected = {**{k: 0 for k in KERNELS}, "eval_attention": per_batch * batches,
                    "beam_reorder_groups": 0 if fused else steps,
                    "beam_decode_self_attention": DECODER_LAYERS * steps if fused else 0,
                    "vocab_topk": steps if fused and not fused_cls else 0,
                    "vocab_topk_transform": steps if fused_cls else 0}
        print(f"caption ({label}): {batches} batches, {steps} decode steps (of at most "
              f"{batches * (MAX_WORDS - 1)}); launches {counts}, the steps imply {expected}",
              flush=True)
        require(counts == expected, f"caption ({label}) launches {counts}, steps imply {expected}")
        require(steps >= batches, f"{steps} decode steps for {batches} batches")

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
        if fused:
            steps0 = gen.steps
            prof = profile_request(port, "/v1/caption", caption_body(paths, 0, False),
                                   f"caption {BATCH} clips ({label})",
                                   os.path.join(tmp, "trace.json"))
            n = gen.steps - steps0
            per_step = {"busy_ms": prof["busy_ms"] / n, "kernels": prof["kernels"] / n}
            print(f"profile caption ({label}): {n} decode steps; per decode step device busy "
                  f"{per_step['busy_ms']:.4f} ms, {per_step['kernels']:.2f} kernel launches "
                  f"(encoders and cross included, spread over the steps)", flush=True)
    finally:
        stop_server(server, thread)
    require(not server.caption_coalescer._worker.is_alive(), "the coalescer did not stop")
    return {"launches": counts, "captions": captions, "per_step": per_step}


def make_train_data(tmp: str, vocab: str, n_videos: int = TRAIN_VIDEOS):
    """YouCook2-format fixtures (S3D width 1024) and the dataset over them."""
    files = fixtures.make_youcook(os.path.join(tmp, f"youcook{n_videos}"), n_videos=n_videos,
                                  clips_per_video=TRAIN_CLIPS, video_dim=1024,
                                  seconds_per_video=TRAIN_SECONDS, seed=0)
    ds = YoucookRetrievalDataset(*files, WordPieceTokenizer(vocab), max_words=48, max_frames=48,
                                 seed=0)
    return files, ds


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
    print(f"{label} training (CLI, bf16, batch {TRAIN_BATCH}, {towers} layers): {steps} steps "
          f"in {wall:.3f} s including set-up; steady {rate:.3f} clips/s over steps "
          f"{first['step']}-{last['step']} (host clock between synchronized display points); "
          f"peak device memory {(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} "
          f"GiB held before the run; launches {counts}, per step {per_step}", flush=True)
    want = {**{k: 0 for k in KERNELS}, **{k: n * steps for k, n in per_step.items()}}
    require(counts == want, f"{label} launches {counts}, {steps} steps imply {want}")
    model = UniVL(cfg)
    sd = load_reference_bin(os.path.join(out, "pytorch_model.bin.0"))
    model.load_state_dict(sd, strict=True)
    require(all(bool(torch.isfinite(v).all()) for v in sd.values()), "non-finite saved weights")
    print(f"{label} pytorch_model.bin.0: {len(sd)} tensors, loads with strict=True, all finite",
          flush=True)
    return counts


def _train_batches(ds, n: int, device, batch: int = TRAIN_BATCH) -> list:
    batcher = Batcher(ds, batch, seed=0, num_workers=8)
    out = []
    for b in batcher.epoch(0):
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


def phase_train_profile(ds, tmp: str, route: str = "ft_joint") -> dict:
    """torch.profiler over PROFILE_STEPS steady steps of the full training
    step on a route (batches already on the card): device busy share, kernel
    time by name, launches per step."""
    align = route != "ft_joint"
    cfg = UniVLConfig.base(max_words=48, max_frames=48, compute_dtype="bfloat16",
                           batch_size_per_device=TRAIN_BATCH, train_sim_after_cross=align,
                           use_fused_ffn="block" if route == "ft_align" else False)
    model = UniVL(cfg, device="cuda")
    model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
    return profile_training(model, ds, TRAIN_BATCH,
                            os.path.join(tmp, f"train_trace_{route}.json"), TRAIN_ROUTES[route][0])


def profile_training(model, ds, batch: int, trace: str, label: str) -> dict:
    """torch.profiler over PROFILE_STEPS steps after PROFILE_WARMUP; prints
    and returns the wall and busy ms a step and each group's kernel ms."""
    from torch.profiler import ProfilerActivity, profile

    opt = make_univl_optimizer(model, lr=3e-5, t_total=40, warmup_proportion=0.1, coef_lr=0.1)
    trainer = Trainer(model, opt, seed=0)
    batches = _train_batches(ds, PROFILE_WARMUP + PROFILE_STEPS, "cuda", batch)
    for i in range(PROFILE_WARMUP):
        trainer.train_step(batches[i], i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_WARMUP, PROFILE_WARMUP + PROFILE_STEPS):
            trainer.train_step(batches[i], i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events, busy_us = device_events(prof, trace, "train")
    kernels = [e for e in events if e["cat"] == "kernel"]
    text, groups = kernel_groups(kernels, PROFILE_STEPS)
    print(f"profile {label} train step (profiler on, {PROFILE_STEPS} steps, "
          f"batches on the card): wall {wall_ms / PROFILE_STEPS:.3f} ms a step; device busy "
          f"{busy_us / 1e3 / PROFILE_STEPS:.3f} ms a step ({busy_us / 1e3 / wall_ms:.4f} of "
          f"wall); {len(kernels) / PROFILE_STEPS:.1f} kernel launches a step; {text}",
          flush=True)
    return {"wall_ms": wall_ms / PROFILE_STEPS, "busy_ms": busy_us / 1e3 / PROFILE_STEPS,
            "groups": groups}


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
    sd = init_state_dict(cfg, seed=0)
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
          f"{cfg.decoder.num_decoder_layers} layers): {steps} steps in {wall:.3f} s including "
          f"set-up; steady {rate:.3f} clips/s over steps {first['step']}-{last['step']} (host "
          f"clock between synchronized display points); peak device memory "
          f"{(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held before the "
          f"run; launches {counts}, per step {per_step}", flush=True)
    want = {**{k: 0 for k in KERNELS}, **{k: n * steps for k, n in per_step.items()}}
    require(counts == want, f"caption training launches {counts}, {steps} steps imply {want}")
    print(f"caption pytorch_model.bin.0: {len(sd)} tensors, loads with strict=True, all finite",
          flush=True)
    del model, sd

    reset_launches()
    t0 = time.perf_counter()
    _, metrics = task_caption.main(["--do_eval", "--output_dir", os.path.join(tmp, "caption_eval"),
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
    _, metrics_cls = task_caption.main(["--do_eval", "--fused_cls", "--output_dir",
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
    argv = _msrvtt_argv(files, vocab, out) + ["--fused_cls", "--batch_size_val", "32"]
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
    return counts


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
    model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
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
    sd = init_state_dict(cfg, seed=0)
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


def phase_caption_profile(ds, tmp: str) -> None:
    """The caption step under torch.profiler at full width in bf16, with every
    LayerNorm on #6 and on PyTorch's ops (the same weights and batches)."""
    cfg = _caption_cfg(compute_dtype="bfloat16", batch_size_per_device=CAP_BATCH)
    sd = init_state_dict(cfg, seed=0)
    res = {}
    for fused in (True, False):
        model = UniVL(cfg, device="cuda")
        model.load_state_dict(sd, strict=True)
        set_fused_layer_norm(model, fused)
        label = f"caption ({'--fused_ln' if fused else 'PyTorch LayerNorm'})"
        res[fused] = profile_training(model, ds, CAP_BATCH,
                                      os.path.join(tmp, "caption_trace.json"), label)
        del model
        torch.cuda.empty_cache()
    ln = sum(res[True]["groups"].get(g, 0.0) for g in ("#6 forward", "#6 backward"))
    print(f"caption step with --fused_ln vs without: wall {res[True]['wall_ms']:.3f} vs "
          f"{res[False]['wall_ms']:.3f} ms, device busy {res[True]['busy_ms']:.3f} vs "
          f"{res[False]['busy_ms']:.3f} ms a step; #6 {ln:.3f} ms a step "
          f"({ln / res[True]['busy_ms']:.4f} of the busy time)", flush=True)


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
    sd = init_state_dict(cfg, seed=0)
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
    sd = init_state_dict(cfg32, seed=0)
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
    print(f"pretraining stage {'I' * stage}: {steps} steps in {wall:.3f} s including set-up and "
          f"the epoch-end saves; steady {rate:.3f} clips/s ({rate * PRE_PAIRS:.3f} pairs/s) over "
          f"the steps within an epoch (host clock between synchronized display points); peak "
          f"device memory {(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held "
          f"before the run; launches {counts}", flush=True)
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


def phase_pretrain_profile(files, vocab: str, tmp: str) -> None:
    """torch.profiler over PROFILE_STEPS stage-II micro-steps at full width,
    bf16, --fused_ffn block, batches on the card."""
    cfg = _pretrain_cfg(2, compute_dtype="bfloat16", batch_size_per_device=PRE2_CLIPS,
                        use_fused_ffn="block")
    model = UniVL(cfg, device="cuda")
    model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
    profile_training(model, _pretrain_dataset(files, vocab), PRE2_CLIPS,
                     os.path.join(tmp, "pretrain_trace.json"),
                     f"pretraining stage II ({PRE2_CLIPS} clips x {PRE_PAIRS} pairs)")


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


def phase_pretrain_resume(tmp: str, vocab: str, files) -> None:
    """P3: stage I at full width, 4 steps over 2 epochs. Two uninterrupted
    runs (the controls); where they differ, the parameters that differ name
    the operation. Then under torch.use_deterministic_algorithms two
    uninterrupted runs and one preempted after PRE_PREEMPT_AFTER steps
    (--inject_preempt_after) and resumed (--load_checkpoint): the resumed
    run may differ from the first by no more than the two differ from each
    other, bitwise where they are bitwise equal."""

    def run(name: str, *extra):
        out = os.path.join(tmp, f"pretrain_resume_{name}")
        return pretrain.main(_pretrain_argv(files, vocab, out, 1, *extra))[0], out

    t0 = time.perf_counter()
    (_, a), (_, b) = run("control_a"), run("control_b")
    print(f"pretraining resume, default mode: the controls differ by {_state_diff(a, b)} (the "
          f"parameters that differ name the operation)", flush=True)
    for out in (a, b):
        shutil.rmtree(out)
    torch.use_deterministic_algorithms(True)
    try:
        (_, a), (_, b) = run("deterministic_a"), run("deterministic_b")
        control = _state_diff(a, b)
        shutil.rmtree(b)
        k, _ = run("resumed", "--inject_preempt_after", str(PRE_PREEMPT_AFTER))
        n, c = run("resumed", "--load_checkpoint")
        resumed = _state_diff(a, c)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"pretraining resume, torch.use_deterministic_algorithms (stage I, full width, 4 steps "
          f"over 2 epochs; preempted after {k} step(s), resumed to step {n}) in "
          f"{time.perf_counter() - t0:.1f} s for the five runs: the controls differ by {control}; "
          f"the resumed run differs from the first control by {resumed} (limit: the controls' "
          f"difference, bitwise where they are bitwise equal)", flush=True)
    require(k == PRE_PREEMPT_AFTER and n == 4 and resumed["same_steps"]
            and resumed["steps"][0] == resumed["steps"][1] == 4
            and resumed["params"][0] <= control["params"][0]
            and resumed["moments"][0] <= control["moments"][0]
            and resumed["losses"] <= control["losses"],
            f"the resumed run strays from the uninterrupted one: {resumed} against {control}")
    shutil.rmtree(a)
    shutil.rmtree(c)


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
    sd = init_state_dict(cfg, seed=0)
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

    nn_layers.fused_attention_masked = _recorded_attention
    beam_search.classify_topk = _recorded_topk
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {os.path.relpath(lib_path)} in {time.perf_counter() - t0:.1f} s", flush=True)

    measured = {**kernel_eval_attention(),
                "beam_reorder_groups": kernel_reorder(),
                "beam_decode_self_attention": kernel_decode_attention(),
                **kernel_vocab_topk(),
                **kernel_vocab_topk_transform(),
                **kernel_eval_attention_causal(),
                "reorder_rows": kernel_reorder_rows(),
                **kernel_train_attention(),
                **kernel_ffn(),
                **kernel_layernorm()}
    kernel_pretrain_shapes(measured)
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
        fused = phase_caption(tmp, vocab, paths, fused=True)
        fused_cls = phase_caption(tmp, vocab, paths, fused=True, fused_cls=True)
        unfused = phase_caption(tmp, vocab, paths, fused=False)
        by_path["caption"], by_path["caption_unfused"] = fused["launches"], unfused["launches"]
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
        reset_launches()
        phase_agreement(vocab, clips)
        f32_runs["serving agreement"] = read_launches()
        files, ds = make_train_data(tmp, vocab)
        by_path["train"] = phase_train(tmp, vocab, files)
        phase_train_profile(ds, tmp)
        phase_train_agreement(ds, f32_launches=f32_runs)
        by_path["train_ft_align"] = phase_train(tmp, vocab, files, "ft_align")
        fused = phase_train_profile(ds, tmp, "ft_align")
        unfused = phase_train_profile(ds, tmp, "ft_align_xla")
        print(f"FT-Align step, --fused_ffn block against xla (one profile each, same batches): "
              f"device busy {fused['busy_ms']:.3f} against {unfused['busy_ms']:.3f} ms a step, "
              f"wall {fused['wall_ms']:.3f} against {unfused['wall_ms']:.3f} ms", flush=True)
        small, _ = make_train_data(tmp, vocab, n_videos=PALLAS_VIDEOS)
        by_path["train_ft_align_pallas"] = phase_train(tmp, vocab, small, "ft_align_pallas")
        control = phase_train_agreement(ds, "ft_align_xla")
        phase_train_agreement(ds, "ft_align", control, f32_runs)
        phase_train_agreement(ds, "ft_align_pallas", control, f32_runs)
        cap_files, cap_ds = make_caption_data(tmp, vocab)
        by_path.update(phase_caption_train(tmp, vocab, cap_files))
        phase_caption_profile(cap_ds, tmp)
        phase_caption_agreement(cap_ds, f32_runs)
        ret_files, msrvtt_cap_files = make_msrvtt_data(tmp)
        by_path["caption_eval_msrvtt"] = phase_caption_eval_msrvtt(tmp, vocab, msrvtt_cap_files)
        for mode in ("joint", "cross"):
            by_path[f"retrieval_eval_{mode}"] = phase_retrieval_eval(tmp, vocab, ret_files, mode)
        phase_eval_profile(vocab, ret_files, tmp)
        reset_launches()
        phase_retrieval_agreement(vocab, ret_files)
        f32_runs["retrieval eval agreement"] = read_launches()
        pre_files = make_pretrain_data(tmp)
        by_path["pretrain_stage_one"], stage1 = phase_pretrain(tmp, vocab, pre_files, 1)
        by_path["pretrain_stage_two"], stage2 = phase_pretrain(
            tmp, vocab, pre_files, 2, init=os.path.join(stage1, "pytorch_model.bin.1"))
        for out in (stage1, stage2):  # a train state is ~1.8 GB at this width
            shutil.rmtree(out)
        phase_pretrain_profile(pre_files, vocab, tmp)
        phase_pretrain_resume(tmp, vocab, pre_files)
        phase_pretrain_agreement(pre_files, vocab, f32_runs)

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
