"""Command-line plumbing of the port's entry points (the server, the
retrieval and caption trainers and pretraining), without JAX.

The port's own copies of ``univl_tpu/cli/common.py``'s ``MetricsWriter``,
``get_logger``, ``base_parser`` (JAX's flags under their names, types and
defaults, but ``--scan_layers``, ``--use_pallas``, ``--attention`` and
``--train_attention``, which are TPU-only; ``--lr_decay``,
``--fp16_opt_level``, ``--world_size`` and ``--local_rank`` parsed and
unused, as in JAX; plus ``--fused_ln`` and
``--fused_cls``, the counterparts of JAX's ``UNIVL_TPU_FUSED_LN=1`` and
``UNIVL_TPU_FUSED_CLS=1``, and ``--decode_unroll``, of
``UNIVL_TPU_DECODE_UNROLL``), ``add_fused_ffn_arg`` (the
trainers' ``--fused_ffn``), ``finalize_args``, ``build_config`` (with the
local ``<kind>_config.json`` of ``--bert_model`` and the other three),
``load_init_params`` (a reference or port ``.bin``, or a JAX flax params
``.msgpack``; in ``make_model``), ``make_trainer``, ``make_input_iter``
(the prefetching input pipeline), ``make_preempt_flag``, ``preempt_hit``
and ``run_train_epochs`` (per-epoch eval and the best epoch, preemption,
the train-state checkpoints, synchronous or on a thread, and exact resume),
and the trainers' data and tensor parallelism: ``base_parser``'s
``--n_gpu``, ``--zero1``, ``--tensor_parallel`` and ``--sequence_parallel``
(the server ignores them, as JAX's), ``add_dist_backend_arg``,
``check_parallel_args`` and ``run_on_ranks`` (``parallel/mesh.py``,
``parallel/tp.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import random
import signal
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from univl_tpu_torch.checkpoint.convert import (
    init_state_dict,
    load_reference_bin,
    state_dict_from_jax_params,
)
from univl_tpu_torch.checkpoint.io import (
    TRAIN_STATE,
    CheckpointWriter,
    merge_state_dict,
    read_flax_params,
    restore_checkpoint,
    save_checkpoint,
)
from univl_tpu_torch.config import (
    TPU_THRESHOLD,
    BertConfig,
    CrossConfig,
    DecoderConfig,
    UniVLConfig,
    VisualConfig,
)
from univl_tpu_torch.data.batching import (
    Batcher,
    DeviceTransfer,
    cast_floats,
    prefetch_to_device,
    to_device,
)
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn.layers import set_fused_layer_norm
from univl_tpu_torch.parallel import mesh as dp_mesh
from univl_tpu_torch.parallel import tp as tensor_parallel
from univl_tpu_torch.parallel.mesh import DP_AXIS, Mesh
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer
from univl_tpu_torch.train.zero1 import make_univl_zero1_optimizer
from univl_tpu_torch.train.zero1_tp import make_univl_zero1_tp_optimizer
from univl_tpu_torch.utils.file_utils import ARCHIVES, cached_path
from univl_tpu_torch.utils.profiling import StepTimer, StepTrace


class MetricsWriter:
    """Structured run metrics: one JSON object per line in metrics.jsonl
    (train display points and epoch summaries)."""

    def __init__(self, output_dir: Optional[str]):
        self._f = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1)

    def write(self, kind: str, **fields):
        if self._f is None:
            return
        rec = {"ts": round(time.time(), 3), "kind": kind}
        for k, v in fields.items():
            if isinstance(v, (int, float, str, bool)) or v is None:
                rec[k] = v
            else:
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    pass
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def get_logger(output_dir: Optional[str] = None, name: str = "univl_tpu_torch",
               primary: bool = True):
    """The log on stderr and in ``<output_dir>/log.txt``; a rank other than
    0 logs warnings only, to stderr alone."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO if primary else logging.WARNING)
    if not primary:
        output_dir = None
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def _decode_unroll(value: str) -> int:
    u = int(value)
    if u < 1:
        raise argparse.ArgumentTypeError(f"{u}: a run takes at least one decode step")
    return u


UNUSED = "parsed and unused, as in JAX"


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--do_pretrain", action="store_true",
                   help="pretraining: the mode of univl_tpu_torch.cli.pretrain (implied there); "
                        "the task CLIs refuse it, the server passes it to the model's config")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true",
                   help="task_retrieval: R@K, MedianR and MeanR over --val_csv; task_caption: "
                        "beam-5 captions of --val_csv and their metrics; with --do_train after "
                        "every epoch. Pretraining and the server ignore it, as in JAX")
    p.add_argument("--task_type", type=str, default="retrieval",
                   help="task_retrieval refuses any but retrieval, task_caption sets caption; "
                        "pretraining and the server take their mode's own, as in JAX")
    p.add_argument("--train_csv", type=str, default="data/youcookii_singlef_train.csv")
    p.add_argument("--val_csv", type=str, default="data/youcookii_singlef_val.csv")
    p.add_argument("--data_path", type=str, default="data/youcookii_caption.pickle")
    p.add_argument("--features_path", type=str, default="data/youcookii_videos_feature.pickle")
    p.add_argument("--load_checkpoint", action="store_true",
                   help=f"resume from <output_dir>/{TRAIN_STATE} (written on preemption and "
                        f"after each epoch): continues at the exact update-batch, bit-identical "
                        f"to an uninterrupted run")
    p.add_argument("--no_preempt_checkpoint", action="store_true",
                   help="do not checkpoint and exit on SIGTERM (preemption); also skips the "
                        "per-epoch train-state write")
    p.add_argument("--inject_preempt_after", type=int, default=0,
                   help="fault injection: a preemption signal after N steps")
    p.add_argument("--datatype", type=str, default="youcook")
    p.add_argument("--expand_msrvtt_sentences", action="store_true")
    p.add_argument("--feature_framerate", type=float, default=1)
    p.add_argument("--num_thread_reader", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--batch_size_val", type=int, default=64)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--coef_lr", type=float, default=0.1)
    p.add_argument("--n_display", type=int, default=100)
    # the trainers' parallelism (univl_tpu/cli/common.py:133-150, 224-228);
    # the server ignores it, as JAX's does
    p.add_argument("--n_gpu", type=int, default=0,
                   help="trainers: data-parallel ranks, one a card; 0 = every visible card "
                        "(one rank on the CPU). Above 1 the command starts its ranks itself, "
                        "unless a launcher (torchrun) started it. The server ignores it")
    p.add_argument("--zero1", action="store_true",
                   help="trainers: ZeRO-1, BertAdam's moments and update sharded over the "
                        "data-parallel ranks (train/zero1.py; with --tensor_parallel above 1 "
                        "train/zero1_tp.py). The server ignores it")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="trainers: tp axis size of a 2-D (dp, tp) grid of the ranks; weights "
                        "are Megatron-sharded over tp (parallel/tp.py). Must divide the rank "
                        "count. The server ignores it")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="trainers, with --tensor_parallel > 1: shard the encoder LN/dropout/"
                        "residual regions over the rows (Megatron-SP; reduce-scatter + "
                        "all-gather replace the tp all-reduces, parallel/sp.py). The server "
                        "ignores it")
    p.add_argument("--lr_decay", type=float, default=0.9, help=UNUSED)
    p.add_argument("--fp16_opt_level", type=str, default="O1", help=UNUSED)
    p.add_argument("--world_size", type=int, default=0, help=UNUSED)
    p.add_argument("--local_rank", type=int, default=0, help=UNUSED)
    p.add_argument("--adam_state_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype for BertAdam moments; bfloat16 halves optimizer "
                        "memory and traffic (not reference-exact)")
    p.add_argument("--margin", type=float, default=0.1)
    p.add_argument("--hard_negative_rate", type=float, default=0.5)
    p.add_argument("--negative_weighting", type=int, default=1)
    p.add_argument("--n_pair", type=int, default=1)
    p.add_argument("--use_mil", action="store_true")
    p.add_argument("--sampled_use_mil", action="store_true")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--vocab_file", type=str, default=None,
                   help="WordPiece vocab.txt (required; no network download)")
    p.add_argument("--do_lower_case", action="store_true")
    p.add_argument("--init_model", type=str, default=None,
                   help="a reference PyTorch .bin to initialize from")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--video_dim", type=int, default=1024)
    p.add_argument("--max_words", type=int, default=20)
    p.add_argument("--max_frames", type=int, default=100)
    p.add_argument("--text_num_hidden_layers", type=int, default=12)
    p.add_argument("--visual_num_hidden_layers", type=int, default=6)
    p.add_argument("--cross_num_hidden_layers", type=int, default=2)
    p.add_argument("--decoder_num_hidden_layers", type=int, default=3)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--train_sim_after_cross", action="store_true")
    p.add_argument("--stage_two", action="store_true")
    p.add_argument("--fp16", action="store_true", help="bfloat16 compute")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--fused_decode", action=argparse.BooleanOptionalAction, default=None,
                   help="beam decode: the pending beam permutation, the cache update and "
                        "the self-attention in one pass over the KV cache (the decode-"
                        "attention kernel). Unset: the server's on for a CUDA device; off on the "
                        "CPU and in task_caption's eval, as in JAX")
    p.add_argument("--fused_vocab", action=argparse.BooleanOptionalAction, default=None,
                   help="beam decode: the tied classifier, its log-softmax normalizer and "
                        "the per-row top-K in one pass over vocab tiles (the vocab top-k "
                        "kernel); the [B*K, V] logits are never written. Unset: the server's "
                        "on for a CUDA device; off on the CPU and in task_caption's eval, "
                        "as in JAX")
    p.add_argument("--fused_cls", action="store_true",
                   help="beam decode: the classifier transform (dense, erf-GELU, LayerNorm) "
                        "inside the vocab top-k kernel, in f32 with one rounding; only with "
                        "the fused vocab kernel, ignored with a warning otherwise (off by "
                        "default, as JAX's UNIVL_TPU_FUSED_CLS)")
    p.add_argument("--decode_unroll", type=_decode_unroll, default=1, metavar="U",
                   help="beam decode: steps a run between the host's early-exit checks (on "
                        "the card, one CUDA graph replay), single steps for a cache bucket's "
                        "tail; the captions are the same at every U (JAX's "
                        "UNIVL_TPU_DECODE_UNROLL; default 1)")
    p.add_argument("--fused_ln", action="store_true",
                   help="every LayerNorm of the model through the LayerNorm kernel, forward "
                        "and backward (off by default, as JAX's UNIVL_TPU_FUSED_LN)")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing of the text, visual and cross towers' "
                        "layers: their activations are recomputed in the backward")
    p.add_argument("--remat_policy", type=str, default="full", choices=["full", "dots"],
                   help="with --remat: the full layer, or keep the weight products "
                        "(nn.Linear's GEMMs) and recompute the rest, the kernels included")
    p.add_argument("--transfer_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="host-to-device dtype of the float features; bfloat16 halves the "
                        "bytes moved (input fidelity about 3 digits)")
    p.add_argument("--no_prefetch", action="store_true",
                   help="no background input thread: each batch is built and copied to the "
                        "device inside the step loop")
    p.add_argument("--bert_model", type=str, default="bert-base-uncased",
                   help="a directory holding bert_config.json (or a .tar.gz of one) whose "
                        "fields replace the text tower's defaults")
    p.add_argument("--visual_model", type=str, default="visual-base",
                   help="likewise, visual_config.json for the visual tower")
    p.add_argument("--cross_model", type=str, default="cross-base",
                   help="likewise, cross_config.json for the cross tower")
    p.add_argument("--decoder_model", type=str, default="decoder-base",
                   help="likewise, decoder_config.json for the decoder")
    p.add_argument("--cache_dir", type=str, default="",
                   help="where a --*_model archive is extracted (default: UNIVL_TPU_CACHE or "
                        "~/.cache/univl_tpu/artifacts)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="trace five training steps from step 2 of the first epoch with "
                        "torch.profiler (task_retrieval, task_caption): one Chrome trace per "
                        "process, rank<r>.<ms>.pt.trace.json, for Perfetto or TensorBoard")
    return p


def add_dist_backend_arg(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The trainers' ``--dist_backend``, a flag of the port's own: the
    process group of the ranks that ``base_parser``'s parallelism flags
    ask for."""
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="the ranks' process group: nccl on the card, gloo on the CPU by "
                        "default; gloo given explicitly may put several ranks on one card")
    return p


def check_parallel_args(parser: argparse.ArgumentParser, args) -> None:
    """Refuse what the ranks cannot run: a rank count below 0, a
    ``--tensor_parallel`` that does not divide the ranks (in JAX's words), more
    ranks than cards without ``--dist_backend gloo``."""
    if args.n_gpu < 0:
        parser.error(f"--n_gpu {args.n_gpu}: give 0 (every visible card) or a count")
    device_type = torch.device(args.device).type
    if args.tensor_parallel < 1:
        parser.error(f"--tensor_parallel {args.tensor_parallel}: give 1 or more")
    n = dp_mesh.resolve_size(args.n_gpu, device_type)
    if n % args.tensor_parallel:
        parser.error(f"--tensor_parallel {args.tensor_parallel} must divide mesh size {n}")
    why = dp_mesh.rank_error(args.n_gpu, device_type, args.dist_backend)
    if why:
        parser.error(why)


def run_on_ranks(entry: str, argv, args, body: Callable, portable: Callable = lambda r: r):
    """``body(args, mesh)`` on this process's rank. With ``--n_gpu`` above 1
    and no launcher, start the ranks (``mesh.spawn`` of ``entry``, the CLI's
    ``"module:main"``, with the same ``argv``) and return rank 0's result,
    made ``portable`` across processes. A process group is joined when there
    are several ranks or ``--zero1`` (on one card a group of one rank), and
    destroyed when the body returns or raises. Spawned ranks inherit this
    process's ``torch.use_deterministic_algorithms`` (``mesh.spawn``)."""
    device_type = torch.device(args.device).type
    size = dp_mesh.resolve_size(args.n_gpu, device_type)
    if size > 1 and not dp_mesh.launched():
        return dp_mesh.spawn(entry, sys.argv[1:] if argv is None else argv, size)
    mesh = None
    try:
        if size == 1 and not args.zero1:
            return body(args, Mesh(device=resolve_device(args.device)))
        mesh = dp_mesh.init(args.device, args.dist_backend,
                            tp=getattr(args, "tensor_parallel", 1),
                            sequence_parallel=getattr(args, "sequence_parallel", False))
        result = body(args, mesh)
        return portable(result) if dp_mesh.launched() else result
    finally:
        if mesh is not None:
            mesh.close()


FUSED_FFN = {"xla": False, "pallas": True, "block": "block"}  # --fused_ffn -> use_fused_ffn


def _fused_ffn_route(value: str) -> str:
    """JAX's auto and auto_block are refused here, with the reason."""
    if value in ("auto", "auto_block"):
        raise argparse.ArgumentTypeError(f"{value}: {TPU_THRESHOLD}; choose xla, pallas or block")
    return value


def add_fused_ffn_arg(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--fused_ffn`` with the JAX package's meaning
    (``univl_tpu/cli/common.py:189-195``): xla = the unfused FFN; pallas =
    the fused FFN kernel (#3); block = the FFN-block and dense-block kernels
    (#4, #5), dropout, residual and LayerNorm folded in."""
    p.add_argument("--fused_ffn", type=_fused_ffn_route, default="xla", choices=list(FUSED_FFN),
                   help="FFN route: xla (unfused), pallas (the fused FFN kernel), block (the "
                        "FFN-block and dense-block kernels); auto and auto_block are refused")
    return p


def resolve_device(name: str) -> torch.device:
    """The ``--device``; a CUDA device that is not there is an error, never
    a silent fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return device


def finalize_args(args, mesh: Optional[Mesh] = None):
    """The batch divided by gradient accumulation (the reference's global
    batch over its micro-batches), the resolved flags in ``args.json`` (by
    rank 0), and Python's and numpy's global seeds."""
    if args.gradient_accumulation_steps < 1:
        raise ValueError("gradient_accumulation_steps must be >= 1")
    args.batch_size = int(args.batch_size / args.gradient_accumulation_steps)
    if args.sampled_use_mil:
        args.use_mil = True
    os.makedirs(args.output_dir, exist_ok=True)
    if mesh is None or mesh.primary:
        with open(os.path.join(args.output_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=1, default=str)
    random.seed(args.seed)
    np.random.seed(args.seed)
    os.environ["PYTHONHASHSEED"] = str(args.seed)
    return args


def _json_config(cls, model_dir: str, json_name: str, cache_dir: str):
    """``cls.from_json`` of ``<model_dir>/<json_name>`` (``model_dir`` may be
    an archive, extracted through ``cached_path``), or None without one."""
    if str(model_dir).endswith(ARCHIVES) and os.path.isfile(model_dir):
        model_dir = cached_path(model_dir, cache_dir or None)
    path = os.path.join(str(model_dir), json_name)
    if os.path.isdir(str(model_dir)) and os.path.exists(path):
        return cls.from_json(path)
    return None


def build_config(args, device: torch.device, task_type: str = "retrieval",
                 vocab_size: Optional[int] = None, ranks: int = 1) -> UniVLConfig:
    """Layer counts, widths, lengths, video_dim, vocab size (text tower and
    decoder alike), the stage switches, the loss fields, the (micro-)batch
    of one of ``ranks`` data-parallel ranks (the global micro-batch over
    them: the MIL-NCE and max-margin masks' shapes),
    the FFN route (``--fused_ffn``, where the parser has it), ``--remat``
    and the compute dtype (bf16 on a CUDA device, f32 on the CPU, unless
    --compute_dtype or --fp16 says otherwise). A ``--bert_model`` (and
    ``--visual_model``, ``--cross_model``, ``--decoder_model``) directory
    with its ``<kind>_config.json`` replaces that config; then the CLI's
    layer counts apply again, then the width flags, in
    ``univl_tpu/cli/common.py:293-367``'s order."""
    dtype = args.compute_dtype or (
        "bfloat16" if (device.type == "cuda" or args.fp16) else "float32")
    if args.batch_size % ranks:
        raise ValueError(f"the micro-batch of {args.batch_size} does not split over {ranks} "
                         f"ranks")
    cfg = UniVLConfig.base(
        text_num_hidden_layers=args.text_num_hidden_layers,
        visual_num_hidden_layers=args.visual_num_hidden_layers,
        cross_num_hidden_layers=args.cross_num_hidden_layers,
        decoder_num_hidden_layers=args.decoder_num_hidden_layers,
        max_words=args.max_words,
        max_frames=args.max_frames,
        video_dim=args.video_dim,
        margin=args.margin,
        hard_negative_rate=args.hard_negative_rate,
        negative_weighting=bool(args.negative_weighting),
        n_pair=args.n_pair,
        use_mil=args.use_mil,
        sampled_use_mil=args.sampled_use_mil,
        stage_two=args.stage_two,
        do_pretrain=getattr(args, "do_pretrain", False),
        pretrain_enhance_vmodal=getattr(args, "pretrain_enhance_vmodal", False),
        train_sim_after_cross=args.train_sim_after_cross,
        task_type=task_type,
        batch_size_per_device=args.batch_size // ranks,
        compute_dtype=dtype,
        use_fused_ffn=FUSED_FFN[getattr(args, "fused_ffn", "xla")],
        remat=("dots" if args.remat_policy == "dots" else True) if args.remat else False,
    )
    # the JSON configs replace the defaults, then the CLI's layer counts apply
    # again (the reference's update_attr order)
    counts = (("bert", BertConfig, args.bert_model, "num_hidden_layers",
               args.text_num_hidden_layers),
              ("visual", VisualConfig, args.visual_model, "num_hidden_layers",
               args.visual_num_hidden_layers),
              ("cross", CrossConfig, args.cross_model, "num_hidden_layers",
               args.cross_num_hidden_layers),
              ("decoder", DecoderConfig, args.decoder_model, "num_decoder_layers",
               args.decoder_num_hidden_layers))
    for kind, cls, model_dir, field, n in counts:
        loaded = _json_config(cls, model_dir, f"{kind}_config.json", args.cache_dir)
        if loaded is not None:
            cfg = cfg.replace(**{kind: loaded.replace(**{field: n})})
    arch = {}
    if args.hidden_size != 768:
        arch.update(hidden_size=args.hidden_size)
    if args.num_attention_heads != 12:
        arch.update(num_attention_heads=args.num_attention_heads)
    if args.intermediate_size != 3072:
        arch.update(intermediate_size=args.intermediate_size)
    bert, visual = cfg.bert.replace(**arch), cfg.visual.replace(**arch)
    cross, decoder = cfg.cross.replace(**arch), cfg.decoder.replace(**arch)
    if vocab_size is not None:
        bert = bert.replace(vocab_size=vocab_size)
        decoder = decoder.replace(vocab_size=vocab_size)
    if args.video_dim != visual.vocab_size:
        visual = visual.replace(vocab_size=args.video_dim)
    if arch or vocab_size is not None or args.video_dim != 1024:
        cfg = cfg.replace(bert=bert, visual=visual, cross=cross, decoder=decoder)
    return cfg.validate()


def make_model(args, cfg: UniVLConfig, device: torch.device, logger,
               mesh: Optional[Mesh] = None) -> UniVL:
    """The model on ``device``, its LayerNorms on the kernel with
    ``--fused_ln``, its weights from ``load_init_params``; under tensor
    parallelism (``mesh.tp`` above 1) then cut to the rank's shares
    (``parallel/tp.py:parallelize``)."""
    model = UniVL(cfg, device=device)
    set_fused_layer_norm(model, args.fused_ln)
    load_init_params(args, model, logger)
    if mesh is not None and mesh.tp > 1:
        ctx = tensor_parallel.parallelize(model, mesh)
        logger.info("tensor parallelism: %d of %d parameters split over %d ranks%s",
                    sum(d is not None for d in ctx.layout.values()), len(ctx.layout), ctx.size,
                    ", sequence-parallel encoders" if ctx.sequence_parallel else "")
    return model


def make_eval_model(args, cfg: UniVLConfig, model: UniVL, mesh: Mesh) -> Optional[UniVL]:
    """The model the per-epoch eval runs: ``model`` itself, or under tensor
    parallelism a whole one on rank 0's card (None on the other ranks), into
    which ``run_train_epochs`` loads the weights gathered from the shards."""
    if mesh.tp == 1:
        return model
    if not mesh.primary:
        return None
    return set_fused_layer_norm(UniVL(cfg, device=mesh.device), args.fused_ln)


def load_init_params(args, model: torch.nn.Module, logger) -> None:
    """Seeded init (``--seed``), overlaid with ``--init_model`` when given:
    a reference PyTorch ``.bin`` (or a ``pytorch_model.bin.<epoch>`` either
    package wrote), or a JAX flax params file (``params.msgpack.<epoch>``,
    ``best.msgpack``). The caption decoder's keys are dropped when the model
    builds no decoder, the pretraining heads' when it builds none; any other
    key the model does not have is an error. Parameters the file lacks stay
    at the seeded init, as in univl_tpu.cli.common.load_init_params; a file
    that holds every parameter skips the seeded draw (seconds at full width)."""
    if not args.init_model:
        model.load_state_dict(init_state_dict(model.cfg, args.seed), strict=True)
        return
    name = os.path.basename(args.init_model)
    if ".msgpack" in name:
        loaded = state_dict_from_jax_params(read_flax_params(args.init_model))
    elif ".bin" in name:
        loaded = load_reference_bin(args.init_model)
    else:
        raise ValueError(f"--init_model: a reference .bin or a flax .msgpack, got "
                         f"{args.init_model}")
    drop = (() if model.has_decoder else ("decoder.",)) + (
        () if model.has_pretrain_heads else ("cls.", "cls_visual."))
    loaded = {k: v for k, v in loaded.items() if not k.startswith(drop)}
    names = model.state_dict().keys()
    template = (dict.fromkeys(names) if set(names) <= set(loaded)
                else init_state_dict(model.cfg, args.seed))
    sd, missing = merge_state_dict(template, loaded, args.init_model)
    logger.info("loaded %d params from %s; %d left at init%s", len(loaded), args.init_model,
                len(missing), f": {missing[:8]}" if missing else "")
    model.load_state_dict(sd, strict=True)


def one_card(args) -> None:
    """``--do_eval`` alone: one rank on one card, no parallelism."""
    args.n_gpu, args.zero1, args.tensor_parallel, args.sequence_parallel = 1, False, 1, False


def make_batcher(args, dataset, mesh: Mesh):
    """The training batches of the rank's dp index (the ranks of a tp group
    read the same rows), JAX's ``process_index`` slice of each update-batch."""
    dp = mesh.axis(DP_AXIS)
    return Batcher(dataset, args.batch_size, shuffle=True, seed=args.seed,
                   grad_accum=args.gradient_accumulation_steps,
                   num_workers=args.num_thread_reader, process_index=dp.rank,
                   process_count=dp.size)


def make_trainer(args, model: torch.nn.Module, n_train_batches: int, logger,
                 mesh: Optional[Mesh] = None) -> Trainer:
    """BertAdam over ``t_total = n_train_batches * epochs`` updates (with
    ``--zero1`` sharded over the ranks), and the trainer with
    ``--gradient_accumulation_steps`` on ``mesh``'s rank."""
    mesh = mesh or Mesh()
    zero1 = bool(getattr(args, "zero1", False))
    t_total = n_train_batches * args.epochs
    kw = dict(lr=args.lr, t_total=max(t_total, 1), warmup_proportion=args.warmup_proportion,
              coef_lr=args.coef_lr, state_dtype=args.adam_state_dtype)
    opt = make_optimizer(model, mesh, zero1, **kw)
    logger.info("mesh: %d rank(s) (dp=%d, tp=%d, sp=%s, zero1=%s, %s) on %s; t_total=%d",
                mesh.size, mesh.dp, mesh.tp, mesh.sequence_parallel, zero1,
                mesh.backend or "no process group", next(model.parameters()).device, t_total)
    return Trainer(model, opt, grad_accum_steps=args.gradient_accumulation_steps,
                   seed=args.seed, mesh=mesh)


def make_optimizer(model: torch.nn.Module, mesh: Mesh, zero1: bool, **kw):
    """BertAdam on ``mesh``: replicated or ZeRO-1 over the data-parallel
    ranks; under tensor parallelism with its norms summed over the tp ranks,
    and ZeRO-1 as ``train/zero1_tp.py``'s."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return (make_univl_zero1_optimizer(model, mesh, **kw) if zero1
                else make_univl_optimizer(model, **kw))
    if zero1:
        return make_univl_zero1_tp_optimizer(model, mesh, tp.sharded_ids(model), **kw)
    opt = make_univl_optimizer(model, **kw)
    opt.set_tensor_parallel(tp.mesh, tp.sharded_ids(model))
    return opt


BEST_BIN = "pytorch_model.bin.best"  # the best epoch's weights (JAX's best.msgpack)


def full_state_dict(model: torch.nn.Module) -> dict:
    """The model's weights in the tp=1 layout: gathered from the tp ranks'
    shares under tensor parallelism (a collective every rank calls)."""
    sd = model.state_dict()
    tp = getattr(model, "tp", None)
    return sd if tp is None else tp.gather_state_dict(sd)


def cpu_state_dict(model: torch.nn.Module, sd: Optional[dict] = None) -> dict:
    sd = model.state_dict() if sd is None else sd
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def make_input_iter(args, batcher, epoch: int, device: torch.device, start_batch: int = 0):
    """The epoch's update-batches on ``device`` as ``[accum, B, ...]``
    tensors (``univl_tpu/cli/common.py:492-514``): the host batches, their
    float arrays cast to ``--transfer_dtype``, then the copy. By default a
    worker thread builds the next batches and stages each one's copy to the
    card (``data/batching.py:DeviceTransfer``: pinned memory, a side stream)
    while the step runs; with ``--no_prefetch`` each batch is built and
    copied in the loop. ``start_batch`` skips that many update-batches (a
    resume inside the epoch)."""
    accum = args.gradient_accumulation_steps
    transfer_dtype = getattr(args, "transfer_dtype", "float32")

    def host_iter():
        for b in batcher.epoch(epoch, start_batch=start_batch):
            yield cast_floats({k: (v if accum > 1 else v[None]) for k, v in b.items()},
                              transfer_dtype)

    if getattr(args, "no_prefetch", False):
        return (to_device(b, device) for b in host_iter())
    # put in the worker: the pinning and the start of the copy overlap the step
    transfer = DeviceTransfer(device)
    return prefetch_to_device(host_iter(), put=transfer.put, ready=transfer.ready)


def make_preempt_flag(args) -> dict:
    """The SIGTERM handler every trainer's loop shares: it sets the returned
    flag (``{"hit": False}``), unless ``--no_preempt_checkpoint``."""
    preempt = {"hit": False}
    if not getattr(args, "no_preempt_checkpoint", False):
        def on_term(signum, frame):
            preempt["hit"] = True

        try:
            signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            pass  # not the main thread; --inject_preempt_after still works
    return preempt


def preempt_hit(args, preempt: dict, steps_since_start: int) -> bool:
    """The preemption flag after a step, set by ``--inject_preempt_after``
    once that many steps ran since the start (or the resume)."""
    if getattr(args, "inject_preempt_after", 0) and steps_since_start >= args.inject_preempt_after:
        preempt["hit"] = True
    return preempt["hit"]


def train_state(trainer: Trainer) -> dict:
    """What a train-state checkpoint holds: the parameters, and BertAdam's
    moments with its step count, in the tp=1 layout (under tensor
    parallelism gathered from the ranks' shares: a collective)."""
    model, opt = trainer.model, trainer.optimizer
    tp = getattr(model, "tp", None)
    if tp is None:
        return {"model": model.state_dict(), "optimizer": opt.state_dict()}
    return {"model": tp.gather_state_dict(model.state_dict()),
            "optimizer": tp.gather_optimizer_state(opt.state_dict(), model, opt)}


def load_train_state(trainer: Trainer, state: dict) -> None:
    """A train state in the tp=1 layout, cut to the rank's shares under
    tensor parallelism."""
    model, opt = trainer.model, trainer.optimizer
    tp = getattr(model, "tp", None)
    if tp is None:
        model.load_state_dict(state["model"], strict=True)
        opt.load_state_dict(state["optimizer"])
        return
    model.load_state_dict(tp.shard_state_dict(state["model"]), strict=True)
    opt.load_state_dict(tp.shard_optimizer_state(state["optimizer"], model, opt))


def _json_best(best: Optional[dict]) -> Optional[dict]:
    """The best epoch's metrics as JSON numbers and strings."""
    if best is None:
        return None
    return {k: (float(v) if isinstance(v, (np.floating, np.integer)) else v)
            for k, v in best.items()
            if isinstance(v, (int, float, str, np.floating, np.integer))}


def run_train_epochs(args, trainer: Trainer, batcher, logger, device: torch.device,
                     eval_fn: Optional[Callable[[int], dict]] = None,
                     select_key: Optional[str] = None, select_sign: float = 1.0,
                     manager=None, state_every_epoch: bool = False,
                     eval_model: Optional[torch.nn.Module] = None,
                     profile_dir: Optional[str] = None):
    """The epoch loop of ``univl_tpu.cli.common.run_train_epochs`` (and of
    ``univl_tpu/cli/pretrain.py``'s ``main``): the batches through
    ``make_input_iter``, one optimizer step, the losses summed on the device (read at display points
    and at the epoch's end, every loss of the step's dict in metrics.jsonl),
    and each epoch's weights saved as ``pytorch_model.bin.<epoch>`` (the
    reference's per-epoch file). With ``eval_fn(epoch)`` each epoch is then
    evaluated; the best epoch is the one with the largest ``select_sign *
    metrics[select_key]``, against a start of -inf as in JAX (an epoch whose
    metric is NaN is never the best), and its weights go to
    ``pytorch_model.bin.best`` (with the epoch and metrics in its ``.json``).

    The train state (``train_state``, in ``<output_dir>/train_state.pt``, or
    in ``manager``, a ``RotatingCheckpointManager``, at the global step) is
    saved after every epoch (unless ``--no_preempt_checkpoint``; always with
    ``state_every_epoch``), every ``--checkpoint_every_steps`` steps of an
    epoch, and on preemption (SIGTERM, or ``--inject_preempt_after``), after
    which the loop returns; with ``--async_checkpointing`` each save returns
    after the copy to the host and writes on a thread, and the loop waits for
    the write in flight before it returns or raises (a failed write raises
    there). Each save's blocking seconds go to metrics.jsonl. ``--load_checkpoint`` restores the parameters,
    the moments, BertAdam's step count, the epoch, the offset in it and the
    best so far, and the run goes on at the next update-batch: the batcher
    skips the done ones, each step's dropout comes from (seed, global step)
    and the dataset's draws from (seed, epoch, index), so the resumed run is
    bit for bit the uninterrupted one. ``--inject_crash_after`` raises after
    that many steps, without a checkpoint. Returns (the global step, the
    best epoch's metrics with its ``epoch``, or None without eval or when no
    epoch scored).

    Each update-batch is one ``trainer.train_steps`` call of K = 1 (JAX's
    one jitted step a batch): on a CUDA model its graph route, each step
    from the second a replay of the captured step, on the CPU the loop
    (``Trainer.step_route``). Where ``trainer.graph_refusal()`` names a
    reason (several ranks, gloo, tensor or sequence parallelism) the loop
    calls ``train_step``, a route chosen by that rule before any step, never
    a fallback after a failure. The route is logged once.

    metrics.jsonl opens with a ``mesh`` record (ranks, backend, device,
    zero1, and ``step_route``: ``graph``, ``eager: <the reason>`` or
    ``cpu``). Under data parallelism (the trainer's ``mesh``) rank 0 alone
    writes metrics.jsonl, each ``.bin`` and the train state, which every rank
    builds (with ``--zero1`` the moments gathered from their shards); the
    others wait at a barrier on the control group after each save and after
    each epoch's files. The ranks agree on a preemption after every step
    (the flag's maximum over the control group, so a SIGTERM that reaches
    one rank stops all at the same step), and rank 0 runs ``eval_fn`` and
    broadcasts the score of the selected metric. Under tensor parallelism
    every rank gathers the weights into the tp=1 layout after each epoch
    (``full_state_dict``), which rank 0 writes and loads into ``eval_model``
    (``make_eval_model``'s whole model) before ``eval_fn`` runs on it.

    With ``profile_dir`` (``--profile_dir``; the task CLIs pass it, as JAX's
    do, pretraining does not) every rank traces the steps JAX's loop traces
    (``univl_tpu/cli/common.py:611-665``) with ``torch.profiler``
    (``utils/profiling.py:StepTrace``): five update-batches from index 2 of
    the first epoch, counted from this run's start in it (a resumed epoch 0
    from its offset), carried into the next epoch if that one ends first;
    nothing when epoch 0 never reaches index 2 in this run. The session
    opens at index 1, a replay on the graph route, as its warmup step. The
    trace, ``<profile_dir>/rank<r>.<ms>.pt.trace.json``, is written after
    the fifth step, on a preemption before the train state is saved, at the
    loop's end, and when the loop raises; a trace that cannot be written
    raises."""
    mesh = getattr(trainer, "mesh", None) or Mesh()
    best, best_score = None, -np.inf
    global_step, start_epoch, start_step_in_epoch = 0, 0, 0
    ckpt_path = os.path.join(args.output_dir, TRAIN_STATE)
    if args.load_checkpoint:
        if manager is not None:
            state, meta, _ = manager.restore_latest()
        elif os.path.exists(ckpt_path):
            state, meta = restore_checkpoint(ckpt_path)
        else:
            state = None
        if state is None:
            # auto-restart loops pass --load_checkpoint every time; a wrong
            # --output_dir must not retrain from scratch silently
            logger.warning("--load_checkpoint: no checkpoint in %s; starting from scratch",
                           args.output_dir)
        else:
            load_train_state(trainer, state)
            start_epoch = int(meta["epoch"]) + 1
            global_step = int(meta["global_step"])
            start_step_in_epoch = int(meta.get("in_epoch_step", 0))
            if meta.get("best") is not None:
                best, best_score = dict(meta["best"]), float(meta["best_score"])
            logger.info("resumed at epoch %d, global_step %d (in-epoch offset %d)",
                        start_epoch + 1, global_step, start_step_in_epoch)
            del state
    preempt = make_preempt_flag(args)
    # the train state goes to the manager, or to train_state.pt through a
    # writer; both write on a thread with --async_checkpointing
    store = manager if manager is not None else CheckpointWriter(
        getattr(args, "async_checkpointing", False), primary=mesh.primary)
    stepped = isinstance(trainer, Trainer)  # else a stand-in with train_step alone
    route = trainer.step_route() if stepped else f"eager: a {type(trainer).__name__}"
    logger.info("training steps: %s", route)
    mw = MetricsWriter(args.output_dir if mesh.primary else None)
    mw.write("mesh", ranks=mesh.size, backend=mesh.backend, device=str(mesh.device),
             zero1=bool(getattr(trainer, "zero1", False)), tp=mesh.tp,
             sequence_parallel=mesh.sequence_parallel, step_route=route)
    if stepped and trainer.graph_refusal() is None:
        def train_step(batch, step):  # one train_steps call of K = 1
            metrics = trainer.train_steps({k: v[None] for k, v in batch.items()}, step)
            return {k: v[0] for k, v in metrics.items()}
    else:
        train_step = trainer.train_step

    def save_train_state(epoch: int, in_epoch_step: int, preempted: bool, **extra):
        meta = {"epoch": epoch - 1 if in_epoch_step else epoch, "global_step": global_step,
                "in_epoch_step": in_epoch_step, "preempted": preempted,
                "best": _json_best(best),
                "best_score": None if best is None else float(best_score), **extra}
        t0 = time.perf_counter()
        state = train_state(trainer)  # a collective under --zero1
        if manager is not None:
            manager.save(global_step, state, metrics=meta)
        else:
            store.save(ckpt_path, state, metadata=meta)
        del state
        blocked = time.perf_counter() - t0
        mesh.barrier()
        # the seconds the loop was held: the whole write, or with
        # --async_checkpointing the wait for the last one and the host copy
        logger.info("train state saved at step %d: the loop blocked %.3f s", global_step,
                    blocked)
        mw.write("checkpoint", epoch=epoch, step=global_step, preempted=preempted,
                 blocked_seconds=blocked)

    window = None  # the traced steps (profile_dir)

    def close_trace():
        nonlocal window
        closing, window = window, None
        if closing is not None:
            t0 = time.perf_counter()
            path = closing.close()
            if path:
                logger.info("profiler trace written to %s (%s, exported in %.3f s)", profile_dir,
                            os.path.basename(path), time.perf_counter() - t0)

    try:
        timer = StepTimer()
        accum = args.gradient_accumulation_steps
        items_per_step = args.batch_size * accum
        every = getattr(args, "checkpoint_every_steps", 0)
        crash_after = getattr(args, "inject_crash_after", 0)
        steps_at_start = global_step
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            loss_sum, n_steps = None, 0
            offset = start_step_in_epoch if epoch == start_epoch else 0
            with contextlib.closing(make_input_iter(args, batcher, epoch, device,
                                                    start_batch=offset)) as batches:
                for index, batch in enumerate(batches):
                    if profile_dir and epoch == 0 and index == 1:
                        window = StepTrace(profile_dir, device, rank=mesh.rank)
                    # a traced step's range holds all its device work, the loss's sum too
                    with (window.step(global_step) if window is not None
                          else contextlib.nullcontext()):
                        metrics = train_step(batch, global_step)
                        loss_sum = (metrics["loss"] if loss_sum is None
                                    else loss_sum + metrics["loss"])
                    if window is not None and window.done:
                        close_trace()
                    global_step += 1
                    n_steps += 1
                    timer.tick(items_per_step)
                    if global_step % args.n_display == 0:
                        shown = {k: float(v) for k, v in metrics.items()}
                        disp_loss = shown.pop("loss")
                        logger.info("Epoch %d/%d Step %d Loss %.6f %s Time/step %.3f (%.0f "
                                    "clips/s)", epoch + 1, args.epochs, global_step, disp_loss,
                                    shown, timer.ema or 0.0, timer.items_per_sec)
                        mw.write("train", epoch=epoch, step=global_step, loss=disp_loss,
                                 clips_per_sec=timer.items_per_sec, **shown)
                    if mesh.any(preempt_hit(args, preempt, global_step - steps_at_start)):
                        close_trace()  # the trace reaches disk before the train state
                        save_train_state(epoch, offset + n_steps, True)
                        logger.info("preempted at epoch %d step %d: checkpoint saved, exiting",
                                    epoch + 1, global_step)
                        return global_step, best
                    if crash_after and global_step - steps_at_start >= crash_after:
                        raise RuntimeError("injected crash (no checkpoint)")
                    if every and n_steps % every == 0:
                        save_train_state(epoch, offset + n_steps, False)
                        logger.info("periodic checkpoint at epoch %d step %d", epoch + 1,
                                    global_step)
            if window is not None and not window.traced:
                close_trace()  # epoch 0 ended before index 2: nothing traced, as in JAX
            total_loss = float(loss_sum) if loss_sum is not None else 0.0
            logger.info("Epoch %d done: mean loss %.6f (%.1fs)", epoch + 1,
                        total_loss / max(n_steps, 1), time.time() - t0)
            mw.write("epoch", epoch=epoch, mean_loss=total_loss / max(n_steps, 1),
                     seconds=time.time() - t0, steps=n_steps)
            # a SIGTERM after the epoch's last step saves now, before the eval:
            # a preemption's grace is tens of seconds
            if mesh.any(preempt["hit"]):
                close_trace()
                save_train_state(epoch, offset + n_steps, True)
                logger.info("preempted at epoch %d end: checkpoint saved, exiting", epoch + 1)
                return global_step, best
            full = None  # the weights in the tp=1 layout; gathering is a collective
            if mesh.primary or mesh.tp > 1:
                full = cpu_state_dict(trainer.model, full_state_dict(trainer.model))
            if mesh.primary:
                torch.save(full, os.path.join(args.output_dir, f"pytorch_model.bin.{epoch}"))
                if eval_fn is not None and eval_model is not None \
                        and eval_model is not trainer.model:
                    eval_model.load_state_dict(full, strict=True)
            if eval_fn is not None:
                metrics = eval_fn(epoch) if mesh.primary else None
                score = mesh.broadcast(select_sign * metrics[select_key] if mesh.primary
                                       else None)
                if score > best_score:
                    best_score = score
                    if mesh.primary:
                        best = dict(metrics, epoch=epoch)
                        save_checkpoint(os.path.join(args.output_dir, BEST_BIN), full,
                                        metadata={"epoch": epoch,
                                                  "metrics": _json_best(metrics)})
                if mesh.primary:
                    logger.info("Eval epoch %d: %s", epoch + 1, metrics)
                    mw.write("eval", epoch=epoch, **metrics)
            mesh.barrier()
            if state_every_epoch or not args.no_preempt_checkpoint:
                save_train_state(epoch, 0, False, mean_loss=total_loss / max(n_steps, 1))
        close_trace()
        if best is not None:
            logger.info("Best: epoch %d by %s, %s: %s", best["epoch"] + 1, select_key, BEST_BIN,
                        best)
            mw.write("best", **best)
        return global_step, best
    finally:
        try:
            close_trace()
        finally:
            store.wait()  # a failed write raises here
            mw.close()

