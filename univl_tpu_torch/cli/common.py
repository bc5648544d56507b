"""Command-line plumbing of the port's entry points (the server, the
retrieval and caption trainers and pretraining), without JAX.

The port's own copies of ``univl_tpu/cli/common.py``'s ``MetricsWriter``,
``get_logger``, ``base_parser`` (restricted to the flags the ported paths
read, under the JAX names and defaults, plus ``--fused_ln`` and
``--fused_cls``, the counterparts of JAX's ``UNIVL_TPU_FUSED_LN=1`` and
``UNIVL_TPU_FUSED_CLS=1``), ``add_fused_ffn_arg`` (the
trainers' ``--fused_ffn``), ``finalize_args``, ``build_config``,
``load_init_params`` (a reference or port ``.bin``, or a JAX flax params
``.msgpack``; in ``make_model``), ``make_trainer``, ``make_preempt_flag``,
``preempt_hit`` and ``run_train_epochs`` (per-epoch eval and the best
epoch, preemption, the train-state checkpoints and exact resume).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import signal
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
    merge_state_dict,
    read_flax_params,
    restore_checkpoint,
    save_checkpoint,
)
from univl_tpu_torch.config import TPU_THRESHOLD, UniVLConfig
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.nn.layers import set_fused_layer_norm
from univl_tpu_torch.train.optimization import make_univl_optimizer
from univl_tpu_torch.train.trainer import Trainer
from univl_tpu_torch.utils.profiling import StepTimer


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


def get_logger(output_dir: Optional[str] = None, name: str = "univl_tpu_torch"):
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
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


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--do_train", action="store_true")
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
                        "attention kernel). Unset: on for a CUDA device, off on the CPU")
    p.add_argument("--fused_vocab", action=argparse.BooleanOptionalAction, default=None,
                   help="beam decode: the tied classifier, its log-softmax normalizer and "
                        "the per-row top-K in one pass over vocab tiles (the vocab top-k "
                        "kernel); the [B*K, V] logits are never written. Unset: on for a "
                        "CUDA device, off on the CPU")
    p.add_argument("--fused_cls", action="store_true",
                   help="beam decode: the classifier transform (dense, erf-GELU, LayerNorm) "
                        "inside the vocab top-k kernel, in f32 with one rounding; only with "
                        "the fused vocab kernel, ignored with a warning otherwise (off by "
                        "default, as JAX's UNIVL_TPU_FUSED_CLS)")
    p.add_argument("--fused_ln", action="store_true",
                   help="every LayerNorm of the model through the LayerNorm kernel, forward "
                        "and backward (off by default, as JAX's UNIVL_TPU_FUSED_LN)")
    return p


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


def finalize_args(args):
    """The batch divided by gradient accumulation (the reference's global
    batch over its micro-batches), the resolved flags in ``args.json``, and
    Python's and numpy's global seeds."""
    if args.gradient_accumulation_steps < 1:
        raise ValueError("gradient_accumulation_steps must be >= 1")
    args.batch_size = int(args.batch_size / args.gradient_accumulation_steps)
    if args.sampled_use_mil:
        args.use_mil = True
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=1, default=str)
    random.seed(args.seed)
    np.random.seed(args.seed)
    os.environ["PYTHONHASHSEED"] = str(args.seed)
    return args


def build_config(args, device: torch.device, task_type: str = "retrieval",
                 vocab_size: Optional[int] = None) -> UniVLConfig:
    """Layer counts, widths, lengths, video_dim, vocab size (text tower and
    decoder alike), the stage switches, the loss fields, the (micro-)batch,
    the FFN route (``--fused_ffn``, where the parser has it) and the compute
    dtype (bf16 on a CUDA device, f32 on the CPU, unless
    --compute_dtype or --fp16 says otherwise)."""
    dtype = args.compute_dtype or (
        "bfloat16" if (device.type == "cuda" or args.fp16) else "float32")
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
        batch_size_per_device=args.batch_size,
        compute_dtype=dtype,
        use_fused_ffn=FUSED_FFN[getattr(args, "fused_ffn", "xla")],
    )
    arch = {}
    if args.hidden_size != 768:
        arch.update(hidden_size=args.hidden_size)
    if args.num_attention_heads != 12:
        arch.update(num_attention_heads=args.num_attention_heads)
    if args.intermediate_size != 3072:
        arch.update(intermediate_size=args.intermediate_size)
    bert = cfg.bert.replace(**arch)
    decoder = cfg.decoder.replace(**arch)
    if vocab_size is not None:
        bert = bert.replace(vocab_size=vocab_size)
        decoder = decoder.replace(vocab_size=vocab_size)
    visual = cfg.visual.replace(**arch, vocab_size=args.video_dim)
    cross = cfg.cross.replace(**arch)
    return cfg.replace(bert=bert, visual=visual, cross=cross, decoder=decoder).validate()


def make_model(args, cfg: UniVLConfig, device: torch.device, logger) -> UniVL:
    """The model on ``device``, its LayerNorms on the kernel with
    ``--fused_ln``, its weights from ``load_init_params``."""
    model = UniVL(cfg, device=device)
    set_fused_layer_norm(model, args.fused_ln)
    load_init_params(args, model, logger)
    return model


def load_init_params(args, model: torch.nn.Module, logger) -> None:
    """Seeded init (``--seed``), overlaid with ``--init_model`` when given:
    a reference PyTorch ``.bin`` (or a ``pytorch_model.bin.<epoch>`` either
    package wrote), or a JAX flax params file (``params.msgpack.<epoch>``,
    ``best.msgpack``). The caption decoder's keys are dropped when the model
    builds no decoder, the pretraining heads' when it builds none; any other
    key the model does not have is an error. Parameters the file lacks stay
    at the seeded init, as in univl_tpu.cli.common.load_init_params."""
    sd = init_state_dict(model.cfg, args.seed)
    if args.init_model:
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
        sd, missing = merge_state_dict(sd, loaded, args.init_model)
        logger.info("loaded %d params from %s; %d left at init%s", len(loaded),
                    args.init_model, len(missing), f": {missing[:8]}" if missing else "")
    model.load_state_dict(sd, strict=True)


def make_trainer(args, model: torch.nn.Module, n_train_batches: int, logger) -> Trainer:
    """BertAdam over ``t_total = n_train_batches * epochs`` updates, and the
    single-device trainer with ``--gradient_accumulation_steps``."""
    t_total = n_train_batches * args.epochs
    opt = make_univl_optimizer(
        model, lr=args.lr, t_total=max(t_total, 1), warmup_proportion=args.warmup_proportion,
        coef_lr=args.coef_lr, state_dtype=args.adam_state_dtype)
    logger.info("one device (%s); t_total=%d", next(model.parameters()).device, t_total)
    return Trainer(model, opt, grad_accum_steps=args.gradient_accumulation_steps,
                   seed=args.seed)


BEST_BIN = "pytorch_model.bin.best"  # the best epoch's weights (JAX's best.msgpack)


def cpu_state_dict(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}


def save_state_dict(model: torch.nn.Module, path: str) -> None:
    """The model's weights under the reference names, on the CPU, as a
    torch ``.bin`` that both packages' ``--init_model`` read."""
    torch.save(cpu_state_dict(model), path)


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
    moments with its step count."""
    return {"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict()}


def load_train_state(trainer: Trainer, state: dict) -> None:
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.optimizer.load_state_dict(state["optimizer"])


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
                     manager=None, state_every_epoch: bool = False):
    """The epoch loop of ``univl_tpu.cli.common.run_train_epochs`` (and of
    ``univl_tpu/cli/pretrain.py``'s ``main``): each batch to the device, one
    optimizer step, the losses summed on the device (read at display points
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
    which the loop returns. ``--load_checkpoint`` restores the parameters,
    the moments, BertAdam's step count, the epoch, the offset in it and the
    best so far, and the run goes on at the next update-batch: the batcher
    skips the done ones, each step's dropout comes from (seed, global step)
    and the dataset's draws from (seed, epoch, index), so the resumed run is
    bit for bit the uninterrupted one. ``--inject_crash_after`` raises after
    that many steps, without a checkpoint. Returns (the global step, the
    best epoch's metrics with its ``epoch``, or None without eval or when no
    epoch scored)."""
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

    def save_train_state(epoch: int, in_epoch_step: int, preempted: bool, **extra):
        meta = {"epoch": epoch - 1 if in_epoch_step else epoch, "global_step": global_step,
                "in_epoch_step": in_epoch_step, "preempted": preempted,
                "best": _json_best(best),
                "best_score": None if best is None else float(best_score), **extra}
        if manager is not None:
            manager.save(global_step, train_state(trainer), metrics=meta)
        else:
            save_checkpoint(ckpt_path, train_state(trainer), metadata=meta)

    timer = StepTimer()
    mw = MetricsWriter(args.output_dir)
    accum = args.gradient_accumulation_steps
    items_per_step = args.batch_size * accum
    every = getattr(args, "checkpoint_every_steps", 0)
    crash_after = getattr(args, "inject_crash_after", 0)
    steps_at_start = global_step
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        loss_sum, n_steps = None, 0
        offset = start_step_in_epoch if epoch == start_epoch else 0
        for batch in batcher.epoch(epoch, start_batch=offset):
            batch = {k: torch.from_numpy(v if accum > 1 else v[None]).to(device)
                     for k, v in batch.items()}
            metrics = trainer.train_step(batch, global_step)
            global_step += 1
            n_steps += 1
            loss_sum = metrics["loss"] if loss_sum is None else loss_sum + metrics["loss"]
            timer.tick(items_per_step)
            if global_step % args.n_display == 0:
                shown = {k: float(v) for k, v in metrics.items()}
                disp_loss = shown.pop("loss")
                logger.info("Epoch %d/%d Step %d Loss %.6f %s Time/step %.3f (%.0f clips/s)",
                            epoch + 1, args.epochs, global_step, disp_loss, shown,
                            timer.ema or 0.0, timer.items_per_sec)
                mw.write("train", epoch=epoch, step=global_step, loss=disp_loss,
                         clips_per_sec=timer.items_per_sec, **shown)
            if preempt_hit(args, preempt, global_step - steps_at_start):
                save_train_state(epoch, offset + n_steps, True)
                logger.info("preempted at epoch %d step %d: checkpoint saved, exiting",
                            epoch + 1, global_step)
                mw.close()
                return global_step, best
            if crash_after and global_step - steps_at_start >= crash_after:
                raise RuntimeError("injected crash (no checkpoint)")
            if every and n_steps % every == 0:
                save_train_state(epoch, offset + n_steps, False)
                logger.info("periodic checkpoint at epoch %d step %d", epoch + 1, global_step)
        total_loss = float(loss_sum) if loss_sum is not None else 0.0
        logger.info("Epoch %d done: mean loss %.6f (%.1fs)", epoch + 1,
                    total_loss / max(n_steps, 1), time.time() - t0)
        mw.write("epoch", epoch=epoch, mean_loss=total_loss / max(n_steps, 1),
                 seconds=time.time() - t0, steps=n_steps)
        # a SIGTERM after the epoch's last step saves now, before the eval:
        # a preemption's grace is tens of seconds
        if preempt["hit"]:
            save_train_state(epoch, offset + n_steps, True)
            logger.info("preempted at epoch %d end: checkpoint saved, exiting", epoch + 1)
            mw.close()
            return global_step, best
        save_state_dict(trainer.model, os.path.join(args.output_dir,
                                                    f"pytorch_model.bin.{epoch}"))
        if eval_fn is not None:
            metrics = eval_fn(epoch)
            score = select_sign * metrics[select_key]
            if score > best_score:
                best_score, best = score, dict(metrics, epoch=epoch)
                save_checkpoint(os.path.join(args.output_dir, BEST_BIN), cpu_state_dict(
                    trainer.model), metadata={"epoch": epoch, "metrics": _json_best(metrics)})
            logger.info("Eval epoch %d: %s", epoch + 1, metrics)
            mw.write("eval", epoch=epoch, **metrics)
        if state_every_epoch or not args.no_preempt_checkpoint:
            save_train_state(epoch, 0, False, mean_loss=total_loss / max(n_steps, 1))
    if best is not None:
        logger.info("Best: epoch %d by %s, %s: %s", best["epoch"] + 1, select_key, BEST_BIN,
                    best)
        mw.write("best", **best)
    mw.close()
    return global_step, best
