"""Command-line plumbing of the port's server, without JAX.

The port's own copies of ``univl_tpu/cli/common.py``'s ``get_logger`` and
``base_parser`` (restricted to the flags the serving path reads, under the
JAX names and defaults), ``build_config``, and the ``.bin`` branch of
``load_init_params``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import torch

from univl_tpu_torch.checkpoint.convert import init_state_dict, load_reference_bin
from univl_tpu_torch.config import UniVLConfig


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
    return p


def build_config(args, device: torch.device, task_type: str = "retrieval",
                 vocab_size: Optional[int] = None) -> UniVLConfig:
    """Layer counts, widths, lengths, video_dim, vocab size (text tower and
    decoder alike), the stage switches and the compute dtype (bf16 on a CUDA
    device, f32 on the CPU, unless --compute_dtype or --fp16 says otherwise)."""
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
        stage_two=args.stage_two,
        train_sim_after_cross=args.train_sim_after_cross,
        task_type=task_type,
        compute_dtype=dtype,
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


def load_init_params(args, model: torch.nn.Module, logger) -> None:
    """Seeded init (``--seed``), overlaid with ``--init_model`` when given.

    Only a reference PyTorch ``.bin`` is read here. The caption decoder's
    keys are dropped when the model builds no decoder; any other key the
    model does not have is an error. Parameters the file lacks stay at the
    seeded init, as in univl_tpu.cli.common.load_init_params."""
    sd = init_state_dict(model.cfg, args.seed)
    if args.init_model:
        if not args.init_model.endswith(".bin"):
            raise ValueError(f"--init_model: only a reference .bin loads here, got "
                             f"{args.init_model}")
        loaded = load_reference_bin(args.init_model)
        if not model.has_decoder:
            loaded = {k: v for k, v in loaded.items() if not k.startswith("decoder.")}
        unknown = sorted(set(loaded) - set(sd))
        if unknown:
            raise ValueError(f"{args.init_model}: keys the model does not have: {unknown[:20]}")
        missing = sorted(set(sd) - set(loaded))
        sd.update(loaded)
        logger.info("loaded %d params from %s; %d left at init%s", len(loaded),
                    args.init_model, len(missing), f": {missing[:8]}" if missing else "")
    model.load_state_dict(sd, strict=True)
