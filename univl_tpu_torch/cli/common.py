"""Model configuration and weights for the port's command-line tools, without JAX.

Ports the parts of ``univl_tpu/cli/common.py`` (``build_config`` and the
``.bin`` branch of ``load_init_params``) that the retrieval-serving path
reads. The argument parser itself is shared: ``univl_tpu.cli.common.base_parser``.
"""

from __future__ import annotations

from typing import Optional

import torch

from univl_tpu.config import UniVLConfig
from univl_tpu_torch.checkpoint.convert import init_state_dict, load_reference_bin


def build_config(args, device: torch.device, vocab_size: Optional[int] = None) -> UniVLConfig:
    """Layer counts, widths, lengths, video_dim, vocab size, the cross-tower
    switches and the compute dtype (bf16 on a CUDA device, f32 on the CPU,
    unless --compute_dtype or --fp16 says otherwise)."""
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
    if vocab_size is not None:
        bert = bert.replace(vocab_size=vocab_size)
    visual = cfg.visual.replace(**arch, vocab_size=args.video_dim)
    cross = cfg.cross.replace(**arch)
    return cfg.replace(bert=bert, visual=visual, cross=cross).validate()


def load_init_params(args, model: torch.nn.Module, logger) -> None:
    """Seeded init (``--seed``), overlaid with ``--init_model`` when given.

    Only a reference PyTorch ``.bin`` is read here. Its keys that the model
    does not have are an error; parameters it lacks stay at the seeded init,
    as in univl_tpu.cli.common.load_init_params."""
    sd = init_state_dict(model.cfg, args.seed)
    if args.init_model:
        if not args.init_model.endswith(".bin"):
            raise ValueError(f"--init_model: only a reference .bin loads here, got "
                             f"{args.init_model}")
        loaded = load_reference_bin(args.init_model)
        unknown = sorted(set(loaded) - set(sd))
        if unknown:
            raise ValueError(f"{args.init_model}: keys the model does not have: {unknown[:20]}")
        missing = sorted(set(sd) - set(loaded))
        sd.update(loaded)
        logger.info("loaded %d params from %s; %d left at init%s", len(loaded),
                    args.init_model, len(missing), f": {missing[:8]}" if missing else "")
    model.load_state_dict(sd, strict=True)
