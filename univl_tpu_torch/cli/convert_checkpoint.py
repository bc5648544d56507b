"""Checkpoint converter of the PyTorch port, without JAX: a reference
``.bin`` to a flax params file, and back (``univl_tpu/cli/convert_checkpoint.py``'s
flags and report).

    python -m univl_tpu_torch.cli.convert_checkpoint \\
        --torch_bin weight/univl.pretrained.bin --output univl.pretrained.msgpack \\
        [--stage_two] [--do_pretrain] [--train_sim_after_cross] \\
        [--text_num_hidden_layers 12 ...]

builds the port's model from the flags (its parameter set is the JAX
model's), lays the ``.bin`` over its seeded init, prints how many of the
``.bin``'s tensors were converted, skipped as tied duplicates or unused
poolers, or not recognized, and how many parameters were left at the init,
and writes the parameter tree in flax's msgpack format (with a ``.json``
sidecar naming the source), which the JAX package's ``--init_model`` and
``restore_checkpoint`` read. The reverse:

    python -m univl_tpu_torch.cli.convert_checkpoint \\
        --export_torch --flax_params ckpt/params.msgpack.4 --output univl_exported.bin

writes a flax params file as a ``.bin`` in the reference's layout, the tied
duplicates written out.
"""

from __future__ import annotations

import argparse
import json

import torch

from univl_tpu_torch.checkpoint.convert import (
    init_state_dict,
    jax_params_from_state_dict,
    jax_path,
    load_reference_bin,
    reference_state_dict,
    sort_reference_names,
    state_dict_from_jax_params,
)
from univl_tpu_torch.checkpoint.io import read_flax_params, write_flax_params
from univl_tpu_torch.config import UniVLConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="reference .bin <-> flax params converter (PyTorch)")
    p.add_argument("--export_torch", action="store_true",
                   help="the reverse: a flax params file to a .bin in the reference layout, "
                        "the tied duplicates written out")
    p.add_argument("--flax_params", type=str, default=None,
                   help="with --export_torch: the params file (params.msgpack.<epoch>, "
                        "best.msgpack)")
    p.add_argument("--torch_bin", required=False)
    p.add_argument("--output", required=True)
    p.add_argument("--stage_two", action="store_true")
    p.add_argument("--do_pretrain", action="store_true")
    p.add_argument("--train_sim_after_cross", action="store_true")
    p.add_argument("--text_num_hidden_layers", type=int, default=12)
    p.add_argument("--visual_num_hidden_layers", type=int, default=6)
    p.add_argument("--cross_num_hidden_layers", type=int, default=2)
    p.add_argument("--decoder_num_hidden_layers", type=int, default=3)
    p.add_argument("--max_words", type=int, default=48)
    p.add_argument("--max_frames", type=int, default=48)
    p.add_argument("--video_dim", type=int, default=1024)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--vocab_size", type=int, default=30522)
    args = p.parse_args(argv)
    if args.export_torch and not args.flax_params:
        p.error("--export_torch requires --flax_params")
    if not args.export_torch and not args.torch_bin:
        p.error("--torch_bin required (or use --export_torch)")
    return args


def build_config(args) -> UniVLConfig:
    """The JAX CLI's config: its defaults, the flags' layer counts and
    stages, and the widths and vocab size where they differ from BERT-base."""
    cfg = UniVLConfig.base(
        text_num_hidden_layers=args.text_num_hidden_layers,
        visual_num_hidden_layers=args.visual_num_hidden_layers,
        cross_num_hidden_layers=args.cross_num_hidden_layers,
        decoder_num_hidden_layers=args.decoder_num_hidden_layers,
        max_words=args.max_words, max_frames=args.max_frames, video_dim=args.video_dim,
        stage_two=args.stage_two, do_pretrain=args.do_pretrain,
        train_sim_after_cross=args.train_sim_after_cross, use_mil=args.do_pretrain,
        batch_size_per_device=2)
    if (args.hidden_size, args.num_attention_heads, args.intermediate_size,
            args.vocab_size) != (768, 12, 3072, 30522):
        arch = dict(hidden_size=args.hidden_size, num_attention_heads=args.num_attention_heads,
                    intermediate_size=args.intermediate_size)
        cfg = cfg.replace(
            bert=cfg.bert.replace(vocab_size=args.vocab_size, **arch),
            visual=cfg.visual.replace(vocab_size=args.video_dim, **arch),
            cross=cfg.cross.replace(**arch),
            decoder=cfg.decoder.replace(vocab_size=args.vocab_size, **arch))
    return cfg.validate()


def main(argv=None):
    args = parse_args(argv)
    if args.export_torch:
        sd = state_dict_from_jax_params(read_flax_params(args.flax_params))
        torch.save(reference_state_dict(sd), args.output)
        print("wrote", args.output)
        return
    init = init_state_dict(build_config(args), seed=0)
    loaded = load_reference_bin(args.torch_bin)
    for name, v in loaded.items():
        if name in init and tuple(v.shape) != tuple(init[name].shape):
            raise ValueError(f"{args.torch_bin}: {name} has shape {tuple(v.shape)}, the model "
                             f"{tuple(init[name].shape)}")
    names = sort_reference_names(torch.load(args.torch_bin, map_location="cpu",
                                            weights_only=True))
    missing = [jax_path(k) for k in init if k not in loaded]
    print(f"converted={len(names['converted'])} skipped/tied={len(names['skipped'])} "
          f"unknown={len(names['unknown'])} left-at-init={len(missing)}")
    for name in names["unknown"]:
        print("  unknown torch param:", name)
    for name in missing:
        print("  left at random init:", name)
    merged = {k: loaded.get(k, v) for k, v in init.items()}
    write_flax_params(args.output, jax_params_from_state_dict(merged))
    with open(args.output + ".json", "w") as f:
        json.dump({"source": args.torch_bin}, f)
    print("wrote", args.output)


if __name__ == "__main__":
    main()
