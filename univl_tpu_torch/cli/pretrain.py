"""HowTo100M pretraining entry point of the PyTorch port (the reference's
main_pretrain.py), on one CUDA device.

Ports ``univl_tpu/cli/pretrain.py``. Stage I trains the text and visual
towers on the joint similarity with MIL-NCE (``--use_mil`` or
``--sampled_use_mil``) or the max-margin loss:

    python -m univl_tpu_torch.cli.pretrain --do_pretrain --device cuda \\
        --vocab_file vocab.txt --train_csv HowTo100M.csv --data_path caption.pickle \\
        --features_path features_dir --output_dir ckpt \\
        --batch_size 1920 --gradient_accumulation_steps 16 --n_pair 3 \\
        --lr 1e-4 --max_words 48 --max_frames 64 --sampled_use_mil

Stage II adds ``--stage_two --pretrain_enhance_vmodal`` and
``--init_model ckpt/pytorch_model.bin.<epoch>`` (stage I's file; the cross
tower, the decoder and the heads start at the seeded init): the five
objectives of ``models/univl.py``, the masked-language and masked-frame
losses, the joint similarity's, the decoder's and the cross similarity's
CrossEn. ``--fused_ffn`` and ``--fused_ln`` pick the FFN and LayerNorm
routes, as in the other trainers.

After each epoch: the train state (parameters, BertAdam's moments and step
count) in ``<output_dir>/train_state.pt``, or with ``--checkpoint_backend
orbax`` in a rotating ``<output_dir>/checkpoints/<step>/`` keeping the last
``--keep_checkpoints``, and the weights in ``pytorch_model.bin.<epoch>``
(the reference's name; JAX writes ``params.msgpack.<epoch>``).
``--checkpoint_every_steps N`` also saves the train state every N steps of
an epoch. On SIGTERM (or ``--inject_preempt_after``) the train state is
saved with the offset in the epoch and the run exits; ``--load_checkpoint``
resumes at the next update-batch, bit-identical to an uninterrupted run.
Losses at display points and epoch summaries go to ``metrics.jsonl``.
``--async_checkpointing`` copies the train state to the host and writes it
on a background thread (either backend); the loop waits for the write in
flight before the next save and before it returns. ``--remat`` (with
``--remat_policy dots``) recomputes the towers' layers in the backward. The
batches come through ``common.make_input_iter``. ``--n_gpu N`` pretrains on
N data-parallel ranks, each with MIL-NCE over its own rows of the global
batch, and ``--zero1`` shards BertAdam's state over them, as in
``task_retrieval`` (rank 0 writes the files and the checkpoints);
``--tensor_parallel`` and ``--sequence_parallel`` split the model over groups
of ranks as there (in stage II the masked-language head's logits and cross
entropy vocab-parallel too); the train state is written in the tp=1 layout,
so a run resumes at another tp size or with or without ``--zero1``.
``--do_eval`` and ``--task_type`` are parsed and ignored, and
``--profile_dir`` traces nothing, as in JAX's pretraining loop.
"""

from __future__ import annotations

import os
import pickle

from univl_tpu_torch.checkpoint.manager import RotatingCheckpointManager
from univl_tpu_torch.cli import common
from univl_tpu_torch.data.howto100m import HowTo100MPretrainDataset
from univl_tpu_torch.data.tokenization import WordPieceTokenizer

ENTRY = "univl_tpu_torch.cli.pretrain:main"  # what each spawned rank runs


def add_pretrain_args(p):
    p.add_argument("--min_words", type=int, default=0)
    p.add_argument("--min_time", type=float, default=5.0)
    p.add_argument("--use_data_replicate", type=int, default=0)  # parsed, unused, as in JAX
    p.add_argument("--pretrain_enhance_vmodal", action="store_true")
    p.add_argument("--checkpoint_model", type=str, default="pytorch_model.bin.checkpoint")
    p.add_argument("--checkpoint_backend", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="msgpack: one train_state.pt in --output_dir; orbax: rotating "
                        "per-step directories keeping the last --keep_checkpoints")
    p.add_argument("--keep_checkpoints", type=int, default=3,
                   help="orbax backend: how many checkpoints to keep")
    p.add_argument("--async_checkpointing", action="store_true",
                   help="write the train state on a background thread: the save returns "
                        "after the copy to the host; the next save and the end of the run "
                        "wait for the write")
    p.add_argument("--checkpoint_every_steps", type=int, default=0,
                   help="also save the train state every N update-steps within an epoch")
    p.add_argument("--inject_crash_after", type=int, default=0,
                   help="fault injection: raise (no checkpoint) after N steps")
    return p


def build_parser():
    parser = common.add_dist_backend_arg(add_pretrain_args(common.add_fused_ffn_arg(
        common.base_parser("UniVL Pretrain (PyTorch)"))))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the hand-written kernels) or cpu (their "
                             "plain PyTorch versions)")
    return parser


def parse_args(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    common.check_parallel_args(parser, args)
    if not args.vocab_file:
        parser.error("--vocab_file required")
    args.do_pretrain = True
    return args


def main(argv=None):
    """Pretrain; returns (the global step, the trainer; None when the
    command started its ranks itself)."""
    return common.run_on_ranks(ENTRY, argv, parse_args(argv), run,
                               portable=lambda result: (result[0], None))


def run(args, mesh):
    """``main`` on one rank."""
    args = common.finalize_args(args, mesh)
    logger = common.get_logger(args.output_dir, primary=mesh.primary)
    device = mesh.device
    tokenizer = WordPieceTokenizer(args.vocab_file, do_lower_case=args.do_lower_case)
    cfg = common.build_config(args, device, task_type="retrieval", vocab_size=len(tokenizer),
                              ranks=mesh.dp)
    model = common.make_model(args, cfg, device, logger, mesh)
    with open(args.data_path, "rb") as f:
        data_dict = pickle.load(f)
    ds = HowTo100MPretrainDataset(
        args.train_csv, data_dict, args.features_path, tokenizer,
        feature_framerate=args.feature_framerate, max_words=args.max_words,
        max_frames=args.max_frames, min_words=args.min_words, min_time=args.min_time,
        n_pair=args.n_pair, only_sim=not args.stage_two, use_mil=args.use_mil,
        sampled_use_mil=args.sampled_use_mil,
        pretrain_enhance_vmodal=args.pretrain_enhance_vmodal, video_dim=args.video_dim,
        seed=args.seed)
    batcher = common.make_batcher(args, ds, mesh)
    trainer = common.make_trainer(args, model, len(batcher), logger, mesh)
    manager = None
    if args.checkpoint_backend == "orbax":
        manager = RotatingCheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                                            max_to_keep=args.keep_checkpoints,
                                            async_save=args.async_checkpointing,
                                            primary=mesh.primary)
    if args.profile_dir and mesh.primary:
        logger.info("--profile_dir %s: pretraining traces no steps, as in JAX; task_retrieval "
                    "and task_caption do", args.profile_dir)
    steps, _ = common.run_train_epochs(args, trainer, batcher, logger, device, manager=manager,
                                       state_every_epoch=True)
    return steps, trainer


if __name__ == "__main__":
    main()
