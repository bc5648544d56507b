"""Retrieval fine-tuning entry point of the PyTorch port: FT-Joint and
FT-Align on YouCook2.

Ports the ``--do_train --datatype youcook`` path of
``univl_tpu/cli/task_retrieval.py`` (the reference's main_task_retrieval.py):
the text and visual towers, the mean-pooled joint similarity (FT-Joint) or,
with ``--train_sim_after_cross``, the cross encoder over all text-video
pairs of the batch (FT-Align), the max-margin ranking loss, BertAdam, one
CUDA device. ``--fused_ffn`` picks the FFN route: xla (unfused, the
default), pallas (kernel #3) or block (kernels #4 and #5); ``--fused_ln``
runs every LayerNorm through the LayerNorm kernel (#6). With
``--stage_two`` the similarity is the cross encoder's and the loss CrossEn
(stage-two retrieval fine-tuning).

    python -m univl_tpu_torch.cli.task_retrieval --do_train --device cuda \\
        --datatype youcook --vocab_file vocab.txt \\
        --train_csv train.csv --data_path data.pickle --features_path features.pickle \\
        [--init_model univl.pretrained.bin] --output_dir ckpt \\
        --lr 3e-5 --epochs 5 --batch_size 32 --max_words 48 --max_frames 48 \\
        [--train_sim_after_cross --fused_ffn block]

Each epoch's weights go to ``<output_dir>/pytorch_model.bin.<epoch>``. The
flags of paths not ported yet are refused with an error that names the
slice each waits for.
"""

from __future__ import annotations

from univl_tpu_torch.cli import common
from univl_tpu_torch.data.batching import Batcher
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.data.youcook import YoucookRetrievalDataset

# flag -> the slice of the port that will run it
NOT_PORTED = {
    "do_eval": "retrieval eval",
    "do_pretrain": "pretraining",
    "load_checkpoint": "checkpointing",
    "zero1": "multi-device",
    # torch.utils.checkpoint re-runs the forward, which would draw new Philox
    # seeds from the step's generator: the recomputed dropout would differ
    "remat": "activation checkpointing (dropout seeds replayed in the recomputed forward)",
    "use_mil": "pretraining",
    "sampled_use_mil": "pretraining",
}


def parse_args(argv=None):
    parser = common.add_fused_ffn_arg(common.base_parser("UniVL Retrieval (PyTorch)"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the hand-written kernels) or cpu (their "
                             "plain PyTorch versions)")
    for flag in ("do_eval", "do_pretrain", "load_checkpoint", "zero1", "remat",
                 "sampled_use_mil"):
        parser.add_argument(f"--{flag}", action="store_true", help="not ported yet")
    parser.add_argument("--n_gpu", type=int, default=1, help="devices; only 1 is ported")
    parser.add_argument("--tensor_parallel", type=int, default=1, help="only 1 is ported")
    args = parser.parse_args(argv)
    for flag, lifted_by in NOT_PORTED.items():
        if getattr(args, flag):
            parser.error(f"--{flag} is not ported yet (waits for the {lifted_by} slice)")
    for flag in ("n_gpu", "tensor_parallel"):
        if getattr(args, flag) > 1:
            parser.error(f"--{flag} {getattr(args, flag)}: one device only (waits for the "
                         f"multi-device slice)")
    if not args.do_train:
        parser.error("--do_train is the only ported mode")
    if args.datatype != "youcook":
        parser.error(f"--datatype {args.datatype} is not ported yet (youcook only)")
    if not args.vocab_file:
        parser.error("--vocab_file required")
    return args


def main(argv=None) -> int:
    """Train; returns the number of optimizer steps taken."""
    args = common.finalize_args(parse_args(argv))
    logger = common.get_logger(args.output_dir)
    device = common.resolve_device(args.device)
    tokenizer = WordPieceTokenizer(args.vocab_file, do_lower_case=args.do_lower_case)
    cfg = common.build_config(args, device, task_type="retrieval", vocab_size=len(tokenizer))
    model = common.make_model(args, cfg, device, logger)
    train_ds = YoucookRetrievalDataset(
        args.train_csv, args.data_path, args.features_path, tokenizer,
        feature_framerate=args.feature_framerate, max_words=args.max_words,
        max_frames=args.max_frames, seed=args.seed)
    batcher = Batcher(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                      grad_accum=args.gradient_accumulation_steps,
                      num_workers=args.num_thread_reader)
    trainer = common.make_trainer(args, model, len(batcher), logger)
    return common.run_train_epochs(args, trainer, batcher, logger, device)[0]


if __name__ == "__main__":
    main()
