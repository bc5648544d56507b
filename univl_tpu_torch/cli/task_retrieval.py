"""Retrieval fine-tuning and eval entry point of the PyTorch port: FT-Joint
and FT-Align on YouCook2 and MSRVTT.

Ports ``univl_tpu/cli/task_retrieval.py`` (the reference's
main_task_retrieval.py) on one CUDA device: the text and visual towers, the
mean-pooled joint similarity (FT-Joint) or, with ``--train_sim_after_cross``,
the cross encoder over all text-video pairs of the batch (FT-Align), the
max-margin ranking loss, BertAdam. ``--fused_ffn`` picks the FFN route: xla
(unfused, the default), pallas (kernel #3) or block (kernels #4 and #5);
``--fused_ln`` runs every LayerNorm through the LayerNorm kernel (#6). With
``--stage_two`` the similarity is the cross encoder's and the loss CrossEn
(stage-two retrieval fine-tuning).

``--do_eval`` scores ``--val_csv`` with ``evals/retrieval.py``: R@1/5/10,
MedianR and MeanR over the joint similarity, or over the cross encoder's
(the device-resident FT-Align rescoring) with ``--train_sim_after_cross`` or
``--stage_two``. With ``--do_train`` every epoch is evaluated and the best
is the one with the highest R@1; alone it evaluates ``--init_model``.

    python -m univl_tpu_torch.cli.task_retrieval --do_train [--do_eval] --device cuda \\
        --datatype youcook --vocab_file vocab.txt --train_csv train.csv \\
        --val_csv val.csv --data_path data.pickle --features_path features.pickle \\
        [--init_model univl.pretrained.bin] --output_dir ckpt \\
        --lr 3e-5 --epochs 5 --batch_size 32 --max_words 48 --max_frames 48 \\
        [--train_sim_after_cross --fused_ffn block]

MSRVTT (``--datatype msrvtt``): ``--train_csv`` lists the training videos,
``--data_path`` is the json of captions, ``--val_csv`` the JSFusion test csv
(video_id, sentence), ``--features_path`` the features pickle;
``--expand_msrvtt_sentences`` trains on every caption.

``--use_mil`` (or ``--sampled_use_mil``) trains stage one with MIL-NCE
over the unnormalised joint similarity.

Each epoch's weights go to ``<output_dir>/pytorch_model.bin.<epoch>``, the
best epoch's to ``pytorch_model.bin.best``, and the train state to
``train_state.pt`` after each epoch and on preemption (SIGTERM, or
``--inject_preempt_after``); ``--load_checkpoint`` resumes at the exact
update-batch. ``--do_pretrain`` is refused: pretraining's entry point is
``univl_tpu_torch.cli.pretrain``. ``--remat`` (with ``--remat_policy
dots``) recomputes the towers' layers in the backward; the training batches
come through ``common.make_input_iter`` and the eval batches through
``prefetch_to_device`` (read and tokenized while the device encodes) unless
``--no_prefetch``.

``--n_gpu N`` trains on N data-parallel ranks, one a card (0, the default,
is every visible card; one rank on the CPU), each with the similarity loss
over its own rows of the global ``--batch_size`` (the reference's
per-device negatives): the command starts its ranks itself, or joins
torchrun's. ``--zero1`` shards BertAdam's state over the ranks. Rank 0
writes every file and runs the eval (on its card alone).
``--dist_backend gloo`` may put several ranks on one card.
``--tensor_parallel T`` (which must divide the ranks) makes the ranks a
(dp, tp) grid: the weights are Megatron-split over each group of T ranks
(``parallel/tp.py``), which read the same rows, and ``--sequence_parallel``
also splits the encoders' LayerNorm, dropout and residual regions over their
rows (``parallel/sp.py``); ``--zero1`` then shards over dp
(``train/zero1_tp.py``). Rank 0 evaluates on a whole model gathered from the
shards. A (dp, tp) run computes what a dp-only run of the same dp size does.

    python -m univl_tpu_torch.cli.task_retrieval --do_train --n_gpu 8 [--zero1] \
        [--tensor_parallel 2 [--sequence_parallel]] ...
"""

from __future__ import annotations

from univl_tpu_torch.cli import common
from univl_tpu_torch.data.batching import Batcher, prefetch_to_device
from univl_tpu_torch.data.msrvtt import MsrvttRetrievalEvalDataset, MsrvttRetrievalTrainDataset
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.data.youcook import YoucookRetrievalDataset
from univl_tpu_torch.evals.retrieval import KEYS, RetrievalEvaluator

DATATYPES = ("youcook", "msrvtt")
ENTRY = "univl_tpu_torch.cli.task_retrieval:main"  # what each spawned rank runs
# flag -> why it is refused: the entry point that runs it
REFUSED = {
    "do_pretrain": "pretraining has its own entry point: python -m univl_tpu_torch.cli.pretrain",
}


def parse_args(argv=None):
    parser = common.add_parallel_args(common.add_fused_ffn_arg(
        common.base_parser("UniVL Retrieval (PyTorch)")))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the hand-written kernels) or cpu (their "
                             "plain PyTorch versions)")
    parser.add_argument("--do_eval", action="store_true",
                        help="R@K, MedianR and MeanR over --val_csv; with --do_train after "
                             "every epoch")
    for flag in REFUSED:
        parser.add_argument(f"--{flag}", action="store_true", help="refused here")
    args = parser.parse_args(argv)
    for flag, why in REFUSED.items():
        if getattr(args, flag):
            parser.error(f"--{flag}: {why}")
    common.check_parallel_args(parser, args)
    if not (args.do_train or args.do_eval):
        parser.error("give --do_train, --do_eval or both")
    if args.datatype not in DATATYPES:
        parser.error(f"--datatype {args.datatype}: choose from {DATATYPES}")
    if not args.vocab_file:
        parser.error("--vocab_file required")
    return args


def build_datasets(args, tokenizer):
    """(train set or None without --do_train, test set or None without --do_eval)."""
    if args.datatype == "youcook":
        def mk(csv):
            return YoucookRetrievalDataset(
                csv, args.data_path, args.features_path, tokenizer,
                feature_framerate=args.feature_framerate, max_words=args.max_words,
                max_frames=args.max_frames, seed=args.seed)

        return (mk(args.train_csv) if args.do_train else None,
                mk(args.val_csv) if args.do_eval else None)
    train = MsrvttRetrievalTrainDataset(
        args.train_csv, args.data_path, args.features_path, tokenizer,
        max_words=args.max_words, max_frames=args.max_frames,
        unfold_sentences=args.expand_msrvtt_sentences, seed=args.seed) if args.do_train else None
    test = MsrvttRetrievalEvalDataset(
        args.val_csv, args.features_path, tokenizer, max_words=args.max_words,
        max_frames=args.max_frames, seed=args.seed) if args.do_eval else None
    return train, test


def eval_batches(dataset, batch_size: int):
    """The test set in order, in batches of ``batch_size`` (the last one short)."""
    for batch in Batcher(dataset, batch_size, shuffle=False, drop_last=False).epoch(0):
        yield {k: batch[k] for k in KEYS}


def main(argv=None):
    """Train and/or evaluate; returns (optimizer steps taken, metrics): the
    best epoch's with --do_train --do_eval, the eval's with --do_eval alone,
    None with --do_train alone. --do_eval alone runs on one card."""
    args = parse_args(argv)
    if not args.do_train:
        common.one_card(args)
    return common.run_on_ranks(ENTRY, argv, args, run)


def run(args, mesh):
    """``main`` on one rank."""
    args = common.finalize_args(args, mesh)
    logger = common.get_logger(args.output_dir, primary=mesh.primary)
    device = mesh.device
    tokenizer = WordPieceTokenizer(args.vocab_file, do_lower_case=args.do_lower_case)
    cfg = common.build_config(args, device, task_type="retrieval", vocab_size=len(tokenizer),
                              ranks=mesh.dp)
    model = common.make_model(args, cfg, device, logger, mesh)
    eval_model = common.make_eval_model(args, cfg, model, mesh)
    train_ds, test_ds = build_datasets(args, tokenizer)

    eval_fn = None
    if args.do_eval:
        mode = "cross" if (cfg.train_sim_after_cross or cfg.stage_two) else "joint"
        # built once, outside eval_fn, as in the JAX CLI (on rank 0 alone
        # under tensor parallelism)
        evaluator = (RetrievalEvaluator(eval_model, batch_size=args.batch_size_val)
                     if eval_model is not None else None)

        def eval_fn(epoch=None):
            """The metrics, and the encode and similarity passes' seconds."""
            batches = eval_batches(test_ds, args.batch_size_val)
            if not args.no_prefetch:
                # host batches only: the evaluator pads and moves them itself
                batches = prefetch_to_device(batches)
            metrics = evaluator.evaluate(batches, mode=mode)
            metrics.update(evaluator.seconds)
            logger.info("Retrieval eval (%s) over %d pairs: %s", mode, len(test_ds), metrics)
            return metrics

    if not args.do_train:
        return 0, eval_fn()
    batcher = common.make_batcher(args, train_ds, mesh)
    trainer = common.make_trainer(args, model, len(batcher), logger, mesh)
    return common.run_train_epochs(args, trainer, batcher, logger, device, eval_fn=eval_fn,
                                   select_key="R1", select_sign=1.0, eval_model=eval_model)


if __name__ == "__main__":
    main()
