"""Caption fine-tuning and eval entry point of the PyTorch port, on YouCook2
and MSRVTT.

Ports ``univl_tpu/cli/task_caption.py`` (the reference's
main_task_caption.py): stage two with the caption task, the text
(transcript), visual and cross towers and the decoder under teacher forcing,
the masked cross entropy over the tied classifier's logits, BertAdam, one
CUDA device. ``--do_eval`` decodes the val split
with beam 5 (the KV-cache beam search of ``evals/beam.py``, on its fused
kernels on a CUDA device) and scores BLEU-1..4, METEOR, ROUGE-L and CIDEr;
with ``--do_train`` every epoch is evaluated and the best is the one with
the highest BLEU-4; ``--do_eval`` alone evaluates the ``--init_model``
weights. ``--fused_ln`` runs every LayerNorm through the LayerNorm kernel
(#6), forward and backward; ``--fused_cls`` runs the decoder's classifier
transform inside the vocab top-k kernel (#10t) when the fused vocab kernel
runs. ``--datatype msrvtt`` reads the reference's MSRVTT caption files
(``--data_path`` the json, ``--features_path`` the features pickle; the
positional train and test splits of the json's videos), video only, and
scores each clip against all its references.

    python -m univl_tpu_torch.cli.task_caption --do_train [--do_eval] --stage_two \\
        --datatype youcook --device cuda --vocab_file vocab.txt \\
        --train_csv train.csv --val_csv val.csv --data_path data.pickle \\
        --features_path features.pickle [--init_model univl.pretrained.bin] \\
        --output_dir ckpt --lr 3e-5 --epochs 5 --batch_size 16 \\
        --max_words 128 --max_frames 96 [--fused_ln]

Each epoch's weights go to ``<output_dir>/pytorch_model.bin.<epoch>``, the
best epoch's to ``pytorch_model.bin.best``, each eval's captions and
references to ``hyp.<epoch>.txt`` and ``ref.<epoch>.txt``, and the train
state to ``train_state.pt`` after each epoch and on preemption;
``--load_checkpoint`` resumes at the exact update-batch. ``--use_mil`` is
accepted and ignored, as by JAX's driver (stage two has no MIL loss);
``--do_pretrain`` is refused: pretraining's entry point is
``univl_tpu_torch.cli.pretrain``. ``--remat`` (with ``--remat_policy
dots``) recomputes the towers' layers in the backward (the decoder's are
kept, as in JAX); the training batches come through
``common.make_input_iter`` and the eval batches through
``prefetch_to_device`` (built while the beam search runs) unless
``--no_prefetch``. ``--n_gpu N`` trains on N data-parallel ranks and
``--zero1`` shards BertAdam's state over them, as in ``task_retrieval``
(rank 0 writes the files and runs the eval); ``--tensor_parallel`` and
``--sequence_parallel`` split the model over groups of ranks as there: the
decoder's attention and FFN, its vocab-parallel word lookup, the tied
classifier's logits and the cross entropy over them too (the decoder's
regions stay whole under ``--sequence_parallel``, as in JAX).
"""

from __future__ import annotations

import os

from univl_tpu_torch.cli import common
from univl_tpu_torch.data.batching import Batcher, prefetch_to_device
from univl_tpu_torch.data.msrvtt import MsrvttCaptionDataset
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.data.youcook import YoucookCaptionDataset
from univl_tpu_torch.evals.beam import CaptionGenerator
from univl_tpu_torch.evals.caption_metrics import compute_caption_metrics
from univl_tpu_torch.serving.captioning import resolve_fused

ENTRY = "univl_tpu_torch.cli.task_caption:main"  # what each spawned rank runs
# flag -> why it is refused: the entry point that runs it
REFUSED = {
    "do_pretrain": "pretraining has its own entry point: python -m univl_tpu_torch.cli.pretrain",
}
DATATYPES = ("youcook", "msrvtt")
EVAL_KEYS = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")
BEAM_SIZE = 5


def parse_args(argv=None):
    parser = common.add_parallel_args(common.add_fused_ffn_arg(
        common.base_parser("UniVL Caption (PyTorch)")))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the hand-written kernels) or cpu (their "
                             "plain PyTorch versions)")
    parser.add_argument("--do_eval", action="store_true",
                        help="beam-5 captions of --val_csv and their metrics; with --do_train "
                             "after every epoch")
    for flag in REFUSED:
        parser.add_argument(f"--{flag}", action="store_true", help="refused here")
    args = parser.parse_args(argv)
    for flag, why in REFUSED.items():
        if getattr(args, flag):
            parser.error(f"--{flag}: {why}")
    common.check_parallel_args(parser, args)
    if args.datatype not in DATATYPES:
        parser.error(f"--datatype {args.datatype}: choose from {DATATYPES}")
    if args.train_sim_after_cross:
        parser.error("--train_sim_after_cross builds no caption decoder")
    if not (args.do_train or args.do_eval):
        parser.error("give --do_train, --do_eval or both")
    if not args.vocab_file:
        parser.error("--vocab_file required")
    args.stage_two = True  # the caption task is stage two's, as in the JAX driver
    return args


def build_datasets(args, tokenizer):
    """(train set or None without --do_train, eval set or None without --do_eval)."""
    if args.datatype == "youcook":
        def mk(csv):
            return YoucookCaptionDataset(
                csv, args.data_path, args.features_path, tokenizer,
                feature_framerate=args.feature_framerate, max_words=args.max_words,
                max_frames=args.max_frames, seed=args.seed)

        return (mk(args.train_csv) if args.do_train else None,
                mk(args.val_csv) if args.do_eval else None)

    def mk_msrvtt(split):
        return MsrvttCaptionDataset(args.train_csv, args.data_path, args.features_path,
                                    tokenizer, split_type=split, max_words=args.max_words,
                                    max_frames=args.max_frames, seed=args.seed)

    return (mk_msrvtt("train") if args.do_train else None,
            mk_msrvtt("test") if args.do_eval else None)


def references_for(dataset, idx: int):
    """Every reference caption of clip ``idx``: MSRVTT's ~20, YouCook2's one."""
    if hasattr(dataset, "references"):
        return list(dataset.references(idx))
    return [dataset.reference_caption(idx)]


def make_eval_fn(args, model, tokenizer, device, val_ds, logger):
    """eval_fn(epoch or None) -> metrics: beam-5 captions of the val split
    in batches of ``min(--batch_size_val, 32)``, their metrics, and the
    hypotheses and references written to the output dir. Each call builds
    its generator: the KV-cache decoder takes the weights as they are then."""
    batcher = Batcher(val_ds, min(args.batch_size_val, 32), shuffle=False, drop_last=False,
                      num_workers=args.num_thread_reader)

    def eval_fn(epoch=None):
        model.eval()
        gen = CaptionGenerator(model, tokenizer, device, beam_size=BEAM_SIZE,
                               max_len=args.max_words,
                               fused_decode=resolve_fused(args.fused_decode, device),
                               fused_vocab=resolve_fused(args.fused_vocab, device),
                               fused_cls=args.fused_cls)
        hyps = []
        batches = batcher.epoch(0)
        if not args.no_prefetch:
            # host batches only: the generator moves them to the device itself
            batches = prefetch_to_device(batches)
        for batch in batches:
            hyps.extend(gen.generate({k: batch[k] for k in EVAL_KEYS}))
        refs = [references_for(val_ds, i) for i in range(len(hyps))]
        metrics = compute_caption_metrics(refs, hyps)
        tag = "" if epoch is None else f".{epoch}"
        for name, lines in (("hyp", hyps), ("ref", [r[0] for r in refs])):
            with open(os.path.join(args.output_dir, f"{name}{tag}.txt"), "w") as f:
                f.write("\n".join(lines))
        logger.info("Caption eval over %d clips: %s", len(hyps), metrics)
        return metrics

    return eval_fn


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
    cfg = common.build_config(args, device, task_type="caption", vocab_size=len(tokenizer),
                              ranks=mesh.dp)
    model = common.make_model(args, cfg, device, logger, mesh)
    eval_model = common.make_eval_model(args, cfg, model, mesh)
    train_ds, val_ds = build_datasets(args, tokenizer)

    eval_fn = None
    if args.do_eval:
        eval_fn = make_eval_fn(args, eval_model, tokenizer, device, val_ds, logger)
    if not args.do_train:
        return 0, eval_fn()
    batcher = common.make_batcher(args, train_ds, mesh)
    trainer = common.make_trainer(args, model, len(batcher), logger, mesh)
    return common.run_train_epochs(args, trainer, batcher, logger, device, eval_fn=eval_fn,
                                   select_key="Bleu_4", eval_model=eval_model)


if __name__ == "__main__":
    main()
