"""HTTP server of the PyTorch port: retrieval search and captioning.

Ports ``univl_tpu/cli/serve.py``: the same flags, endpoints and JSON
shapes, plus ``--device``. Device work is serialised behind one lock.

    python -m univl_tpu_torch.cli.serve --device cuda --mode retrieval \\
        --train_sim_after_cross --rerank_store_full \\
        --vocab_file vocab.txt --output_dir out \\
        [--init_model univl.pretrained.bin] [--index corpus_index.npz] --port 8080

    python -m univl_tpu_torch.cli.serve --device cuda --mode caption \\
        --vocab_file vocab.txt --output_dir out --port 8080 \\
        [--no-fused_decode] [--no-fused_vocab] [--fused_cls] [--decode_unroll U]

Endpoints:
  GET  /healthz                  -> {"status": "ok", "mode", "indexed"}
  POST /v1/retrieval/add         {"videos": [[[f..]..]..] | "feature_paths":
                                  [".npy"...], "ids": [...]}
  POST /v1/retrieval/search      {"queries": [...], "top_k": 5, "rerank": 0}
  POST /v1/retrieval/save        {"path": "index.npz"}
  POST /v1/caption               {"videos" | "feature_paths", "transcripts"?}
                                 -> {"captions": [...]}

``--mode caption`` and ``--mode both`` build the caption decoder (they
imply ``--stage_two``); concurrent caption requests are merged into shared
decode batches unless ``--no-coalesce_captions``. ``--fused_ln`` runs every
LayerNorm through the LayerNorm kernel (#6); ``--fused_cls`` runs the
classifier transform inside the vocab top-k kernel (#10t), with the fused
vocab kernel only. On a CUDA device a caption batch is one CUDA graph replay
for the encode and one for every ``--decode_unroll`` decode steps, and the
index's encode batches and rerank tiles are one replay each; in ``--mode
both`` the index and the caption generator keep their graphs in pools of
their own, and the one lock keeps their captures and replays apart.

The server takes every flag of ``common.base_parser``, as JAX's takes its
``base_parser``'s: ``--fused_ffn`` picks the encoders' FFN route,
``--do_pretrain`` goes to the model's config (``common.build_config``), and
the rest of the training flags (``--do_eval``, ``--task_type``, the
parallelism flags, ``--profile_dir``) are parsed and unused; the mode sets
the task type.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from univl_tpu_torch.cli import common
from univl_tpu_torch.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.serving.captioning import CaptionService
from univl_tpu_torch.serving.coalesce import CoalescingCaptionService
from univl_tpu_torch.serving.index import VideoRetrievalIndex


def add_serve_args(p):
    p.add_argument("--mode", type=str, default="retrieval",
                   choices=["retrieval", "caption", "both"])
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--index", type=str, default=None,
                   help="load a VideoRetrievalIndex .npz at startup")
    p.add_argument("--rerank_store_full", action="store_true",
                   help="keep full visual outputs for cross-encoder rerank (requires a "
                        "cross-encoder model: --stage_two or --train_sim_after_cross)")
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--serve_batch_size", type=int, default=16)
    p.add_argument("--coalesce_captions", action=argparse.BooleanOptionalAction, default=True,
                   help="merge concurrent /v1/caption requests into shared decode batches "
                        "(per-clip results unchanged); --no-coalesce_captions serves each "
                        "request as its own padded batch")
    return p


def _decode_videos(payload, video_dim: int):
    # both branches validate [T, video_dim] before returning, so a bad request
    # fails alone instead of failing a merged caption batch
    if "feature_paths" in payload:
        vids = [np.load(p).astype(np.float32) for p in payload["feature_paths"]]
    else:
        vids = [np.asarray(v, np.float32) for v in payload["videos"]]
    for v in vids:
        if v.ndim != 2 or v.shape[1] != video_dim:
            raise ValueError(f"video must be [T, {video_dim}], got {v.shape}")
    return vids


def _decode_transcripts(payload, n_videos: int):
    # validated here for the same reason as the videos
    txts = payload.get("transcripts")
    if txts is None:
        return None
    if not isinstance(txts, (list, tuple)):
        raise ValueError("transcripts must be a list of strings")
    if len(txts) != n_videos:
        raise ValueError(f"transcripts length {len(txts)} != videos length {n_videos}")
    for t in txts:
        if not isinstance(t, str):
            raise ValueError(f"transcripts entries must be strings, got {type(t).__name__}")
    return list(txts)


def build_services(args):
    """Load the model and its weights; return (index or None, caption service
    or None, cfg)."""
    device = common.resolve_device(args.device)
    logger = common.get_logger(args.output_dir)
    tokenizer = WordPieceTokenizer(args.vocab_file, do_lower_case=args.do_lower_case)
    want_caption = args.mode in ("caption", "both")
    if want_caption:
        if args.train_sim_after_cross:
            raise ValueError(f"--mode {args.mode}: the caption decoder is not built with "
                             f"--train_sim_after_cross")
        args.stage_two = True
    cfg = common.build_config(args, device, task_type="caption" if want_caption else "retrieval",
                              vocab_size=len(tokenizer))
    model = common.make_model(args, cfg, device, logger).eval()
    index = caption = None
    if args.mode in ("retrieval", "both"):
        kw = dict(batch_size=args.serve_batch_size)
        if args.index:
            index = VideoRetrievalIndex.load(args.index, model, tokenizer, device, **kw)
        else:
            index = VideoRetrievalIndex(model, tokenizer, device,
                                        store_full=args.rerank_store_full, **kw)
    if want_caption:
        caption = CaptionService(model, tokenizer, device, beam_size=args.beam_size,
                                 batch_size=args.serve_batch_size,
                                 fused_decode=args.fused_decode, fused_vocab=args.fused_vocab,
                                 fused_cls=args.fused_cls, decode_unroll=args.decode_unroll)
    return index, caption, cfg


class Server(ThreadingHTTPServer):
    """The HTTP server; ``server_close`` also stops the caption coalescer."""

    index = None
    caption_service = None
    caption_coalescer = None

    def server_close(self):
        super().server_close()
        if self.caption_coalescer is not None:
            self.caption_coalescer.close()


def make_server(args) -> Server:
    index, caption, cfg = build_services(args)
    lock = threading.Lock()  # one request on the device at a time
    coalescer = None
    if caption is not None and args.coalesce_captions:
        # the coalescer's dispatcher takes `lock` around each merged decode;
        # handler threads queue and wait
        coalescer = CoalescingCaptionService(caption, device_lock=lock)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet; the logger owns stdout
            pass

        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "mode": args.mode,
                                  "indexed": len(index) if index is not None else None})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/v1/retrieval/add" and index is not None:
                    vids = _decode_videos(payload, cfg.video_dim)
                    with lock:
                        index.add(vids, ids=payload.get("ids"))
                    self._reply(200, {"indexed": len(index)})
                elif self.path == "/v1/retrieval/search" and index is not None:
                    with lock:
                        res = index.search(
                            payload["queries"],
                            top_k=int(payload.get("top_k", 10)),
                            rerank=int(payload.get("rerank", 0)),
                        )
                    self._reply(200, {"results": [
                        [{"id": i, "score": s} for i, s in r] for r in res
                    ]})
                elif self.path == "/v1/retrieval/save" and index is not None:
                    with lock:
                        index.save(payload["path"])
                    self._reply(200, {"path": payload["path"]})
                elif self.path == "/v1/caption" and caption is not None:
                    vids = _decode_videos(payload, cfg.video_dim)
                    txts = _decode_transcripts(payload, len(vids))
                    if coalescer is not None:
                        caps = coalescer.caption(vids, transcripts=txts)
                    else:
                        with lock:
                            caps = caption.caption(vids, transcripts=txts)
                    self._reply(200, {"captions": caps})
                else:
                    self._reply(404, {"error": f"no handler for {self.path} "
                                               f"in mode={args.mode}"})
            except Exception as e:  # surface errors as JSON, keep serving
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    server = Server((args.host, args.port), Handler)
    server.index = index
    server.caption_service = caption
    server.caption_coalescer = coalescer
    return server


def build_parser():
    parser = add_serve_args(common.add_fused_ffn_arg(common.base_parser("UniVL Serve (PyTorch)")))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the hand-written kernels) or cpu "
                             "(their plain PyTorch versions)")
    return parser


def main(argv=None, serve_forever: bool = True) -> Server:
    parser = build_parser()
    args = parser.parse_args(argv)
    logger = common.get_logger(args.output_dir)
    if not args.vocab_file:
        parser.error("--vocab_file required")
    server = make_server(args)
    logger.info("serving mode=%s on http://%s:%d (device %s)", args.mode,
                *server.server_address, args.device)
    if serve_forever:
        try:
            server.serve_forever()
        finally:
            server.server_close()
    return server


if __name__ == "__main__":
    main()
