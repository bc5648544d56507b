"""HTTP retrieval server for the PyTorch port.

Ports the retrieval mode of ``univl_tpu/cli/serve.py``: the same flags,
endpoints and JSON shapes, plus ``--device``. Device work is serialised
behind one lock.

    python -m univl_tpu_torch.cli.serve --device cuda --mode retrieval \\
        --train_sim_after_cross --rerank_store_full \\
        --vocab_file vocab.txt --output_dir out \\
        [--init_model univl.pretrained.bin] [--index corpus_index.npz] --port 8080

Endpoints:
  GET  /healthz                  -> {"status": "ok", "mode", "indexed"}
  POST /v1/retrieval/add         {"videos": [[[f..]..]..] | "feature_paths":
                                  [".npy"...], "ids": [...]}
  POST /v1/retrieval/search      {"queries": [...], "top_k": 5, "rerank": 0}
  POST /v1/retrieval/save        {"path": "index.npz"}

``--mode caption`` and ``--mode both`` are not ported yet and raise.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from univl_tpu.cli.common import base_parser, get_logger
from univl_tpu.cli.serve import _decode_videos, add_serve_args
from univl_tpu.data.tokenization import WordPieceTokenizer
from univl_tpu_torch.cli import common
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.serving.index import VideoRetrievalIndex


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return device


def build_services(args):
    """Load the model and its weights; return (index, cfg)."""
    if args.mode != "retrieval":
        raise NotImplementedError(
            f"--mode {args.mode}: captioning is not ported to PyTorch yet; use --mode retrieval")
    device = _device(args.device)
    logger = get_logger(args.output_dir)
    tokenizer = WordPieceTokenizer(args.vocab_file, do_lower_case=args.do_lower_case)
    cfg = common.build_config(args, device, vocab_size=len(tokenizer))
    model = UniVL(cfg, device=device)
    common.load_init_params(args, model, logger)
    model.eval()
    kw = dict(batch_size=args.serve_batch_size)
    if args.index:
        index = VideoRetrievalIndex.load(args.index, model, tokenizer, device, **kw)
    else:
        index = VideoRetrievalIndex(model, tokenizer, device, store_full=args.rerank_store_full,
                                    **kw)
    return index, cfg


def make_server(args) -> ThreadingHTTPServer:
    index, cfg = build_services(args)
    lock = threading.Lock()  # one request on the device at a time

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
                self._reply(200, {"status": "ok", "mode": args.mode, "indexed": len(index)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/v1/retrieval/add":
                    vids = _decode_videos(payload, cfg.video_dim)
                    with lock:
                        index.add(vids, ids=payload.get("ids"))
                    self._reply(200, {"indexed": len(index)})
                elif self.path == "/v1/retrieval/search":
                    with lock:
                        res = index.search(
                            payload["queries"],
                            top_k=int(payload.get("top_k", 10)),
                            rerank=int(payload.get("rerank", 0)),
                        )
                    self._reply(200, {"results": [
                        [{"id": i, "score": s} for i, s in r] for r in res
                    ]})
                elif self.path == "/v1/retrieval/save":
                    with lock:
                        index.save(payload["path"])
                    self._reply(200, {"path": payload["path"]})
                else:
                    self._reply(404, {"error": f"no handler for {self.path} "
                                               f"in mode={args.mode}"})
            except Exception as e:  # surface errors as JSON, keep serving
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((args.host, args.port), Handler)


def main(argv=None, serve_forever: bool = True) -> ThreadingHTTPServer:
    parser = add_serve_args(base_parser("UniVL-TPU Serve (PyTorch)"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the hand-written kernels) or cpu "
                             "(their plain PyTorch versions)")
    args = parser.parse_args(argv)
    logger = get_logger(args.output_dir)
    if not args.vocab_file:
        parser.error("--vocab_file required")
    server = make_server(args)
    logger.info("serving mode=%s on http://%s:%d (device %s)", args.mode,
                *server.server_address, args.device)
    if serve_forever:
        server.serve_forever()
    return server


if __name__ == "__main__":
    main()
