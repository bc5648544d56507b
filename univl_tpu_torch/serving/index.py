"""Text -> video retrieval index for serving, in PyTorch.

Ports ``univl_tpu/serving/index.py:VideoRetrievalIndex``. Two-stage search:

  1. dense stage: mean-pooled, L2-normalised tower embeddings, one matrix
     product per query batch (the FT-Joint similarity);
  2. optional rerank: the cross encoder and the similarity head rescore each
     query's top-``rerank`` shortlist (the FT-Align similarity), in tiles of
     8 queries.

Batches are padded to fixed sizes on the host, as in the JAX index, and the
index is kept on the host in the same ``.npz`` format, so an index saved by
either package loads in the other. The dense stage runs on the host, as in
JAX.

The device work is three functions, JAX's three jitted ones: the visual
tower and its pooling (an add batch), the text tower and its pooling (a
query batch), and the cross encoder over a rerank tile. On a CUDA model each
runs as a CUDA graph (``graph``, default on a CUDA model): one graph per
input shape, captured at the shape's first call after that call ran
eagerly, then every later call copies its inputs into the graph's static
inputs (host arrays through pinned buffers) and replays it. A rerank tile's
text rows stay on the device from the text encode, on both routes.

``mesh`` (a ``parallel/mesh.py`` group of d ranks, each with the model on
its device: JAX's 1-D dp mesh) fans each encode batch out: rank r encodes
its r-th share of the padded batch's rows (its graphs at ``batch_size / d``
rows) and the rows are gathered, so every rank holds the whole store. The
dense stage and the rerank run on every rank, unsharded, as in JAX.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from univl_tpu_torch.data.batching import pad_rows
from univl_tpu_torch.data.text_encoding import encode_text, pad_video
from univl_tpu_torch.models.univl import UniVL
from univl_tpu_torch.parallel import comm
from univl_tpu_torch.utils.graphs import GraphCapture

RERANK_TILE = 8  # queries per cross-encoder call


def _normalize(pooled: torch.Tensor) -> torch.Tensor:
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _top(mat: np.ndarray, k: int) -> np.ndarray:
    # argpartition + a sort of the k winners: O(N) per query, not O(N log N)
    k = min(k, mat.shape[1])
    part = np.argpartition(-mat, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(mat, part, axis=1)
    inner = np.argsort(-vals, axis=1)
    return np.take_along_axis(part, inner, axis=1)


class _Graph:
    """One function's graph at one set of input shapes: its static inputs,
    the pinned host buffers that host arrays reach them through, and the
    outputs that a replay writes."""

    def __init__(self, args, device):
        host = [torch.from_numpy(a) if isinstance(a, np.ndarray) else None for a in args]
        self.inputs = [torch.empty(a.shape, dtype=(a if h is None else h).dtype, device=device)
                       for a, h in zip(args, host)]
        self.staging = [None if h is None else torch.empty_like(h, pin_memory=True)
                        for h in host]
        self.copied = torch.cuda.Event()  # the last copies out of the staging buffers
        self.graph = self.outputs = None

    def load(self, args) -> None:
        self.copied.synchronize()  # the staging buffers are free again
        for x, a, host in zip(self.inputs, args, self.staging):
            if host is None:
                x.copy_(a)
            else:
                # numpy's copy, one thread: torch's would start an OpenMP team in
                # every new thread, and the server serves each request on one
                np.copyto(host.numpy(), a)
                x.copy_(host, non_blocking=True)
        self.copied.record()


class VideoRetrievalIndex:
    def __init__(
        self,
        model: UniVL,
        tokenizer,
        device,
        max_words: Optional[int] = None,
        max_frames: Optional[int] = None,
        batch_size: int = 64,
        store_full: bool = False,
        graph: Optional[bool] = None,
        mesh=None,
    ):
        """``model`` must already be on ``device``. ``store_full=True`` keeps
        the full [N, F, H] visual outputs so ``search(..., rerank=M)`` can
        cross-encode the shortlist; it needs the cross tower. ``graph``:
        CUDA graphs (the default on a CUDA device; False is the eager route,
        the CPU's). ``mesh``: the ranks an encode batch fans out over, which
        must divide ``batch_size``."""
        cfg = model.cfg
        if store_full and not model.has_cross:
            raise ValueError("rerank (store_full) needs the cross encoder: build the model "
                             "with stage_two or train_sim_after_cross")
        comm.check_batch(batch_size, mesh)
        self.device = torch.device(device)
        graph = self.device.type == "cuda" if graph is None else bool(graph)
        if graph and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs run on a CUDA device, not {self.device}")
        self.model = model
        self.tokenizer = tokenizer
        self.max_words = max_words or cfg.max_words
        self.max_frames = max_frames or cfg.max_frames
        self.batch_size = batch_size
        self.store_full = store_full
        self.graph = graph
        self.mesh = mesh
        self.video_dim = cfg.video_dim
        hidden = cfg.bert.hidden_size
        self.ids: List[str] = []
        self.video_emb = np.zeros((0, hidden), np.float32)
        self.vis_full = np.zeros((0, self.max_frames, hidden), np.float32) if store_full else None
        self.vm_full = np.zeros((0, self.max_frames), np.int32) if store_full else None
        self.graphs: Dict[tuple, _Graph] = {}  # (function, input shapes) -> its graph
        self.capturer = GraphCapture()  # the graphs' pool, stream and capture count
        self.replays = collections.Counter()  # by function
        self._params = list(model.parameters())
        self.addresses = tuple(p.data_ptr() for p in self._params)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def check_weights(self) -> bool:
        """Drop the graphs where a parameter's storage moved since they were
        captured (they read the old one); returns whether it did."""
        addresses = tuple(p.data_ptr() for p in self._params)
        if addresses == self.addresses:
            return False
        self.graphs.clear()
        self.capturer.reset()
        self.addresses = addresses
        return True

    def _call(self, name: str, fn, *args):
        """``fn`` on ``args`` (host arrays or device tensors). Without graphs,
        eagerly. With them, the args go into the static inputs of the graph
        of their shapes, which replays; at the shapes' first call ``fn``
        runs eagerly (its outputs returned), then the capture. A replay's
        outputs are the graph's: the next replay overwrites them."""
        if not self.graph:
            return fn(*(self._tensor(a) if isinstance(a, np.ndarray) else a for a in args))
        key = (name, *((tuple(a.shape), str(a.dtype)) for a in args))
        entry = self.graphs.get(key)
        if entry is not None:
            entry.load(args)
            entry.graph.replay()
            self.replays[name] += 1
            return entry.outputs
        entry = _Graph(args, self.device)
        entry.load(args)
        runs = []
        entry.graph = self.capturer.capture(lambda: runs.append(fn(*entry.inputs)))
        entry.outputs = runs[-1]
        self.graphs[key] = entry
        return runs[0]

    def _encode(self, name: str, fn, *batch: np.ndarray):
        """An encode batch's outputs for all its rows: with a mesh, the rank
        encodes its share and the shares are gathered."""
        if self.mesh is None:
            return self._call(name, fn, *batch)
        out = self._call(name, fn, *(comm.local_rows(a, self.mesh) for a in batch))
        return tuple(comm.gather_rows(t, self.mesh) for t in out)

    def _video_fn(self, video, video_mask):
        vis = self.model.encode_video(video, video_mask)
        vm = video_mask.float()[:, :, None]
        pooled = (vis.float() * vm).sum(dim=1) / vm.sum(dim=1).clamp_min(1.0)
        return vis, _normalize(pooled)

    def _text_fn(self, input_ids, token_type_ids, attention_mask):
        seq = self.model.encode_text(input_ids, token_type_ids, attention_mask)
        am = attention_mask.float()[:, :, None].clone()
        am[:, 0, :] = 0.0  # leave out CLS
        pooled = (seq.float() * am).sum(dim=1) / am.sum(dim=1).clamp_min(1.0)
        return seq, _normalize(pooled)

    def _rerank_fn(self, seq, vis, am, vm):
        # [Q, L, H] texts x [Q, C, F, H] candidate videos -> [Q, C]
        Q, C = vis.shape[0], vis.shape[1]

        def each(x):  # row q C times over, as np.repeat lays the pairs out
            return x[:, None].expand(Q, C, *x.shape[1:]).flatten(0, 1)

        return self.model.cross_similarity_pairs(
            each(seq), vis.flatten(0, 1), each(am), vm.flatten(0, 1)).view(Q, C)

    # ------------------------------------------------------------ #
    @torch.inference_mode()
    def add(self, videos: Sequence[np.ndarray], ids: Optional[Sequence[str]] = None) -> None:
        """Index raw S3D feature clips: [T_i, video_dim] arrays, ragged, cut
        or padded to max_frames."""
        if ids is None:
            ids = [str(len(self.ids) + i) for i in range(len(videos))]
        if len(ids) != len(videos):
            raise ValueError(f"{len(ids)} ids for {len(videos)} videos")
        self.check_weights()
        feats = np.zeros((len(videos), self.max_frames, self.video_dim), np.float32)
        masks = np.zeros((len(videos), self.max_frames), np.int32)
        for i, v in enumerate(videos):
            feats[i], masks[i], _ = pad_video(
                np.asarray(v, np.float32), self.max_frames, self.video_dim)
        embs, fulls, vms = [], [], []
        B = self.batch_size
        for i0 in range(0, len(videos), B):
            mb = pad_rows(masks[i0: i0 + B], B)
            vis, pooled = self._encode("video", self._video_fn, pad_rows(feats[i0: i0 + B], B),
                                       mb)
            n = min(B, len(videos) - i0)
            embs.append(_host(pooled[:n]))
            if self.store_full:
                fulls.append(_host(vis[:n]))
                vms.append(mb[:n])
        self.ids.extend(ids)
        self.video_emb = np.concatenate([self.video_emb] + embs)
        if self.store_full:
            self.vis_full = np.concatenate([self.vis_full] + fulls)
            self.vm_full = np.concatenate([self.vm_full] + vms)

    def __len__(self) -> int:
        return len(self.ids)

    # ------------------------------------------------------------ #
    @torch.inference_mode()
    def search(self, queries: Sequence[str], top_k: int = 10,
               rerank: int = 0) -> List[List[Tuple[str, float]]]:
        """Per query, the top_k (video_id, score) pairs. ``rerank=M`` (needs
        store_full) rescores the dense top-M with the cross encoder; the
        scores are then the FT-Align head's."""
        if rerank:
            if not self.store_full:
                raise ValueError("rerank requires store_full=True at build")
            if rerank < top_k:
                raise ValueError("rerank shortlist must cover top_k")
        self.check_weights()
        enc = [encode_text(q, self.tokenizer, self.max_words) for q in queries]
        Q, B = len(queries), self.batch_size
        keys = ("input_ids", "token_type_ids", "attention_mask")
        arrs = {k: np.stack([e[k] for e in enc]).astype(np.int32) for k in keys}
        seqs, pooled = [], []
        for i0 in range(0, Q, B):
            chunk = [pad_rows(arrs[k][i0: i0 + B], B) for k in keys]
            seq, p = self._encode("text", self._text_fn, *chunk)
            n = min(B, Q - i0)
            if rerank:  # on the device until the rerank; a replay overwrites seq
                seqs.append(seq[:n].clone())
            pooled.append(_host(p[:n]))
        sim = np.concatenate(pooled) @ self.video_emb.T  # [Q, N]

        if not rerank:
            order = _top(sim, top_k)
            return [[(self.ids[j], float(sim[q, j])) for j in order[q]] for q in range(Q)]

        shortlist = _top(sim, min(rerank, len(self.ids)))  # [Q, M]
        T = RERANK_TILE
        rows = -(-Q // T) * T  # every tile full
        seqs = torch.cat(seqs)
        seqs = F.pad(seqs, [0, 0, 0, 0, 0, rows - Q])
        am = pad_rows(arrs["attention_mask"], rows)
        out: List[List[Tuple[str, float]]] = []
        for q0 in range(0, Q, T):
            qn = min(q0 + T, Q) - q0
            cand = shortlist[q0: q0 + qn]
            scores = self._call("rerank", self._rerank_fn, seqs[q0: q0 + T],
                                pad_rows(self.vis_full[cand], T), am[q0: q0 + T],
                                pad_rows(self.vm_full[cand], T))
            scores = scores[:qn].cpu().numpy()
            for qi in range(qn):
                order = np.argsort(-scores[qi])[:top_k]
                out.append([(self.ids[cand[qi, j]], float(scores[qi, j])) for j in order])
        return out

    # ------------------------------------------------------------ #
    def save(self, path: str) -> None:
        data = dict(
            ids=np.asarray(self.ids),  # fixed-width unicode, no pickle
            video_emb=self.video_emb,
            max_words=self.max_words,
            max_frames=self.max_frames,
            store_full=self.store_full,
        )
        if self.store_full:
            data.update(vis_full=self.vis_full, vm_full=self.vm_full)
        np.savez_compressed(path, **data)

    @classmethod
    def load(cls, path: str, model: UniVL, tokenizer, device, **kw) -> "VideoRetrievalIndex":
        # np.savez_compressed appends '.npz' to a suffix-less path; np.load does not
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            idx = cls(model, tokenizer, device, max_words=int(z["max_words"]),
                      max_frames=int(z["max_frames"]), store_full=bool(z["store_full"]), **kw)
            idx.ids = [str(s) for s in z["ids"]]
            idx.video_emb = z["video_emb"]
            if idx.store_full:
                idx.vis_full = z["vis_full"]
                idx.vm_full = z["vm_full"]
        return idx
