"""Text -> video retrieval index for serving, in PyTorch.

Ports ``univl_tpu/serving/index.py:VideoRetrievalIndex``. Two-stage search:

  1. dense stage: mean-pooled, L2-normalised tower embeddings, one matrix
     product per query batch (the FT-Joint similarity);
  2. optional rerank: the cross encoder and the similarity head rescore each
     query's top-``rerank`` shortlist (the FT-Align similarity), in tiles of
     8 queries.

Batches are padded to fixed sizes on the host, as in the JAX index, and the
index is kept on the host in the same ``.npz`` format, so an index saved by
either package loads in the other.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from univl_tpu_torch.data.text_encoding import encode_text, pad_rows, pad_video
from univl_tpu_torch.models.univl import UniVL

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
    ):
        """``model`` must already be on ``device``. ``store_full=True`` keeps
        the full [N, F, H] visual outputs so ``search(..., rerank=M)`` can
        cross-encode the shortlist; it needs the cross tower."""
        cfg = model.cfg
        if store_full and not model.has_cross:
            raise ValueError("rerank (store_full) needs the cross encoder: build the model "
                             "with stage_two or train_sim_after_cross")
        self.model = model
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.max_words = max_words or cfg.max_words
        self.max_frames = max_frames or cfg.max_frames
        self.batch_size = batch_size
        self.store_full = store_full
        self.video_dim = cfg.video_dim
        hidden = cfg.bert.hidden_size
        self.ids: List[str] = []
        self.video_emb = np.zeros((0, hidden), np.float32)
        self.vis_full = np.zeros((0, self.max_frames, hidden), np.float32) if store_full else None
        self.vm_full = np.zeros((0, self.max_frames), np.int32) if store_full else None

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.inference_mode()
    def _encode_video(self, video: np.ndarray, video_mask: np.ndarray):
        vm_t = self._tensor(video_mask)
        vis = self.model.encode_video(self._tensor(video), vm_t)
        vm = vm_t.float()[:, :, None]
        pooled = (vis.float() * vm).sum(dim=1) / vm.sum(dim=1).clamp_min(1.0)
        return vis, _normalize(pooled)

    @torch.inference_mode()
    def _encode_text(self, input_ids, token_type_ids, attention_mask):
        am_t = self._tensor(attention_mask)
        seq = self.model.encode_text(self._tensor(input_ids), self._tensor(token_type_ids), am_t)
        am = am_t.float()[:, :, None].clone()
        am[:, 0, :] = 0.0  # leave out CLS
        pooled = (seq.float() * am).sum(dim=1) / am.sum(dim=1).clamp_min(1.0)
        return seq, _normalize(pooled)

    @torch.inference_mode()
    def _rerank(self, seq, vis, am, vm) -> np.ndarray:
        # [Q, L, H] texts x [Q, C, F, H] candidate videos -> [Q, C]
        Q, C = vis.shape[0], vis.shape[1]
        scores = self.model.cross_similarity_pairs(
            self._tensor(np.repeat(seq, C, axis=0)),
            self._tensor(vis.reshape(Q * C, *vis.shape[2:])),
            self._tensor(np.repeat(am, C, axis=0)),
            self._tensor(vm.reshape(Q * C, vm.shape[-1])),
        )
        return scores.reshape(Q, C).cpu().numpy()

    # ------------------------------------------------------------ #
    def add(self, videos: Sequence[np.ndarray], ids: Optional[Sequence[str]] = None) -> None:
        """Index raw S3D feature clips: [T_i, video_dim] arrays, ragged, cut
        or padded to max_frames."""
        if ids is None:
            ids = [str(len(self.ids) + i) for i in range(len(videos))]
        if len(ids) != len(videos):
            raise ValueError(f"{len(ids)} ids for {len(videos)} videos")
        feats = np.zeros((len(videos), self.max_frames, self.video_dim), np.float32)
        masks = np.zeros((len(videos), self.max_frames), np.int32)
        for i, v in enumerate(videos):
            feats[i], masks[i], _ = pad_video(
                np.asarray(v, np.float32), self.max_frames, self.video_dim)
        embs, fulls, vms = [], [], []
        B = self.batch_size
        for i0 in range(0, len(videos), B):
            mb = pad_rows(masks[i0: i0 + B], B)
            vis, pooled = self._encode_video(pad_rows(feats[i0: i0 + B], B), mb)
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
        enc = [encode_text(q, self.tokenizer, self.max_words) for q in queries]
        Q, B = len(queries), self.batch_size
        keys = ("input_ids", "token_type_ids", "attention_mask")
        arrs = {k: np.stack([e[k] for e in enc]).astype(np.int32) for k in keys}
        seqs, pooled = [], []
        for i0 in range(0, Q, B):
            chunk = [pad_rows(arrs[k][i0: i0 + B], B) for k in keys]
            seq, p = self._encode_text(*chunk)
            n = min(B, Q - i0)
            if rerank:
                seqs.append(_host(seq[:n]))
            pooled.append(_host(p[:n]))
        sim = np.concatenate(pooled) @ self.video_emb.T  # [Q, N]

        if not rerank:
            order = _top(sim, top_k)
            return [[(self.ids[j], float(sim[q, j])) for j in order[q]] for q in range(Q)]

        shortlist = _top(sim, min(rerank, len(self.ids)))  # [Q, M]
        seqs = np.concatenate(seqs)
        am = arrs["attention_mask"]
        out: List[List[Tuple[str, float]]] = []
        T = RERANK_TILE
        for q0 in range(0, Q, T):
            qn = min(q0 + T, Q) - q0
            cand = shortlist[q0: q0 + qn]
            scores = self._rerank(
                pad_rows(seqs[q0: q0 + qn], T), pad_rows(self.vis_full[cand], T),
                pad_rows(am[q0: q0 + qn], T), pad_rows(self.vm_full[cand], T),
            )[:qn]
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
