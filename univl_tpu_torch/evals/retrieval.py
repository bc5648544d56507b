"""Retrieval evaluation, the port's ``univl_tpu/evals/retrieval.py`` on one
device (the reference's main_task_retrieval.py:367-450).

  1. encode every test clip once, in batches padded to a fixed size, in eval
     mode (the eval-attention kernel in every encoder layer on a CUDA device);
  2. the full T x V similarity matrix:
     - joint mode: the mean-pooled, L2-normalised embeddings, one product;
     - cross (FT-Align) mode: the cross encoder over (text block x video
       block) tiles of ``cross_text_block`` x ``cross_video_block`` pairs;
  3. R@K, MedianR and MeanR from the diagonal's rank (``evals/metrics.py``).

Cross mode takes the device-resident path: the encoder outputs stay on the
device, and each text block sweeps every video block there, so only the
[tb, N] score rows come back. ``cross_sim_matrix`` is the host-tile path
(outputs on the host, each tile moved to the device), kept as its check.
The JAX package's mesh (a data-parallel fan-out over devices) waits for the
port's multi-device slice.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from univl_tpu_torch.data.batching import pad_rows
from univl_tpu_torch.evals.metrics import compute_retrieval_metrics

KEYS = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")


def _pad_batch(batch: Dict[str, np.ndarray], size: int) -> Tuple[Dict[str, np.ndarray], int]:
    n = next(iter(batch.values())).shape[0]
    return {k: pad_rows(v, size) for k, v in batch.items()}, n


def _pad_rows_device(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[0] == size:
        return x
    return F.pad(x, [0, 0] * (x.dim() - 1) + [0, size - x.shape[0]])


class RetrievalEvaluator:
    """Evaluates ``model`` (a ``UniVL``, on its device) over batches of
    numpy arrays with the five encoder keys; ``batch_size`` is the padded
    encode batch. ``seconds`` holds the last ``evaluate``'s host-clock times
    of the encode pass and of the similarity matrix (each ends in a copy to
    the host, so each is synchronized with the device)."""

    def __init__(self, model, batch_size: int = 64, cross_text_block: int = 8,
                 cross_video_block: int = 64):
        self.model = model
        self.batch_size = batch_size
        self.tb = cross_text_block
        self.vb = cross_video_block
        self.device = next(model.parameters()).device
        self.seconds: Dict[str, float] = {}

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _encoded_batches(self, batches: Iterator[Dict[str, np.ndarray]]):
        """The shared encode loop: pad each batch, encode, mean-pool (and
        L2-normalise without MIL). Yields ``(batch on the device, n, seq,
        vis, text_emb, video_emb)`` with ``n`` the unpadded row count; only
        where the results land differs between ``encode_dataset`` and
        ``encode_dataset_device``."""
        model = self.model
        for batch in batches:
            batch, n = _pad_batch({k: batch[k] for k in KEYS}, self.batch_size)
            b = {k: self._to_device(v) for k, v in batch.items()}
            seq, vis = model.encode(b["input_ids"], b["token_type_ids"], b["attention_mask"],
                                    b["video"], b["video_mask"])
            t, v = model.mean_pool(seq, vis, b["attention_mask"], b["video_mask"])
            if not model.cfg.use_mil:
                t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
                v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
            yield b, n, seq, vis, t, v

    @torch.inference_mode()
    def encode_dataset(self, batches, store_full: bool = True) -> Dict[str, np.ndarray]:
        """Encode every clip; host (numpy f32) outputs. ``store_full=False``
        keeps only the pooled embeddings, all the joint mode needs."""
        out = {k: [] for k in ("text_emb", "video_emb", "seq", "vis", "am", "vm")}
        for b, n, seq, vis, t, v in self._encoded_batches(batches):
            if store_full:
                out["seq"].append(seq[:n].float().cpu().numpy())
                out["vis"].append(vis[:n].float().cpu().numpy())
                out["am"].append(b["attention_mask"][:n].cpu().numpy())
                out["vm"].append(b["video_mask"][:n].cpu().numpy())
            out["text_emb"].append(t[:n].float().cpu().numpy())
            out["video_emb"].append(v[:n].float().cpu().numpy())
        return {k: np.concatenate(v) for k, v in out.items() if v}

    @torch.inference_mode()
    def encode_dataset_device(self, batches) -> Dict[str, object]:
        """``encode_dataset`` with ``store_full``, but the [N, L, H] encoder
        outputs and the masks stay on the device for the cross rescoring:
        the quadratic pass then moves no bytes off the device but the [N, N]
        scores."""
        out = {k: [] for k in ("seq", "vis", "am", "vm", "text_emb", "video_emb")}
        for b, n, seq, vis, t, v in self._encoded_batches(batches):
            out["seq"].append(seq[:n])
            out["vis"].append(vis[:n])
            out["am"].append(b["attention_mask"][:n])
            out["vm"].append(b["video_mask"][:n])
            out["text_emb"].append(t[:n].float().cpu().numpy())
            out["video_emb"].append(v[:n].float().cpu().numpy())
        return {k: (np.concatenate(v) if k.endswith("_emb") else torch.cat(v))
                for k, v in out.items()}

    def joint_sim_matrix(self, enc) -> np.ndarray:
        """T x V similarity of the pooled embeddings."""
        return enc["text_emb"] @ enc["video_emb"].T

    @torch.inference_mode()
    def cross_sim_matrix_device(self, enc) -> np.ndarray:
        """FT-Align rescoring with the encoder outputs on the device: for each
        text block of ``tb`` rows, every video block of ``vb`` clips is scored
        into a [tb, N] row stripe on the device; the stripes come back once,
        at the end."""
        tb, vb, model = self.tb, self.vb, self.model
        n = int(enc["seq"].shape[0])
        n_pad, nv_pad = -(-n // tb) * tb, -(-n // vb) * vb
        seq, am = _pad_rows_device(enc["seq"], n_pad), _pad_rows_device(enc["am"], n_pad)
        vis, vm = _pad_rows_device(enc["vis"], nv_pad), _pad_rows_device(enc["vm"], nv_pad)
        rows = []
        for i0 in range(0, n_pad, tb):
            stripe = torch.empty(tb, nv_pad, dtype=torch.float32, device=self.device)
            for j0 in range(0, nv_pad, vb):
                stripe[:, j0:j0 + vb] = model.cross_similarity(
                    seq[i0:i0 + tb], vis[j0:j0 + vb], am[i0:i0 + tb], vm[j0:j0 + vb])
            rows.append(stripe)
        return torch.cat(rows).cpu().numpy()[:n, :n]

    @torch.inference_mode()
    def cross_sim_matrix(self, enc) -> np.ndarray:
        """FT-Align rescoring over host-side outputs: each (text block, video
        block) tile is padded to ``tb`` x ``vb``, moved to the device, scored
        and brought back."""
        seq, vis, am, vm = enc["seq"], enc["vis"], enc["am"], enc["vm"]
        tb, vb, model = self.tb, self.vb, self.model
        dt = model.compute_dtype
        n = seq.shape[0]
        sim = np.zeros((n, n), np.float32)
        for i0 in range(0, n, tb):
            i1 = min(i0 + tb, n)
            seq_i = self._to_device(pad_rows(seq[i0:i1], tb)).to(dt)
            am_i = self._to_device(pad_rows(am[i0:i1], tb))
            for j0 in range(0, n, vb):
                j1 = min(j0 + vb, n)
                vis_j = self._to_device(pad_rows(vis[j0:j1], vb)).to(dt)
                vm_j = self._to_device(pad_rows(vm[j0:j1], vb))
                block = model.cross_similarity(seq_i, vis_j, am_i, vm_j)
                sim[i0:i1, j0:j1] = block.cpu().numpy()[: i1 - i0, : j1 - j0]
        return sim

    def evaluate(self, batches: Iterator[Dict[str, np.ndarray]],
                 mode: Optional[str] = None) -> Dict[str, object]:
        """mode: "joint" or "cross"; by default "cross" with
        ``train_sim_after_cross`` or ``stage_two``, else "joint". The model
        runs in eval mode (restored afterwards); cross mode always takes the
        device-resident path."""
        cfg = self.model.cfg
        if mode is None:
            mode = "cross" if (cfg.train_sim_after_cross or cfg.stage_two) else "joint"
        if mode not in ("joint", "cross"):
            raise ValueError(f"mode {mode}: choose joint or cross")
        was_training = self.model.training
        self.model.eval()
        try:
            t0 = time.perf_counter()
            if mode == "cross":
                enc = self.encode_dataset_device(batches)
                t1 = time.perf_counter()
                sim = self.cross_sim_matrix_device(enc)
            else:
                enc = self.encode_dataset(batches, store_full=False)
                t1 = time.perf_counter()
                sim = self.joint_sim_matrix(enc)
            self.seconds = {"encode_s": t1 - t0, "similarity_s": time.perf_counter() - t1}
        finally:
            self.model.train(was_training)
        metrics: Dict[str, object] = dict(compute_retrieval_metrics(sim))
        metrics["mode"] = mode
        return metrics
