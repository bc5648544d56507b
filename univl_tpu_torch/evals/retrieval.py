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

``mesh`` (a ``parallel/mesh.py`` group of d ranks, each with the model on
its card) is the JAX package's data-parallel fan-out, the reference's
thread-per-GPU ``parallel_apply`` (util.py:21-60): every rank reads every
batch, and each encode batch, padded to a multiple of d, has rank r encode
its r-th share of the rows; the joint product splits the text rows over the
ranks; each cross stripe of ``cross_text_block * d`` texts has rank r score
its ``cross_text_block`` rows against the whole corpus, which every rank
holds. The rows are gathered (``comm.gather_rows``) so every rank returns
the full matrix from the same entry points. Without a mesh the rank is the
only one and every gather the identity.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from univl_tpu_torch.data.batching import pad_rows
from univl_tpu_torch.evals.metrics import compute_retrieval_metrics
from univl_tpu_torch.parallel import comm

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
    the host, so each is synchronized with the device), and ``similarity``
    its T x V matrix. ``mesh``: the ranks to fan the work out over (see the
    module's docstring), or None."""

    def __init__(self, model, batch_size: int = 64, cross_text_block: int = 8,
                 cross_video_block: int = 64, mesh=None):
        self.model = model
        self.batch_size = batch_size
        self.tb = cross_text_block
        self.vb = cross_video_block
        self.device = next(model.parameters()).device
        self.seconds: Dict[str, float] = {}
        self.similarity: Optional[np.ndarray] = None
        self.mesh = mesh
        self._n_dev, self._rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t``, in rank order."""
        return t if self.mesh is None else comm.gather_rows(t, self.mesh)

    def _gather_stripes(self, stripes: list) -> torch.Tensor:
        """The ranks' stripes (rank r holds rows [r*tb, (r+1)*tb) of each
        block of ``tb * d``) gathered into the blocks' rows in order."""
        local = torch.cat(stripes)
        d, tb = self._n_dev, stripes[0].shape[0]
        full = self._gather(local).view(d, len(stripes), tb, *local.shape[1:])
        return full.transpose(0, 1).reshape(d * local.shape[0], *local.shape[1:])

    def _encoded_batches(self, batches: Iterator[Dict[str, np.ndarray]]):
        """The shared encode loop: pad each batch, encode, mean-pool (and
        L2-normalise without MIL). Yields ``(batch on the device, n, seq,
        vis, text_emb, video_emb)`` with ``n`` the unpadded row count; only
        where the results land differs between ``encode_dataset`` and
        ``encode_dataset_device``."""
        model, d, r = self.model, self._n_dev, self._rank
        share = -(-self.batch_size // d)  # the batch padded to a multiple of the ranks
        for batch in batches:
            batch, n = _pad_batch({k: batch[k] for k in KEYS}, share * d)
            b = {k: self._to_device(v[r * share:(r + 1) * share]) for k, v in batch.items()}
            seq, vis = model.encode(b["input_ids"], b["token_type_ids"], b["attention_mask"],
                                    b["video"], b["video_mask"])
            t, v = model.mean_pool(seq, vis, b["attention_mask"], b["video_mask"])
            if not model.cfg.use_mil:
                t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
                v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
            if self.mesh is not None:
                seq, vis, t, v = (self._gather(x) for x in (seq, vis, t, v))
                b = {k: self._to_device(batch[k]) for k in ("attention_mask", "video_mask")}
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

    @torch.inference_mode()
    def joint_sim_matrix(self, enc) -> np.ndarray:
        """T x V similarity of the pooled embeddings; with a mesh on the
        cards, each rank's share of the text rows against every video."""
        if self.mesh is None:
            return enc["text_emb"] @ enc["video_emb"].T
        n, d, r = enc["text_emb"].shape[0], self._n_dev, self._rank
        share = -(-n // d)
        text = self._to_device(pad_rows(enc["text_emb"], share * d)[r * share:(r + 1) * share])
        sim = text @ self._to_device(enc["video_emb"]).T
        return self._gather(sim).cpu().numpy()[:n]

    @torch.inference_mode()
    def cross_sim_matrix_device(self, enc) -> np.ndarray:
        """FT-Align rescoring with the encoder outputs on the device: for each
        text block of ``tb`` rows, every video block of ``vb`` clips is scored
        into a [tb, N] row stripe on the device; the stripes come back once,
        at the end. With a mesh a stripe is ``tb * d`` texts, rank r's
        ``tb`` of them scored on its card."""
        tb, vb, model = self.tb, self.vb, self.model
        span = tb * self._n_dev
        n = int(enc["seq"].shape[0])
        n_pad, nv_pad = -(-n // span) * span, -(-n // vb) * vb
        seq, am = _pad_rows_device(enc["seq"], n_pad), _pad_rows_device(enc["am"], n_pad)
        vis, vm = _pad_rows_device(enc["vis"], nv_pad), _pad_rows_device(enc["vm"], nv_pad)
        rows = []
        for i0 in range(self._rank * tb, n_pad, span):
            stripe = torch.empty(tb, nv_pad, dtype=torch.float32, device=self.device)
            for j0 in range(0, nv_pad, vb):
                stripe[:, j0:j0 + vb] = model.cross_similarity(
                    seq[i0:i0 + tb], vis[j0:j0 + vb], am[i0:i0 + tb], vm[j0:j0 + vb])
            rows.append(stripe)
        return self._gather_stripes(rows).cpu().numpy()[:n, :n]

    @torch.inference_mode()
    def cross_sim_matrix(self, enc) -> np.ndarray:
        """FT-Align rescoring over host-side outputs: each (text block, video
        block) tile is padded to ``tb`` x ``vb``, moved to the device, scored
        and brought back. With a mesh a text block is ``tb * d`` rows, rank r's
        ``tb`` of them scored on its card."""
        seq, vis, am, vm = enc["seq"], enc["vis"], enc["am"], enc["vm"]
        tb, vb, model = self.tb, self.vb, self.model
        dt = model.compute_dtype
        span, r = tb * self._n_dev, self._rank
        n = seq.shape[0]
        stripes = []
        for i0 in range(0, n, span):
            i1 = min(i0 + span, n)
            seq_i = self._to_device(pad_rows(seq[i0:i1], span)[r * tb:(r + 1) * tb]).to(dt)
            am_i = self._to_device(pad_rows(am[i0:i1], span)[r * tb:(r + 1) * tb])
            stripe = np.zeros((tb, n), np.float32)
            for j0 in range(0, n, vb):
                j1 = min(j0 + vb, n)
                vis_j = self._to_device(pad_rows(vis[j0:j1], vb)).to(dt)
                vm_j = self._to_device(pad_rows(vm[j0:j1], vb))
                block = model.cross_similarity(seq_i, vis_j, am_i, vm_j)
                stripe[:, j0:j1] = block.cpu().numpy()[:, : j1 - j0]
            stripes.append(self._to_device(stripe))
        return self._gather_stripes(stripes).cpu().numpy()[:n]

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
            self.similarity = sim
        finally:
            self.model.train(was_training)
        metrics: Dict[str, object] = dict(compute_retrieval_metrics(sim))
        metrics["mode"] = mode
        return metrics
