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

On a CUDA model (``graph``, the default there; False is the eager route,
the CPU's) the device work is JAX's jitted functions as CUDA graphs
(``utils/graphs.py:GraphCalls``, one memory pool an evaluator): the encode
and pooling of a batch (JAX's ``encode_fn`` and ``pool_fn``), one graph a
padded batch shape fed from the host batch; the rescoring of a stripe
against every video block of the corpus (``stripe_fn``), one graph a
stripe shape, its text rows copied into the graph's inputs and the corpus
read in place from buffers the evaluator keeps for each corpus shape (each
``evaluate`` copies its corpus in, so the graphs of one evaluator serve
every epoch's eval); and the host-tile path's cross block
(``cross_block_fn``). A rank's local work is the graph, the gathers stay
outside it. A parameter whose storage moved drops the graphs.
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
from univl_tpu_torch.utils.graphs import GraphCalls

KEYS = ("input_ids", "token_type_ids", "attention_mask", "video", "video_mask")


def _pad_batch(batch: Dict[str, np.ndarray], size: int) -> Tuple[Dict[str, np.ndarray], int]:
    n = next(iter(batch.values())).shape[0]
    return {k: pad_rows(v, size) for k, v in batch.items()}, n


def _pad_rows_device(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[0] == size:
        return x
    return F.pad(x, [0, 0] * (x.dim() - 1) + [0, size - x.shape[0]])


class RetrievalEvaluator(GraphCalls):
    """Evaluates ``model`` (a ``UniVL``, on its device) over batches of
    numpy arrays with the five encoder keys; ``batch_size`` is the padded
    encode batch. ``seconds`` holds the last ``evaluate``'s host-clock times
    of the encode pass and of the similarity matrix (each ends in a copy to
    the host, so each is synchronized with the device), and ``similarity``
    its T x V matrix. ``mesh``: the ranks to fan the work out over (see the
    module's docstring), or None. ``graph``: CUDA graphs (the default on a
    CUDA model; True elsewhere raises), or False, the eager route."""

    def __init__(self, model, batch_size: int = 64, cross_text_block: int = 8,
                 cross_video_block: int = 64, mesh=None, graph: Optional[bool] = None):
        super().__init__(model.parameters(), next(model.parameters()).device, graph)
        self.model = model
        self.batch_size = batch_size
        self.tb = cross_text_block
        self.vb = cross_video_block
        self.seconds: Dict[str, float] = {}
        self.similarity: Optional[np.ndarray] = None
        self.mesh = mesh
        self._n_dev, self._rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
        self._corpus: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}  # the stripes' videos

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t``, in rank order."""
        return t if self.mesh is None else comm.gather_rows(t, self.mesh)

    def _gather_stripes(self, local: torch.Tensor) -> torch.Tensor:
        """The ranks' stripes (rank r holds rows [r*tb, (r+1)*tb) of each
        block of ``tb * d``; ``local`` its stripes, in order) gathered into
        the blocks' rows in order."""
        d, tb = self._n_dev, self.tb
        full = self._gather(local).view(d, -1, tb, *local.shape[1:])
        return full.transpose(0, 1).reshape(d * local.shape[0], *local.shape[1:])

    def _encode_fn(self, input_ids, token_type_ids, attention_mask, video, video_mask):
        """A padded batch's encoder outputs and pooled embeddings (JAX's
        ``encode_fn`` and ``pool_fn``): (seq, vis, text, video), the
        embeddings L2-normalised without MIL."""
        model = self.model
        seq, vis = model.encode(input_ids, token_type_ids, attention_mask, video, video_mask)
        t, v = model.mean_pool(seq, vis, attention_mask, video_mask)
        if not model.cfg.use_mil:
            t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
            v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
        return seq, vis, t, v

    def _stripe_fn(self, seq, am, vis, vm) -> torch.Tensor:
        """The cross scores of ``tb`` texts against every video block of the
        padded corpus (JAX's ``stripe_fn``): f32 [tb, N]."""
        stripe = torch.empty(seq.shape[0], vis.shape[0], dtype=torch.float32,
                             device=seq.device)
        for j0 in range(0, vis.shape[0], self.vb):
            stripe[:, j0:j0 + self.vb] = self.model.cross_similarity(
                seq, vis[j0:j0 + self.vb], am, vm[j0:j0 + self.vb])
        return stripe

    def _block_fn(self, seq, vis, am, vm) -> torch.Tensor:
        """The cross scores of a host tile (JAX's ``cross_block_fn``)."""
        dt = self.model.compute_dtype
        return self.model.cross_similarity(seq.to(dt), vis.to(dt), am, vm)

    def _encoded_batches(self, batches: Iterator[Dict[str, np.ndarray]]):
        """The shared encode loop: pad each batch, encode, mean-pool (and
        L2-normalise without MIL). Yields ``(the padded host batch, n, seq,
        vis, text_emb, video_emb)`` with ``n`` the unpadded row count; on
        the graph route the tensors are the graph's outputs, which the next
        batch overwrites. Only where the results land differs between
        ``encode_dataset`` and ``encode_dataset_device``."""
        d, r = self._n_dev, self._rank
        share = -(-self.batch_size // d)  # the batch padded to a multiple of the ranks
        for batch in batches:
            batch, n = _pad_batch({k: batch[k] for k in KEYS}, share * d)
            out = self._call("encode", self._encode_fn,
                             *(batch[k][r * share:(r + 1) * share] for k in KEYS))
            if self.mesh is not None:
                out = tuple(self._gather(x) for x in out)
            yield (batch, n, *out)

    @torch.inference_mode()
    def encode_dataset(self, batches, store_full: bool = True) -> Dict[str, np.ndarray]:
        """Encode every clip; host (numpy f32) outputs. ``store_full=False``
        keeps only the pooled embeddings, all the joint mode needs."""
        self.check_weights()
        out = {k: [] for k in ("text_emb", "video_emb", "seq", "vis", "am", "vm")}
        for b, n, seq, vis, t, v in self._encoded_batches(batches):
            if store_full:
                out["seq"].append(seq[:n].float().cpu().numpy())
                out["vis"].append(vis[:n].float().cpu().numpy())
                out["am"].append(b["attention_mask"][:n])
                out["vm"].append(b["video_mask"][:n])
            out["text_emb"].append(t[:n].float().cpu().numpy())
            out["video_emb"].append(v[:n].float().cpu().numpy())
        return {k: np.concatenate(v) for k, v in out.items() if v}

    @torch.inference_mode()
    def encode_dataset_device(self, batches) -> Dict[str, object]:
        """``encode_dataset`` with ``store_full``, but the [N, L, H] encoder
        outputs and the masks stay on the device for the cross rescoring:
        the quadratic pass then moves no bytes off the device but the [N, N]
        scores."""
        self.check_weights()
        out = {k: [] for k in ("seq", "vis", "am", "vm", "text_emb", "video_emb")}
        for b, n, seq, vis, t, v in self._encoded_batches(batches):
            out["seq"].append(seq[:n].clone())  # before the next replay overwrites it
            out["vis"].append(vis[:n].clone())
            out["am"].append(self._tensor(b["attention_mask"][:n]))
            out["vm"].append(self._tensor(b["video_mask"][:n]))
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
        text = self._tensor(pad_rows(enc["text_emb"], share * d)[r * share:(r + 1) * share])
        sim = text @ self._tensor(enc["video_emb"]).T
        return self._gather(sim).cpu().numpy()[:n]

    @torch.inference_mode()
    def cross_sim_matrix_device(self, enc) -> np.ndarray:
        """FT-Align rescoring with the encoder outputs on the device: for each
        text block of ``tb`` rows, every video block of ``vb`` clips is scored
        into a [tb, N] row stripe on the device; the stripes come back once,
        at the end. With a mesh a stripe is ``tb * d`` texts, rank r's
        ``tb`` of them scored on its card."""
        self.check_weights()
        tb, vb = self.tb, self.vb
        span = tb * self._n_dev
        n = int(enc["seq"].shape[0])
        n_pad, nv_pad = -(-n // span) * span, -(-n // vb) * vb
        seq, am = _pad_rows_device(enc["seq"], n_pad), _pad_rows_device(enc["am"], n_pad)
        vis, vm = _pad_rows_device(enc["vis"], nv_pad), _pad_rows_device(enc["vm"], nv_pad)
        if self.graph:
            vis, vm = self._resident(vis, vm)
        rows = range(self._rank * tb, n_pad, span)
        local = torch.empty(len(rows) * tb, nv_pad, dtype=torch.float32, device=self.device)
        for s, i0 in enumerate(rows):
            local[s * tb:(s + 1) * tb] = self._call(
                ("stripe", tuple(vis.shape), vis.dtype), lambda q, m: self._stripe_fn(
                    q, m, vis, vm), seq[i0:i0 + tb], am[i0:i0 + tb])
        return self._gather_stripes(local).cpu().numpy()[:n, :n]

    def _resident(self, vis: torch.Tensor, vm: torch.Tensor) -> tuple:
        """The corpus copied into the buffers kept for its shape, which the
        stripe graphs of that shape read in place."""
        key = (tuple(vis.shape), vis.dtype, tuple(vm.shape), vm.dtype)
        if key not in self._corpus:
            self._corpus[key] = (torch.empty_like(vis), torch.empty_like(vm))
        bufs = self._corpus[key]
        for buf, x in zip(bufs, (vis, vm)):
            buf.copy_(x)
        return bufs

    @torch.inference_mode()
    def cross_sim_matrix(self, enc) -> np.ndarray:
        """FT-Align rescoring over host-side outputs: each (text block, video
        block) tile is padded to ``tb`` x ``vb``, moved to the device, scored
        and brought back. With a mesh a text block is ``tb * d`` rows, rank r's
        ``tb`` of them scored on its card."""
        self.check_weights()
        seq, vis, am, vm = enc["seq"], enc["vis"], enc["am"], enc["vm"]
        tb, vb = self.tb, self.vb
        span, r = tb * self._n_dev, self._rank
        n = seq.shape[0]
        stripes = []
        for i0 in range(0, n, span):
            i1 = min(i0 + span, n)
            seq_i = pad_rows(seq[i0:i1], span)[r * tb:(r + 1) * tb]
            am_i = pad_rows(am[i0:i1], span)[r * tb:(r + 1) * tb]
            stripe = np.zeros((tb, n), np.float32)
            for j0 in range(0, n, vb):
                j1 = min(j0 + vb, n)
                block = self._call("block", self._block_fn, seq_i, pad_rows(vis[j0:j1], vb),
                                   am_i, pad_rows(vm[j0:j1], vb))
                stripe[:, j0:j1] = block.cpu().numpy()[:, : j1 - j0]
            stripes.append(stripe)
        return self._gather_stripes(self._tensor(np.concatenate(stripes))).cpu().numpy()[:n]

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
