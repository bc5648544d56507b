"""Beam search for caption decoding, in PyTorch.

Ports ``univl_tpu/evals/beam.py``. Reference behaviour kept:
  - cumulative log-prob scores, no length normalization;
  - step 1 expands only the first beam row;
  - backpointers prev_k = id // V, token = id % V;
  - an instance is finished when its top beam emits EOS ([SEP]);
  - the top beam row is the hypothesis.
The cross encoder runs once per batch; finished instances are frozen by
masking; beam rows are reordered as they go. Top-k is ``stable_topk``: among
equal values the lower index first, as ``lax.top_k``.

Two decoders:
  - ``make_beam_decode_fn``: the full-prefix oracle, which reruns the whole
    decoder every step (the tests' reference);
  - ``make_fast_beam_decode_fn``: the KV-cache decoder in cache buckets of
    32, 64, ... up to max_len, stopping when every instance has finished.
    ``fused_decode`` runs the decode-attention kernel (the beam permutation
    deferred into the next step's pass over the cache); otherwise the step
    attends in plain PyTorch and the grouped reorder kernel permutes the
    cache after it. ``fused_vocab`` runs the vocab top-k kernel in place of
    the [B*K, V] logits, log-softmax and top-k; with it, ``fused_cls`` moves
    the classifier transform (dense, erf-GELU, LayerNorm) into that kernel
    too, and the step returns the raw hidden (JAX's ``UNIVL_TPU_FUSED_CLS``).
Each returns fn(seq, vis, am, vm) -> (tokens [B, max_len - 1] without BOS,
scores [B], steps run).

The KV-cache decoder keeps its beams in device tensors and, on a CUDA model,
decodes as JAX's jitted while-loops do: each cache bucket's steps are
replays of CUDA graphs of ``unroll`` steps (and single steps for the
bucket's tail), with one one-byte read a replay for the early exit;
``CaptionGenerator`` adds one replay a batch for the encode and the cross
encoder (``FastBeamDecode``).
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from univl_tpu_torch.evals.fast_decoder import FastDecoder, encoder_bias
from univl_tpu_torch.kernels.reorder import beam_reorder_groups_inplace
from univl_tpu_torch.kernels.vocab_topk import classify_topk, stable_topk

NEG_INF = -1e18


def _init_beams(B: int, K: int, max_len: int, bos_id: int, pad_id: int, device):
    seqs = torch.full((B, K, max_len), pad_id, dtype=torch.long, device=device)
    seqs[:, :, 0] = bos_id
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0  # only beam 0 is live at the start
    return seqs, scores, torch.zeros(B, dtype=torch.bool, device=device)


def _advance(seqs, scores, done, top_scores, prev_k, next_y, t: int, eos_id: int):
    """Follow the surviving beams, append their tokens, freeze finished instances."""
    B, K, L = seqs.shape
    new_seqs = seqs.gather(1, prev_k[:, :, None].expand(B, K, L)).clone()
    new_seqs[:, :, t] = next_y
    seqs = torch.where(done[:, None, None], seqs, new_seqs)
    scores = torch.where(done[:, None], scores, top_scores)
    return seqs, scores, done | (next_y[:, 0] == eos_id)


def _select(scores, logp: torch.Tensor):
    """Top K of scores + logp over [B, K * V]: (top scores, prev_k, tokens)."""
    B, K, V = logp.shape
    top_scores, top_idx = stable_topk((scores[:, :, None] + logp).view(B, K * V), K)
    return top_scores, top_idx // V, top_idx % V


def make_beam_decode_fn(model, beam_size: int, max_len: int, bos_id: int, eos_id: int,
                        pad_id: int = 0):
    """The full-prefix beam search: every step reruns the decoder over the
    whole prefix. Runs all max_len - 1 steps (finished instances frozen)."""
    K = beam_size

    @torch.inference_mode()
    def decode(sequence_output, visual_output, attention_mask, video_mask):
        B = sequence_output.shape[0]
        dev = sequence_output.device
        cross_out, _, concat_mask = model.get_cross_output(
            sequence_output, visual_output, attention_mask, video_mask)
        cross_rep = cross_out.repeat_interleave(K, dim=0)
        mask_rep = concat_mask.repeat_interleave(K, dim=0)
        seqs, scores, done = _init_beams(B, K, max_len, bos_id, pad_id, dev)
        positions = torch.arange(max_len, device=dev)
        for t in range(1, max_len):
            dec_mask = (positions < t).long()[None].expand(B * K, max_len)
            logits = model.decode_step_logits(cross_rep, mask_rep, seqs.view(B * K, max_len),
                                              dec_mask)
            # token t is predicted at position t - 1
            logp = torch.log_softmax(logits[:, t - 1].float(), dim=-1).view(B, K, -1)
            top_scores, prev_k, next_y = _select(scores, logp)
            seqs, scores, done = _advance(seqs, scores, done, top_scores, prev_k, next_y, t,
                                          eos_id)
        return seqs[:, 0, 1:], scores[:, 0], max_len - 1

    return decode


def _cache_buckets(max_len: int, first: int = 32) -> List[int]:
    """Cache lengths [32, 64, ...] doubling up to max_len, which closes the list."""
    sizes = []
    s = min(first, max_len)
    while s < max_len:
        sizes.append(s)
        s *= 2
    sizes.append(max_len)
    return sizes


class _BeamState:
    """One batch shape's decode state in device tensors, updated in place by
    every step: the position ``t`` (0-d int32), the beams (``seqs``,
    ``scores``, ``done``), the fused path's pending permutation ``perm``,
    ``finished`` (every instance done, after the last step), the encoder's
    K/V and bias, and per cache bucket its cache sets (two on the fused path,
    each step reading one and writing the other). A captured step reads and
    writes these tensors, so they live as long as the decoder's graphs."""

    def __init__(self, fd: FastDecoder, B: int, K: int, enc_len: int, buckets: List[int],
                 max_len: int, sets: int, device):
        self.B, self.enc_len = B, enc_len
        self.t = torch.ones((), dtype=torch.int32, device=device)
        self.seqs = torch.zeros(B, K, max_len, dtype=torch.long, device=device)
        self.scores = torch.zeros(B, K, dtype=torch.float32, device=device)
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.finished = torch.zeros((), dtype=torch.bool, device=device)
        self.perm = torch.zeros(B, K, dtype=torch.long, device=device)
        shape = (B, fd.heads, enc_len, fd.head_dim)
        self.enc_kv = [tuple(torch.zeros(shape, dtype=fd.dtype, device=device) for _ in "kv")
                       for _ in range(fd.n_layers)]
        self.enc_bias = torch.zeros(B, 1, 1, enc_len, dtype=torch.float32, device=device)
        self.caches = {bound: [fd.init_cache(B * K, bound) for _ in range(sets)]
                       for bound in buckets}


class FastBeamDecode:
    """The KV-cache beam search, ``make_fast_beam_decode_fn``'s decoder:
    fn(seq, vis, am, vm) -> (tokens [B, max_len - 1] without BOS, scores
    [B], steps run).

    The beams live in device tensors (``_BeamState``) that each step updates
    in place; a step reads the position from device memory and makes no host
    read. The host runs ``unroll`` steps at a time while every one of them
    stays inside the cache bucket, then single steps to the bucket's end (as
    JAX's ``UNIVL_TPU_DECODE_UNROLL`` while-loops), and after each run reads
    one byte, whether every instance has finished, and stops as JAX's loop
    condition does. A step after every instance finished is a masked no-op,
    so ``unroll`` changes the steps run, never the hypotheses.

    ``graph`` (default: on a CUDA model) replays each run of steps as a CUDA
    graph: captured at its first use, after that use's steps ran eagerly on
    a side stream, and kept on the decoder, keyed by the batch, the beam,
    the bucket, the steps a run, the cache set the run starts from, the
    route and the dtype. Without it the same steps run eagerly (the CPU's
    route; on the card an A/B's). A failed capture or replay raises.

    Every decode starts by writing the model's current weights into the
    decoder's casts (``FastDecoder.refresh``); a parameter whose storage was
    replaced (not its values) drops the decoder, its graphs with it."""

    def __init__(self, model, beam_size: int, max_len: int, bos_id: int, eos_id: int,
                 pad_id: int = 0, fused_decode: bool = False, fused_vocab: bool = False,
                 fused_cls: bool = False, unroll: int = 1, graph: Optional[bool] = None):
        if unroll < 1:
            raise ValueError(f"unroll={unroll}: a run takes at least one step")
        device = next(model.parameters()).device
        graph = device.type == "cuda" if graph is None else bool(graph)
        if graph and device.type != "cuda":
            raise ValueError(f"CUDA graphs decode on a CUDA device, not {device}")
        if fused_cls and not fused_vocab:
            # the transform runs inside the vocab kernel; without it the flag would
            # be silently ignored and an A/B would compare identical programs
            warnings.warn("fused_cls has no effect without the fused vocab kernel (fused_vocab)",
                          UserWarning, stacklevel=3)
            fused_cls = False
        self.model, self.K, self.max_len = model, beam_size, max_len
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.fused_decode, self.fused_vocab, self.fused_cls = fused_decode, fused_vocab, fused_cls
        self.unroll, self.graph, self.device = unroll, graph, device
        # what the step returns: logits, the transformed hidden, or the raw hidden
        self.return_hidden = ("raw" if fused_cls else True) if fused_vocab else False
        self.buckets = _cache_buckets(max_len)
        self.local = torch.arange(beam_size, device=device)
        self.positions = torch.arange(max_len, device=device)
        self.states: Dict[tuple, _BeamState] = {}
        self.graphs: Dict[tuple, "torch.cuda.CUDAGraph"] = {}
        # the graphs' memory pool, shared (they replay one at a time), and their stream
        self.pool = self.stream = None
        # graph replays by the steps they run, captures (with their first eager
        # runs: seconds), and the host's reads of ``finished``
        self.replays = collections.Counter()
        self.captures = self.reads = 0
        self.capture_s = 0.0
        self._params = list(model.parameters())
        self._build()

    def _build(self) -> None:
        """The decoder's casts of the weights, every one the route's step
        reads, and no graphs yet: a captured prologue replays the ``refresh``
        of the casts that existed at its capture, so none may come later."""
        self.fd = FastDecoder(self.model)
        if self.fused_vocab:  # the kernel's operands, built once, refreshed in place
            self.classifier = self.fd.classifier_padded
            self.transform = self.fd.cls_transform if self.fused_cls else None
        else:
            self.fd.classifier_f32  # noqa: B018 -- the f32 logits' table, built here
        self.graphs.clear()
        self.addresses = tuple(p.data_ptr() for p in self._params)

    def check_weights(self) -> bool:
        """Rebuild the decoder (and drop its graphs) where a parameter's
        storage moved since it was built; returns whether it did."""
        if tuple(p.data_ptr() for p in self._params) == self.addresses:
            return False
        self._build()
        return True

    @torch.inference_mode()
    def __call__(self, sequence_output, visual_output, attention_mask, video_mask):
        self.check_weights()
        st = self.state(sequence_output.shape[0], attention_mask.shape[1] + video_mask.shape[1])
        self.prologue(st, sequence_output, visual_output, attention_mask, video_mask)
        return self.run(st)

    def state(self, B: int, enc_len: int) -> _BeamState:
        """The device state of a batch of B instances over enc_len encoder positions."""
        key = (B, enc_len)
        if key not in self.states:
            self.states[key] = _BeamState(self.fd, B, self.K, enc_len, self.buckets,
                                          self.max_len, 2 if self.fused_decode else 1,
                                          self.device)
        return self.states[key]

    def prologue(self, st: _BeamState, sequence_output, visual_output, attention_mask,
                 video_mask) -> None:
        """Everything before the first step, written into ``st``: the current
        weights into the decoder's casts, the cross encoder, the encoder K/V
        once per instance (shared by its K beams) and bias, the beams at the
        start, the first bucket's cache zero. No host read: a graph can hold it."""
        self.fd.refresh()
        cross_out, _, concat_mask = self.model.get_cross_output(
            sequence_output, visual_output, attention_mask, video_mask)
        for dst, src in zip(st.enc_kv, self.fd.precompute_enc_kv(cross_out)):
            for d, s in zip(dst, src):
                d.copy_(s)
        st.enc_bias.copy_(encoder_bias(concat_mask))
        st.t.fill_(1)
        st.seqs.fill_(self.pad_id)
        st.seqs[:, :, 0] = self.bos_id
        st.scores.fill_(NEG_INF)
        st.scores[:, 0] = 0.0  # only beam 0 is live at the start
        st.done.zero_()
        st.finished.zero_()
        st.perm.copy_(self.local.expand(st.B, self.K))  # the fused path's pending permutation
        for kv in st.caches[self.buckets[0]][0]:
            for c in kv:
                c.zero_()

    def run(self, st: _BeamState):
        """The steps from a prologue's state to the end: (tokens, scores, steps)."""
        t, done, first = 1, False, 0  # the host's count of the position; the set read first
        runs = (self.unroll, 1) if self.unroll > 1 else (1,)
        for i, bound in enumerate(self.buckets):
            if i > 0:
                self._grow(st, self.buckets[i - 1], bound, first)
            for n in runs:  # runs of n steps while all of them stay in the bucket
                while not done and t + n - 1 < bound:
                    self._dispatch(st, bound, first, n)
                    t += n
                    first = (first + n) % len(st.caches[bound])
                    done = bool(st.finished)  # the one read a run: every instance done
                    self.reads += 1
        return st.seqs[:, 0, 1:].clone(), st.scores[:, 0].clone(), t - 1

    def _grow(self, st: _BeamState, small: int, bound: int, first: int) -> None:
        """The bucket's cache set ``first`` from the smaller bucket's: its
        positions copied, the rest zero."""
        for kv_small, kv_big in zip(st.caches[small][first], st.caches[bound][first]):
            for c_small, c_big in zip(kv_small, kv_big):
                c_big[:, :, :small].copy_(c_small)
                c_big[:, :, small:].zero_()

    def _dispatch(self, st: _BeamState, bound: int, first: int, n: int) -> None:
        """n steps: a replay of their graph, or eagerly (without graphs, and
        at the graph's first use, before its capture)."""
        if not self.graph:
            self._steps(st, bound, first, n)
            return
        key = (st.B, self.K, st.enc_len, bound, n, first, self.fused_decode, self.fused_vocab,
               self.fused_cls, self.fd.dtype)
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            self.replays[n] += 1
            return
        self.graphs[key] = self.capture(lambda: self._steps(st, bound, first, n))

    def capture(self, fn) -> "torch.cuda.CUDAGraph":
        """Run ``fn`` eagerly on a side stream, then capture it (which runs
        nothing) into a graph of the decoder's pool; returns the graph.
        ``torch.cuda.graph`` without its ``empty_cache``: the decoder's
        graphs are many and small, and the cached blocks it would free are
        what the next eager first use allocates again."""
        t0 = time.perf_counter()
        if self.pool is None:  # one stream for the captures that share the pool
            self.pool, self.stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
        current, side = torch.cuda.current_stream(), self.stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            # other threads' device work (a prefetch, a server's other service) goes on
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        current.wait_stream(side)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph

    def _steps(self, st: _BeamState, bound: int, first: int, n: int) -> None:
        """The step body n times from cache set ``first``, then ``finished``;
        reads nothing back to the host."""
        sets = st.caches[bound]
        for j in range(n):
            i = (first + j) % len(sets)
            self._step(st, sets[i], sets[(i + 1) % len(sets)])
        st.finished.copy_(st.done.all())

    def _step(self, st: _BeamState, cache, out) -> None:
        """One beam step at position ``st.t``: the decoder over the beams'
        last tokens (the fused path writes its cache into ``out``), the top K
        continuations, the cache reordered (or the permutation kept for the
        next step's pass), the beams advanced, finished instances frozen."""
        B, K, fd = st.B, self.K, self.fd
        pos = st.t - 1
        tok = st.seqs.index_select(2, pos.view(1)).view(B * K)
        if self.fused_decode:
            h, _ = fd.step_fused(tok, pos, cache, st.enc_kv, st.enc_bias, st.perm.view(B * K), K,
                                 return_hidden=self.return_hidden, out=out)
        else:
            h, _ = fd.step(tok, pos, cache, st.enc_kv, st.enc_bias,
                           return_hidden=self.return_hidden)
        if self.fused_vocab:
            # each row's top K holds every candidate of the global top K
            logp_top, idx_top = classify_topk(h, *self.classifier, K, self.transform)
            cand = st.scores[:, :, None] + logp_top.reshape(B, K, K)
            top_scores, at = stable_topk(cand.view(B, K * K), K)
            prev_k, next_y = at // K, idx_top.reshape(B, K * K).gather(1, at)
        else:
            logp = torch.log_softmax(h, dim=-1).view(B, K, -1)
            top_scores, prev_k, next_y = _select(st.scores, logp)
        # finished instances keep their rows: the identity permutation
        keep = torch.where(st.done[:, None], self.local, prev_k)
        if self.fused_decode:
            st.perm.copy_(keep)  # applied in the next step's pass over the cache
        else:
            beam_reorder_groups_inplace([c for kv in cache for c in kv], keep.reshape(B * K), K)
        moved = st.seqs.gather(1, prev_k[:, :, None].expand(B, K, self.max_len))
        moved = torch.where(self.positions == st.t, next_y[:, :, None], moved)
        st.seqs.copy_(torch.where(st.done[:, None, None], st.seqs, moved))
        st.scores.copy_(torch.where(st.done[:, None], st.scores, top_scores))
        st.done.logical_or_(next_y[:, 0] == self.eos_id)
        st.t.add_(1)


def make_fast_beam_decode_fn(model, beam_size: int, max_len: int, bos_id: int, eos_id: int,
                             pad_id: int = 0, fused_decode: bool = False,
                             fused_vocab: bool = False, fused_cls: bool = False,
                             unroll: int = 1, graph: Optional[bool] = None) -> FastBeamDecode:
    """The KV-cache beam search; same hypotheses as ``make_beam_decode_fn``.
    The decoder's weights are cast once, here, and refreshed at each decode.
    ``fused_cls`` without ``fused_vocab`` is ignored, with a warning (as in
    the JAX package). ``unroll`` steps a run (JAX's
    ``UNIVL_TPU_DECODE_UNROLL``); ``graph``: ``FastBeamDecode``."""
    return FastBeamDecode(model, beam_size, max_len, bos_id, eos_id, pad_id, fused_decode,
                          fused_vocab, fused_cls, unroll, graph)


def ids_to_text(ids, tokenizer) -> str:
    """Cut at the first [SEP], drop [PAD], merge '##' wordpieces."""
    toks = tokenizer.convert_ids_to_tokens([int(i) for i in np.asarray(ids)])
    if "[SEP]" in toks:
        toks = toks[: toks.index("[SEP]")]
    words: list = []
    for tok in toks:
        if tok == "[PAD]":
            continue
        if tok.startswith("##") and words:
            words[-1] = words[-1] + tok[2:]
        else:
            words.append(tok)
    return " ".join(words)


class CaptionGenerator:
    """Batched caption generation: encode -> KV-cache beam decode -> text.

    On the decoder's graph route (the default on a CUDA model) a batch is
    copied into a graph's inputs and the encode, the cross encoder and the
    rest of the decode's prologue are one replay, captured per batch shape
    (after that shape's first batch ran eagerly), then the decode replays
    its runs of steps. ``steps`` and ``batches`` count the decode steps run
    and the batches decoded over all ``generate`` calls."""

    def __init__(self, model, tokenizer, device, beam_size: int = 5, max_len: int = 48,
                 fused_decode: bool = False, fused_vocab: bool = False,
                 fused_cls: bool = False, unroll: int = 1, graph: Optional[bool] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.decoder = make_fast_beam_decode_fn(
            model, beam_size, max_len, bos_id=tokenizer.bos_id, eos_id=tokenizer.eos_id,
            pad_id=tokenizer.pad_id, fused_decode=fused_decode, fused_vocab=fused_vocab,
            fused_cls=fused_cls, unroll=unroll, graph=graph)
        self._encodes: Dict[tuple, tuple] = {}  # batch shape -> (graph, its inputs)
        self.encode_replays = 0
        self.steps = 0
        self.batches = 0

    def generate(self, batch: Dict[str, np.ndarray]) -> List[str]:
        tokens = self.decode(batch)[0].cpu().numpy()
        return [ids_to_text(tokens[i], self.tokenizer) for i in range(tokens.shape[0])]

    @torch.inference_mode()
    def decode(self, batch: Dict[str, np.ndarray]):
        """A host batch's (tokens [B, max_len - 1] without BOS, scores [B],
        steps run), the tensors on the device."""
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        dec = self.decoder
        if dec.graph:
            if dec.check_weights():
                self._encodes.clear()
            out = dec.run(self._encode_replay(host))
        else:
            b = {k: v.to(self.device) for k, v in host.items()}
            seq, vis = self.model.encode(b["input_ids"], b["token_type_ids"],
                                         b["attention_mask"], b["video"], b["video_mask"])
            out = dec(seq, vis, b["attention_mask"], b["video_mask"])
        self.steps += out[2]
        self.batches += 1
        return out

    def _encode_replay(self, host: Dict[str, torch.Tensor]):
        """The batch into the graph's inputs and the encode and prologue's
        replay (at a shape's first batch: eagerly, then the capture);
        returns the decode state it wrote."""
        dec = self.decoder
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(host.items()))
        st = dec.state(host["video"].shape[0],
                       host["attention_mask"].shape[1] + host["video_mask"].shape[1])
        entry = self._encodes.get(key)
        inputs = entry[1] if entry else {k: torch.empty(v.shape, dtype=v.dtype,
                                                        device=self.device)
                                         for k, v in host.items()}
        for k, v in host.items():
            inputs[k].copy_(v)
        if entry is not None:
            entry[0].replay()
            self.encode_replays += 1
            return st

        def encode():
            seq, vis = self.model.encode(inputs["input_ids"], inputs["token_type_ids"],
                                         inputs["attention_mask"], inputs["video"],
                                         inputs["video_mask"])
            dec.prologue(st, seq, vis, inputs["attention_mask"], inputs["video_mask"])

        self._encodes[key] = (dec.capture(encode), inputs)
        return st
