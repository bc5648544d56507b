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
    the [B*K, V] logits, log-softmax and top-k.
Each returns fn(seq, vis, am, vm) -> (tokens [B, max_len - 1] without BOS,
scores [B], steps run).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

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


def make_fast_beam_decode_fn(model, beam_size: int, max_len: int, bos_id: int, eos_id: int,
                             pad_id: int = 0, fused_decode: bool = False,
                             fused_vocab: bool = False):
    """The KV-cache beam search; same hypotheses as ``make_beam_decode_fn``.
    The decoder's weights are prepared once, here."""
    K = beam_size
    fd = FastDecoder(model)

    @torch.inference_mode()
    def decode(sequence_output, visual_output, attention_mask, video_mask):
        B = sequence_output.shape[0]
        dev = sequence_output.device
        cross_out, _, concat_mask = model.get_cross_output(
            sequence_output, visual_output, attention_mask, video_mask)
        # encoder K/V once per instance, shared by its K beams
        enc_kv = fd.precompute_enc_kv(cross_out)
        enc_bias = encoder_bias(concat_mask)
        buckets = _cache_buckets(max_len)
        cache = fd.init_cache(B * K, buckets[0])
        seqs, scores, done = _init_beams(B, K, max_len, bos_id, pad_id, dev)
        local = torch.arange(K, device=dev)
        perm = local.expand(B, K)  # the fused path's pending permutation
        t, steps = 1, 0
        for i, bound in enumerate(buckets):
            if i > 0:  # grow the cache with zeros
                grow = bound - buckets[i - 1]
                cache = [tuple(F.pad(c, (0, 0, 0, grow)) for c in kv) for kv in cache]
            # stop early once every instance's top beam has emitted EOS
            while t < bound and not bool(done.all()):
                tok = seqs[:, :, t - 1].reshape(B * K)
                if fused_decode:
                    out, cache = fd.step_fused(tok, t - 1, cache, enc_kv, enc_bias,
                                               perm.reshape(B * K), K, return_hidden=fused_vocab)
                else:
                    out, cache = fd.step(tok, t - 1, cache, enc_kv, enc_bias,
                                         return_hidden=fused_vocab)
                if fused_vocab:
                    # each row's top K holds every candidate of the global top K
                    logp_top, idx_top = classify_topk(out, *fd.classifier_padded, K)
                    cand = scores[:, :, None] + logp_top.reshape(B, K, K)
                    top_scores, pos = stable_topk(cand.view(B, K * K), K)
                    prev_k, next_y = pos // K, idx_top.reshape(B, K * K).gather(1, pos)
                else:
                    logp = torch.log_softmax(out, dim=-1).view(B, K, -1)
                    top_scores, prev_k, next_y = _select(scores, logp)
                # finished instances keep their rows: the identity permutation
                prev_k_eff = torch.where(done[:, None], local, prev_k)
                if fused_decode:
                    perm = prev_k_eff  # applied in the next step's pass over the cache
                else:
                    beam_reorder_groups_inplace([c for kv in cache for c in kv],
                                                prev_k_eff.reshape(B * K), K)
                seqs, scores, done = _advance(seqs, scores, done, top_scores, prev_k, next_y, t,
                                              eos_id)
                t += 1
                steps += 1
        return seqs[:, 0, 1:], scores[:, 0], steps

    return decode


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

    ``steps`` and ``batches`` count the decode steps run and the batches
    decoded over all ``generate`` calls."""

    def __init__(self, model, tokenizer, device, beam_size: int = 5, max_len: int = 48,
                 fused_decode: bool = False, fused_vocab: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self._decode = make_fast_beam_decode_fn(
            model, beam_size, max_len, bos_id=tokenizer.bos_id, eos_id=tokenizer.eos_id,
            pad_id=tokenizer.pad_id, fused_decode=fused_decode, fused_vocab=fused_vocab)
        self.steps = 0
        self.batches = 0

    @torch.inference_mode()
    def generate(self, batch: Dict[str, np.ndarray]) -> List[str]:
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
             for k, v in batch.items()}
        seq, vis = self.model.encode(b["input_ids"], b["token_type_ids"], b["attention_mask"],
                                     b["video"], b["video_mask"])
        tokens, _, steps = self._decode(seq, vis, b["attention_mask"], b["video_mask"])
        self.steps += steps
        self.batches += 1
        tokens = tokens.cpu().numpy()
        return [ids_to_text(tokens[i], self.tokenizer) for i in range(tokens.shape[0])]
