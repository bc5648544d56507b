"""The incremental (KV-cache) caption decoder: the beam search's hot path.

Ports ``univl_tpu/evals/fast_decoder.py``. The encoder-attention K/V are
projected once per sequence, the self-attention K/V are cached per
position, and each step embeds one token and attends over the cache, so a
hypothesis costs O(L) decoder work instead of the full-prefix decoder's
O(L^2). On the CPU in f32 its logits match the full-prefix decoder's at
every position (``tests/test_torch_decoder.py``).

The JAX package's serving defaults are fixed here, not read from its
``UNIVL_TPU_*`` environment knobs: encoder K/V shared by the beams of one
instance, one fused q/k/v projection per layer, one step per loop turn.

Numerics: the step computes in the model's compute dtype, as the
full-prefix decoder does (the embedding LayerNorm in f32, then rounded).
The JAX package's step keeps the embedding's f32 through its layers; on the
CPU in f32 the two are the same. Attention scores and softmax are f32, the
probabilities are rounded to the compute dtype before PV, and the
classifier's logits are f32 sums of compute-dtype products.

Every weight the step reads is cast to the compute dtype once, when the
decoder is built (the fused q/k/v concatenation and the padded classifier
too), so the step loop launches no casts. A ``FastDecoder`` reads the
model's weights as they are at construction.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from univl_tpu_torch.kernels.decode_attention import MASK_BIAS, beam_decode_self_attention
from univl_tpu_torch.kernels.vocab_topk import pad_vocab_inputs
from univl_tpu_torch.nn.layers import MASK_BIAS as ENC_MASK_BIAS
from univl_tpu_torch.nn.layers import gelu_erf

# per layer (k, v), each [B, H, L, D]
DecodeCache = List[Tuple[torch.Tensor, torch.Tensor]]


def encoder_bias(concat_mask: torch.Tensor) -> torch.Tensor:
    """[B, Lenc] 0/1 mask -> [B, 1, 1, Lenc] additive bias (-10000 drop)."""
    return ((1.0 - concat_mask.float()) * ENC_MASK_BIAS)[:, None, None, :]


class FastDecoder:
    """Incremental decoder over a ``UniVL`` model's decoder weights."""

    def __init__(self, model):
        dec = model.decoder
        cfg = dec.cfg
        self.dtype = dt = model.compute_dtype
        self.n_layers = cfg.num_decoder_layers
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.scale = 1.0 / math.sqrt(self.head_dim)
        emb = model.bert.embeddings
        self.word_embed = emb.word_embeddings.weight
        self.pos_embed = emb.position_embeddings.weight
        self.embed_ln = dec.embeddings.LayerNorm
        pred = self._pred = dec.classifier.cls.predictions
        self.cls_bias = pred.bias

        def w(lin):
            return lin.weight.detach().to(dt), lin.bias.detach().to(dt)

        self.layers = []
        for layer in dec.decoder.layer:
            slf, enc = layer.slf_attn, layer.enc_attn
            q, k, v = (w(getattr(slf.att, n)) for n in ("query", "key", "value"))
            self.layers.append({
                # one [3*Hid, Hid] projection for the step's q, k and v
                "qkv": (torch.cat([q[0], k[0], v[0]]), torch.cat([q[1], k[1], v[1]])),
                "slf_out": w(slf.output.dense), "slf_ln": slf.output.LayerNorm,
                "enc_q": w(enc.att.query), "enc_k": w(enc.att.key), "enc_v": w(enc.att.value),
                "enc_out": w(enc.output.dense), "enc_ln": enc.output.LayerNorm,
                "inter": w(layer.intermediate.dense),
                "out": w(layer.output.dense), "out_ln": layer.output.LayerNorm,
            })
        self.transform = (w(pred.transform.dense), pred.transform.LayerNorm)

    @functools.cached_property
    def classifier_padded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The tied classifier for the vocab top-k kernel: the word table in
        the compute dtype and the f32 bias, padded to the kernel's vocab tile."""
        return pad_vocab_inputs(self.word_embed.detach().to(self.dtype), self.cls_bias.detach())

    @functools.cached_property
    def cls_transform(self):
        """The classifier transform's parameters for the vocab top-k kernel's
        transform (``classify_topk(..., transform=)``): the dense's f32 weight
        [H_out, H_in] and bias, the LayerNorm's f32 scale and bias, and its
        eps. The kernel's LayerNorm is its own, whatever ``--fused_ln`` says."""
        pred = self._pred
        dense, ln = pred.transform.dense, pred.transform.LayerNorm
        return (dense.weight.detach().float(), dense.bias.detach().float(),
                ln.weight.detach().float(), ln.bias.detach().float(), ln.eps)

    @functools.cached_property
    def classifier_f32(self) -> torch.Tensor:
        """The word table rounded to the compute dtype, held in f32 for the
        unfused path's f32 logits."""
        return self.word_embed.detach().to(self.dtype).float()

    # ---------------------------------------------------------------- #
    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape  # [B, T, H*D] -> [B, H, T, D]
        return x.view(b, t, self.heads, self.head_dim).transpose(1, 2)

    def precompute_enc_kv(self, encoder_out: torch.Tensor) -> DecodeCache:
        """Per layer, the encoder attention's (k, v), each [B, H, Lenc, D]."""
        x = encoder_out.to(self.dtype)
        return [(self._split(F.linear(x, *p["enc_k"])), self._split(F.linear(x, *p["enc_v"])))
                for p in self.layers]

    def init_cache(self, batch: int, max_len: int) -> DecodeCache:
        shape = (batch, self.heads, max_len, self.head_dim)
        dev = self.word_embed.device
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev)) for _ in self.layers]

    # ---------------------------------------------------------------- #
    def _embed(self, tok: torch.Tensor, t: int) -> torch.Tensor:
        x = self.word_embed[tok] + self.pos_embed[t]
        return self.embed_ln(x[:, None, :]).to(self.dtype)  # [B, 1, H]

    def _qkv(self, x: torch.Tensor, p) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        f = F.linear(x[:, 0], *p["qkv"])  # [B, 3*H*D]
        hd = self.heads * self.head_dim
        return tuple(f[:, i * hd:(i + 1) * hd].view(-1, self.heads, self.head_dim)
                     for i in range(3))

    def _layer_tail(self, ctx: torch.Tensor, x: torch.Tensor, p, enc_kv_i,
                    enc_bias: torch.Tensor) -> torch.Tensor:
        """Everything after the self-attention context [B, H, D]: its output
        projection and LayerNorm, the encoder attention, the FFN."""
        B = x.shape[0]
        slf_out = p["slf_ln"](F.linear(ctx.reshape(B, 1, -1), *p["slf_out"]) + x)
        ek, ev = enc_kv_i
        # encoder K/V are per instance, shared by its G beams: the beams become
        # the query length of the instance's attention (G = 1 when per row)
        Be = ek.shape[0]
        G = B // Be
        q2 = F.linear(slf_out[:, 0], *p["enc_q"])
        q2 = q2.view(Be, G, self.heads, self.head_dim).transpose(1, 2)  # [Be, H, G, D]
        scores = torch.matmul(q2.float(), ek.float().transpose(-1, -2)) * self.scale
        probs = torch.softmax(scores + enc_bias, dim=-1).to(x.dtype)
        ctx2 = torch.matmul(probs.float(), ev.float()).to(x.dtype)  # [Be, H, G, D]
        ctx2 = ctx2.transpose(1, 2).reshape(B, 1, -1)
        enc_out = p["enc_ln"](F.linear(ctx2, *p["enc_out"]) + slf_out)
        inter = gelu_erf(F.linear(enc_out, *p["inter"]))
        return p["out_ln"](F.linear(inter, *p["out"]) + enc_out)

    def _classify_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The classifier transform (dense -> GELU -> LayerNorm) without the
        vocab product: [B, 1, H] -> [B, H]."""
        (wd, bd), ln = self.transform
        return ln(gelu_erf(F.linear(x[:, 0], wd, bd)))

    def _classify(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits [B, V]."""
        h = self._classify_hidden(x)
        return torch.matmul(h.float(), self.classifier_f32.t()) + self.cls_bias

    def _head(self, x: torch.Tensor, return_hidden) -> torch.Tensor:
        """f32 logits; with ``return_hidden`` the transformed hidden [B, H];
        with ``return_hidden="raw"`` the raw hidden [B, H], for the vocab
        kernel's own transform."""
        if return_hidden == "raw":
            return x[:, 0]
        return self._classify_hidden(x) if return_hidden else self._classify(x)

    # ---------------------------------------------------------------- #
    def step(self, tok: torch.Tensor, t: int, cache: DecodeCache, enc_kv: DecodeCache,
             enc_bias: torch.Tensor, return_hidden=False):
        """Embed token ``tok`` [B] at position ``t``, write its K/V into the
        cache (in place), attend over positions 0..t in plain PyTorch, and
        return (logits [B, V] f32 for position t + 1, or with
        ``return_hidden`` the classifier's input [B, H], with
        ``return_hidden="raw"`` the transform's input; the cache)."""
        x = self._embed(tok, t)
        L = cache[0][0].shape[2]
        masked = torch.arange(L, device=x.device) > t
        for p, (ck, cv), kv in zip(self.layers, cache, enc_kv):
            q, k_t, v_t = self._qkv(x, p)
            ck[:, :, t] = k_t
            cv[:, :, t] = v_t
            scores = torch.einsum("bhd,bhld->bhl", q.float(), ck.float()) * self.scale
            probs = torch.softmax(scores.masked_fill(masked, MASK_BIAS), dim=-1).to(x.dtype)
            ctx = torch.einsum("bhl,bhld->bhd", probs.float(), cv.float()).to(x.dtype)
            x = self._layer_tail(ctx, x, p, kv, enc_bias)
        return self._head(x, return_hidden), cache

    def step_fused(self, tok: torch.Tensor, t: int, cache: DecodeCache, enc_kv: DecodeCache,
                   enc_bias: torch.Tensor, perm: torch.Tensor, group: int,
                   return_hidden=False):
        """``step`` with the pending beam permutation ``perm`` ([B], local to
        each group of ``group`` rows) fused into the self-attention's pass over
        the cache (the decode-attention kernel): the cache arrives one
        permutation behind and leaves reordered and updated, as new tensors."""
        x = self._embed(tok, t)
        new_cache = []
        for p, (ck, cv), kv in zip(self.layers, cache, enc_kv):
            q, k_t, v_t = self._qkv(x, p)
            ctx, ck, cv = beam_decode_self_attention(q, k_t, v_t, ck, cv, perm, t, group,
                                                     scale=self.scale)
            new_cache.append((ck, cv))
            x = self._layer_tail(ctx, x, p, kv, enc_bias)
        return self._head(x, return_hidden), new_cache
