"""Weights for the port: from a JAX parameter tree, a reference ``.bin``, or a seeded init.

All three give a state dict under the reference PyTorch names, restricted
to what ``univl_tpu_torch.models.univl.UniVL`` owns (no text/visual poolers,
and the tied tables only once: the decoder's and the masked-language head's
as bert's, the masked-frame head's weight as the feature projection's),
ready for ``load_state_dict(strict=True)``. The other way,
``jax_params_from_state_dict`` gives the JAX tree of a port state dict and
``reference_state_dict`` the reference ``.bin`` layout, the tied duplicates
written out. Nothing here imports JAX: a JAX tree is nested dicts of numpy
arrays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from univl_tpu_torch.config import UniVLConfig

# flax sub-path -> (torch suffix, kind); copied from
# univl_tpu/checkpoint/torch_convert.py (_INV_BLOCK, _INV_DECODER_BLOCK, and
# the encoder and decoder rows of _INV_TOP), which cannot be imported
# without JAX.
_INV_BLOCK = {
    "attention/query": ("attention.self.query", "linear"),
    "attention/key": ("attention.self.key", "linear"),
    "attention/value": ("attention.self.value", "linear"),
    "attention_output/dense": ("attention.output.dense", "linear"),
    "attention_output/ln": ("attention.output.LayerNorm", "ln"),
    "intermediate": ("intermediate.dense", "linear"),
    "output/dense": ("output.dense", "linear"),
    "output/ln": ("output.LayerNorm", "ln"),
}

_INV_DECODER_BLOCK = {
    "self_attn/query": ("slf_attn.att.query", "linear"),
    "self_attn/key": ("slf_attn.att.key", "linear"),
    "self_attn/value": ("slf_attn.att.value", "linear"),
    "self_attn_output/dense": ("slf_attn.output.dense", "linear"),
    "self_attn_output/ln": ("slf_attn.output.LayerNorm", "ln"),
    "enc_attn/query": ("enc_attn.att.query", "linear"),
    "enc_attn/key": ("enc_attn.att.key", "linear"),
    "enc_attn/value": ("enc_attn.att.value", "linear"),
    "enc_attn_output/dense": ("enc_attn.output.dense", "linear"),
    "enc_attn_output/ln": ("enc_attn.output.LayerNorm", "ln"),
    "intermediate": ("intermediate.dense", "linear"),
    "output/dense": ("output.dense", "linear"),
    "output/ln": ("output.LayerNorm", "ln"),
}

_INV_TOP = {
    "word_embed/embedding": "bert.embeddings.word_embeddings.weight",
    "text_pos_embed/embedding": "bert.embeddings.position_embeddings.weight",
    "text/type_embed/embedding": "bert.embeddings.token_type_embeddings.weight",
    "visual/pos_embed/embedding": "visual.embeddings.position_embeddings.weight",
    "cross/pos_embed/embedding": "cross.embeddings.position_embeddings.weight",
    "cross/type_embed/embedding": "cross.embeddings.token_type_embeddings.weight",
    "decoder/classifier_bias": "decoder.classifier.cls.predictions.bias",
    "mlm_head/bias": "cls.predictions.bias",
    "mfm_head/bias": "cls_visual.predictions.bias",
}
_HEADS = {"mlm_head": "cls", "mfm_head": "cls_visual"}
_JAX_HEADS = {v: k for k, v in _HEADS.items()}

_TOWER = {"text": "bert", "visual": "visual", "cross": "cross"}
_JAX_TOWER = {v: k for k, v in _TOWER.items()}
# torch suffix -> (flax sub-path, kind): the tables above inverted
_BLOCK = {suffix: (sub, kind) for sub, (suffix, kind) in _INV_BLOCK.items()}
_DECODER_BLOCK = {suffix: (sub, kind) for sub, (suffix, kind) in _INV_DECODER_BLOCK.items()}

# what the port does not own: the text/visual poolers UniVL never reads
_TORCH_NOT_OWNED = re.compile(r"^(bert|visual)\.pooler\.")

# the tied tables, which a reference .bin stores as duplicates: the decoder's
# and the masked-language head's of bert's, the masked-frame head's weight of
# the feature projection's ([hidden, video_dim] both)
_TIED = {
    "decoder.embeddings.word_embeddings.weight": "bert.embeddings.word_embeddings.weight",
    "decoder.embeddings.position_embeddings.weight":
        "bert.embeddings.position_embeddings.weight",
    "decoder.classifier.cls.predictions.decoder.weight": "bert.embeddings.word_embeddings.weight",
    "cls.predictions.decoder.weight": "bert.embeddings.word_embeddings.weight",
    "cls_visual.predictions.weight": "visual.embeddings.word_embeddings.weight",
}


def _torch_leaf(kind: str, flax_leaf: str, value: np.ndarray):
    if kind == "linear":
        return ("weight", value.T) if flax_leaf == "kernel" else ("bias", value)
    return ("weight", value) if flax_leaf == "scale" else ("bias", value)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _torch_name(path: str, value: np.ndarray):
    if path in _INV_TOP:
        return _INV_TOP[path], value
    m = re.match(r"^(text|visual|cross)/embed_ln/(scale|bias)$", path)
    if m:
        name, v = _torch_leaf("ln", m.group(2), value)
        return f"{_TOWER[m.group(1)]}.embeddings.LayerNorm.{name}", v
    m = re.match(r"^feature_proj/(kernel|bias)$", path)
    if m:
        name, v = _torch_leaf("linear", m.group(1), value)
        return f"visual.embeddings.word_embeddings.{name}", v
    m = re.match(r"^(text|visual|cross)/encoder/layer_(\d+)/(.+)/(\w+)$", path)
    if m and m.group(3) in _INV_BLOCK:
        suffix, kind = _INV_BLOCK[m.group(3)]
        name, v = _torch_leaf(kind, m.group(4), value)
        return f"{_TOWER[m.group(1)]}.encoder.layer.{m.group(2)}.{suffix}.{name}", v
    m = re.match(r"^decoder/embed_ln/(scale|bias)$", path)
    if m:
        name, v = _torch_leaf("ln", m.group(1), value)
        return f"decoder.embeddings.LayerNorm.{name}", v
    m = re.match(r"^decoder/layer_(\d+)/(.+)/(\w+)$", path)
    if m and m.group(2) in _INV_DECODER_BLOCK:
        suffix, kind = _INV_DECODER_BLOCK[m.group(2)]
        name, v = _torch_leaf(kind, m.group(3), value)
        return f"decoder.decoder.layer.{m.group(1)}.{suffix}.{name}", v
    m = re.match(r"^decoder/classifier_transform/(dense|ln)/(\w+)$", path)
    if m:
        kind, tname = ("linear", "dense") if m.group(1) == "dense" else ("ln", "LayerNorm")
        name, v = _torch_leaf(kind, m.group(2), value)
        return f"decoder.classifier.cls.predictions.transform.{tname}.{name}", v
    m = re.match(r"^(mlm_head|mfm_head)/transform/(dense|ln)/(\w+)$", path)
    if m:
        kind, tname = ("linear", "dense") if m.group(2) == "dense" else ("ln", "LayerNorm")
        name, v = _torch_leaf(kind, m.group(3), value)
        return f"{_HEADS[m.group(1)]}.predictions.transform.{tname}.{name}", v
    m = re.match(r"^(cross/pooler/dense|similarity_dense)/(kernel|bias)$", path)
    if m:
        name, v = _torch_leaf("linear", m.group(2), value)
        return f"{m.group(1).replace('/', '.')}.{name}", v
    m = re.match(r"^video_norm/(scale|bias)$", path)
    if m:
        name, v = _torch_leaf("ln", m.group(1), value)
        return f"normalize_video.visual_norm2d.{name}", v
    raise ValueError(f"unrecognized flax param path: {path}")


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``model.init(...)["params"]`` tree (leaves as numpy arrays) ->
    the port's state dict. Same names and layouts as
    ``univl_tpu.checkpoint.torch_convert.export_torch_state_dict`` on the
    parts the port owns; raises on a path it does not recognise."""
    sd = {}
    for path, value in _flatten(params).items():
        name, v = _torch_name(path, value)
        sd[name] = torch.from_numpy(np.array(v, np.float32, order="C"))  # a copy
    return sd


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """A port state dict -> the JAX parameter tree (nested dicts of f32
    numpy arrays, a Linear's weight transposed into its ``kernel``): the
    inverse of ``state_dict_from_jax_params``."""
    tree: Dict = {}
    for name, value in sd.items():
        *parents, leaf = jax_path(name).split("/")
        v = value.detach().to("cpu", torch.float32).numpy()
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v.T if leaf == "kernel" else v)
    return tree


def reference_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A port state dict in the reference ``.bin`` layout, as
    ``univl_tpu.checkpoint.torch_convert.export_torch_state_dict`` writes
    it: the JAX tree's order, then each tied duplicate of a module the dict
    holds (the decoder's tables and classifier weight, the heads' weights),
    written out as a copy of the table it repeats."""
    order = sorted(sd, key=lambda n: jax_path(n).split("/"))
    out = {name: sd[name].detach().cpu() for name in order}
    for dup, src in _TIED.items():
        if src in out and any(k.startswith(dup.split(".")[0] + ".") for k in sd):
            out[dup] = out[src].clone()
    return out


def jax_path(name: str) -> str:
    """The JAX parameter path (``text/encoder/layer_0/attention/query/kernel``)
    of a port parameter name (``bert.encoder.layer.0.attention.self.query.weight``):
    the inverse of the naming in ``state_dict_from_jax_params``, so a port
    gradient or parameter group lines up with the JAX tree leaf for leaf."""
    top = {v: k for k, v in _INV_TOP.items()}
    if name in top:
        return top[name]
    module, leaf = name.rsplit(".", 1)
    lin = {"weight": "kernel", "bias": "bias"}
    ln = {"weight": "scale", "bias": "bias"}
    m = re.match(r"^(bert|visual|cross)\.embeddings\.LayerNorm$", module)
    if m:
        return f"{_JAX_TOWER[m.group(1)]}/embed_ln/{ln[leaf]}"
    if module == "visual.embeddings.word_embeddings":
        return f"feature_proj/{lin[leaf]}"
    m = re.match(r"^(bert|visual|cross)\.encoder\.layer\.(\d+)\.(.+)$", module)
    if m and m.group(3) in _BLOCK:
        sub, kind = _BLOCK[m.group(3)]
        return (f"{_JAX_TOWER[m.group(1)]}/encoder/layer_{m.group(2)}/{sub}/"
                f"{(lin if kind == 'linear' else ln)[leaf]}")
    if module == "decoder.embeddings.LayerNorm":
        return f"decoder/embed_ln/{ln[leaf]}"
    m = re.match(r"^decoder\.decoder\.layer\.(\d+)\.(.+)$", module)
    if m and m.group(2) in _DECODER_BLOCK:
        sub, kind = _DECODER_BLOCK[m.group(2)]
        return f"decoder/layer_{m.group(1)}/{sub}/{(lin if kind == 'linear' else ln)[leaf]}"
    m = re.match(r"^decoder\.classifier\.cls\.predictions\.transform\.(dense|LayerNorm)$",
                 module)
    if m:
        sub, kind = ("dense", lin) if m.group(1) == "dense" else ("ln", ln)
        return f"decoder/classifier_transform/{sub}/{kind[leaf]}"
    m = re.match(r"^(cls|cls_visual)\.predictions\.transform\.(dense|LayerNorm)$", module)
    if m:
        sub, kind = ("dense", lin) if m.group(2) == "dense" else ("ln", ln)
        return f"{_JAX_HEADS[m.group(1)]}/transform/{sub}/{kind[leaf]}"
    if module in ("cross.pooler.dense", "similarity_dense"):
        return f"{module.replace('.', '/')}/{lin[leaf]}"
    if module == "normalize_video.visual_norm2d":
        return f"video_norm/{ln[leaf]}"
    raise ValueError(f"unrecognized port parameter name: {name}")


def sort_reference_names(names) -> Dict[str, list]:
    """The names of a reference ``.bin`` as JAX's ``convert_torch_state_dict``
    reports them (gamma/beta read as weight/bias): ``skipped`` the tied
    duplicates and the text and visual poolers, ``converted`` a name with a
    JAX path, ``unknown`` the rest."""
    out = {"converted": [], "skipped": [], "unknown": []}
    for name in names:
        k = name.replace("gamma", "weight").replace("beta", "bias")
        if k in _TIED or _TORCH_NOT_OWNED.match(k):
            out["skipped"].append(k)
            continue
        try:
            jax_path(k)
            out["converted"].append(k)
        except ValueError:
            out["unknown"].append(k)
    return out


def load_reference_bin(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.bin`` state dict, with gamma/beta renamed to
    weight/bias and the keys the port does not own dropped. The tied
    duplicates are checked equal to the tables they repeat, then dropped:
    the port holds each table once."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        k = k.replace("gamma", "weight").replace("beta", "bias")
        if not _TORCH_NOT_OWNED.match(k):
            out[k] = v.float()
    for dup, src in _TIED.items():
        if dup in out:
            v = out.pop(dup)
            if src in out and not torch.equal(v, out[src]):
                raise ValueError(f"{path}: {dup} differs from the {src} it is tied to")
    return out


def init_state_dict(cfg: UniVLConfig, seed: int) -> Dict[str, torch.Tensor]:
    """The JAX initializers, drawn with numpy: normal(0, initializer_range)
    for weights and tables, zero biases, LayerNorm ones and zeros."""
    from univl_tpu_torch.models.univl import UniVL

    rng = np.random.RandomState(seed)
    shapes = UniVL(cfg, device="meta").state_dict()
    std = {"bert": cfg.bert, "visual": cfg.visual, "cross": cfg.cross, "decoder": cfg.decoder,
           "cls_visual": cfg.visual}
    sd = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        if name.endswith(".bias"):
            v = np.zeros(shape, np.float32)
        elif name.endswith(("LayerNorm.weight", "visual_norm2d.weight")):
            v = np.ones(shape, np.float32)
        else:
            r = std.get(name.split(".")[0], cfg.bert).initializer_range
            v = rng.normal(0.0, r, shape).astype(np.float32)
        sd[name] = torch.from_numpy(v)
    return sd
