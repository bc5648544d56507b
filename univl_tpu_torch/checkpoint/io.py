"""Train-state checkpoints of the port, and reading the JAX package's flax
params files.

The port's counterpart of ``univl_tpu/checkpoint/io.py``. A checkpoint is a
``torch.save`` file of a dict of state dicts (the trainers write
``{"model": ..., "optimizer": ...}``: the parameters under the reference
names, and BertAdam's moments with its step count) beside a JSON sidecar at
``path + ".json"`` with JAX's keys (``epoch``, ``global_step``,
``in_epoch_step``, ``preempted``, ``best``, ``best_score``). The trainers
name theirs ``train_state.pt``: JAX's ``train_state.msgpack`` holds optax
state, which has no torch counterpart, so the two packages' train states do
not cross over. Weights do: ``pytorch_model.bin.<epoch>`` through both
packages' ``--init_model``, and a flax ``params.msgpack.<epoch>`` or
``best.msgpack`` through ``read_flax_params`` and
``checkpoint/convert.py:state_dict_from_jax_params``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

TRAIN_STATE = "train_state.pt"

# flax.serialization's msgpack extension types
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def save_checkpoint(path: str, state: Mapping[str, Any],
                    metadata: Optional[Dict] = None) -> str:
    """``state`` (a dict of state dicts) to ``path`` and ``metadata`` to
    ``path + ".json"``, each written to a temporary file first and renamed,
    so a kill during the write leaves the previous checkpoint whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(dict(state), tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(tmp, "w") as f:
            json.dump(metadata, f)
        os.replace(tmp, path + ".json")
    return path


def read_metadata(path: str) -> Optional[Dict]:
    """The JSON sidecar of ``path``, or None without one."""
    if not os.path.exists(path + ".json"):
        return None
    with open(path + ".json") as f:
        return json.load(f)


def restore_checkpoint(path: str, template: Optional[Mapping[str, torch.Tensor]] = None,
                       partial: bool = False):
    """(state, metadata): the saved dict, its tensors on the CPU. With
    ``partial``, ``path`` holds one state dict and ``template`` is a model's
    (the seeded init): the saved tensors are laid over it and (merged,
    metadata, missing names) come back, the names the file lacks left at the
    template's values (a stage-II model from a stage-I file)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    meta = read_metadata(path)
    if not partial:
        return state, meta
    merged, missing = merge_state_dict(template, state, path)
    return merged, meta, missing


def merge_state_dict(template: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor],
                     source: str):
    """(``loaded`` laid over ``template``, the names left at the template's
    values); a name the template lacks is an error that names ``source``."""
    unknown = sorted(set(loaded) - set(template))
    if unknown:
        raise ValueError(f"{source}: keys the model does not have: {unknown[:20]}")
    return {**template, **loaded}, sorted(set(template) - set(loaded))


def read_flax_params(path: str) -> Dict:
    """A flax ``serialization.to_bytes`` file (``params.msgpack.<epoch>``,
    ``best.msgpack``) as nested dicts of numpy arrays: flax's ndarray and
    scalar extension types decoded, its chunked arrays joined."""
    import msgpack

    def ext_hook(code, data):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = msgpack.unpackb(data, raw=True)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
            return arr if code == _EXT_NDARRAY else arr[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def _unchunk(tree):
    """flax writes an array over 1 GiB as ``{"__msgpack_chunked_array__",
    "shape": {"0": ...}, "chunks": {"0": ...}}``."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}
