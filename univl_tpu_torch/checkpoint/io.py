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
``checkpoint/convert.py:state_dict_from_jax_params``; ``write_flax_params``
writes such a file (``cli/convert_checkpoint.py``).

``CheckpointWriter`` saves synchronously, or with ``async_save`` copies the
state to the host and writes it on a background thread
(``univl_tpu/checkpoint/manager.py:60-128``'s async orbax saves).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Mapping, Optional

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


def host_copy(state):
    """``state`` with every tensor copied to the host (a synchronous copy
    from the device; a CPU tensor cloned), so that the copy is complete when
    this returns and the optimizer may update the parameters in place."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, Mapping):
        return {k: host_copy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(host_copy(v) for v in state)
    return state


class CheckpointWriter:
    """Checkpoint writes, synchronous or (``async_save``) on one background
    thread. An asynchronous ``save`` first waits for the write in flight,
    then takes ``host_copy`` of the state and returns, the write going on
    through ``save_checkpoint``'s temporary file and rename. ``wait`` blocks
    until the write in flight is on disk; a write that failed raises there
    (or at the next ``save``), never silently. Under data parallelism every
    rank calls ``save`` and only the ``primary`` writer (rank 0) writes, as
    JAX's ``save_checkpoint`` writes on ``process_index() == 0`` alone; the
    caller gathers any sharded state before and holds a barrier after."""

    def __init__(self, async_save: bool = False, primary: bool = True):
        self.async_save = async_save
        self.primary = primary
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, write: Callable, state: Mapping[str, Any], *args) -> None:
        """``write(state, *args)``, now or on the writer thread with the
        host copy of ``state``."""
        self.wait()
        if not self.primary:
            return
        if not self.async_save:
            write(state, *args)
            return
        state = host_copy(state)

        def run():
            try:
                write(state, *args)
            except BaseException as e:  # raised by the next wait
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint_writer")
        self._thread.start()

    def save(self, path: str, state: Mapping[str, Any], metadata: Optional[Dict] = None) -> None:
        self.submit(lambda st: save_checkpoint(path, st, metadata), state)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint write failed") from err


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


# flax.serialization.MAX_CHUNK_SIZE: an array of more bytes is written in chunks
MAX_CHUNK_SIZE = 2**30


def _chunk(arr: np.ndarray):
    """flax's ``_chunk``: the flat array in pieces of at most MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j: j + size]
                       for i, j in enumerate(range(0, flat.size, size))}}


def write_flax_params(path: str, tree: Mapping) -> str:
    """Nested dicts of numpy arrays to ``path`` as flax's
    ``serialization.to_bytes`` writes them (what ``read_flax_params`` and
    flax's ``msgpack_restore`` read): arrays over MAX_CHUNK_SIZE bytes
    chunked, each array as the ndarray extension (shape, dtype name, C-order
    bytes), numpy scalars as the scalar one. Temporary file, then rename."""
    import msgpack

    def chunked(node):
        if isinstance(node, Mapping):
            return {k: chunked(v) for k, v in node.items()}
        if isinstance(node, np.ndarray) and node.size * node.dtype.itemsize > MAX_CHUNK_SIZE:
            return _chunk(node)
        return node

    def ext(obj):
        if isinstance(obj, (np.ndarray, np.generic)):
            arr = np.asarray(obj)
            data = msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                                 use_bin_type=True)
            return msgpack.ExtType(_EXT_NDARRAY if isinstance(obj, np.ndarray)
                                   else _EXT_NPSCALAR, data)
        return obj

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(chunked(tree), default=ext, strict_types=True))
    os.replace(tmp, path)
    return path


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
