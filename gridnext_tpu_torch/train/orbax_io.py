"""orbax checkpoints of a TrainState, read and written without orbax or
tensorstore (the JAX package's ``train/orbax_io.py``).

A checkpoint directory holds what orbax's ``StandardCheckpointer`` writes:

* an OCDBT database of zarr v2 arrays (:mod:`gridnext_tpu_torch.io.ocdbt`),
  one array per leaf, named by its tree path joined with '.'
  (``params.corrector.HexConv_0.kernel``, ``step``);
* ``_METADATA``: each path's keys and ``value_type`` ('jax.Array' with its
  ``write_shape``, 'np.ndarray' for ``step``, 'None' for optax's
  ``EmptyState`` / ``MaskedNode`` and ``batch_stats=None``, 'Dict' for an
  empty ``extra_vars``), plus ``use_ocdbt`` and ``use_zarr3``;
* ``_CHECKPOINT_METADATA``, ``_sharding`` (base64 leaf names to
  ``SingleDeviceSharding`` JSON) and ``array_metadatas/process_0``.

The tree is the msgpack route's (:func:`loops._payload_tree`): ``params``,
``batch_stats``, ``extra_vars``, ``opt_state`` (optax's state-dict layout,
a digit key standing for a tuple index) and ``step``. A restore maps
'None' and empty entries to what the msgpack route gives them (``{}``;
``batch_stats`` None) and loads through ``load_variables`` and
``Optimizer.load_state_tree``, so every tensor lands on its template's
device and dtype. Directories written by orbax with ``use_ocdbt`` false
(one zarr directory per array) are read too; ``use_zarr3`` is refused.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from gridnext_tpu_torch.io import ocdbt
from gridnext_tpu_torch.train.loops import (TrainState, _host_tree, _payload_tree,
                                            _state_from_payload)

_ARRAY_TYPES = ("jax.Array", "np.ndarray")
_EMPTY_TYPES = ("None", "Dict", "Tuple")      # optax's empty states, masked leaves
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})


# -- writing ---------------------------------------------------------------------


def _leaves(tree, path=()):
    """``(path, value)`` of every leaf in flatten order (dict keys sorted);
    an empty dict or None is a leaf of its own."""
    if isinstance(tree, dict) and tree:
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _value_metadata(path, value) -> dict:
    if value is None or isinstance(value, dict):
        # optax's empty states and masked leaves are None to orbax; a top-level
        # empty collection is an empty Dict
        kind = "Dict" if isinstance(value, dict) and len(path) == 1 else "None"
        return {"value_type": kind, "skip_deserialize": True}
    if path == ("step",):
        return {"value_type": "np.ndarray", "skip_deserialize": False}
    return {"value_type": "jax.Array", "skip_deserialize": False,
            "write_shape": list(np.shape(value))}


def _key_metadata(path) -> list:
    # a digit key inside opt_state is a tuple index (key_type 1, a sequence)
    return [{"key": k, "key_type": 1 if path[0] == "opt_state" and k.isdigit() else 2}
            for k in path]


def _write_dir(directory: str, payload: dict, started: int) -> None:
    """Write a host payload tree as orbax's files under a fresh directory."""
    os.makedirs(os.path.join(directory, "array_metadatas"))
    items, tree_meta, arrays = {}, {}, []
    for path, value in _leaves(payload):
        meta = _value_metadata(path, value)
        if not meta["skip_deserialize"]:
            name = ".".join(path)
            items.update(ocdbt.zarr_items(name, np.asarray(value)))
            if meta["value_type"] == "jax.Array":
                arrays.append((name, meta["write_shape"]))
        tree_meta[str(path)] = {"key_metadata": _key_metadata(path), "value_metadata": meta}
    ocdbt.write_store(directory, items)
    arrays.sort()
    files = {
        "_METADATA": {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                      "store_array_data_equal_to_fill_value": True, "custom_metadata": None},
        "_sharding": {base64.b64encode(n.encode()).decode(): _SHARDING for n, _ in arrays},
        os.path.join("array_metadatas", "process_0"): {"array_metadatas": [
            {"array_metadata": {"param_name": n, "write_shape": s, "chunk_shape": s,
                                "ext_metadata": None}} for n, s in arrays]},
    }
    for name, obj in files.items():
        with open(os.path.join(directory, name), "w") as fh:
            json.dump(obj, fh)
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w") as fh:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, fh)


class _SwappingCheckpointer:
    """Async-save handle: the write runs on a background thread;
    ``wait_until_finished()`` joins it, re-raises its failure, and swaps the
    finished directory into place (once)."""

    def __init__(self, thread: threading.Thread, errors: list, swap):
        self._thread, self._errors, self._swap = thread, errors, swap
        self._swapped = False

    def wait_until_finished(self):
        self._thread.join()
        if self._errors:
            raise self._errors[0]
        if not self._swapped:
            self._swap()
            self._swapped = True

    def close(self):
        self.wait_until_finished()


def save_checkpoint_orbax(path, state: TrainState, *, block: bool = True
                          ) -> Optional[_SwappingCheckpointer]:
    """Write ``state`` to the directory ``path`` in orbax's layout.

    Overwrites replace atomically, as the JAX package's do: the checkpoint is
    written to ``{path}.tmp-{pid}`` and renamed over ``path`` only once
    complete. The state is copied on its device when this is called, so the
    files hold the state at the call whatever steps follow. ``block=False``
    writes on a background thread and returns a handle whose
    ``wait_until_finished()`` (which performs the swap) and ``close()`` the
    caller must call before relying on the files; ``block=True`` returns
    None with everything on disk.
    """
    started = time.time_ns()
    payload = _payload_tree(state)
    event = None
    dev = next((p.device for p in state.model.parameters()), torch.device("cpu"))
    if dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    payload["step"] = np.asarray(int(state.step), np.int32)
    final = os.path.abspath(str(path))
    tmp = f"{final}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):              # leftover from a killed earlier attempt
        shutil.rmtree(tmp)

    def write():
        if event is not None:
            event.synchronize()
        _write_dir(tmp, _host_tree(payload), started)

    def swap():
        old = f"{final}.old-{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(final):
            os.rename(final, old)
        os.rename(tmp, final)
        if os.path.isdir(old):
            shutil.rmtree(old)

    if block:
        write()
        swap()
        return None
    errors: list = []

    def run():
        try:
            write()
        except BaseException as e:      # re-raised by wait_until_finished()
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return _SwappingCheckpointer(thread, errors, swap)


# -- reading ---------------------------------------------------------------------


def _getter(directory: str, use_ocdbt: bool):
    if use_ocdbt:
        return ocdbt.read_store(directory).get

    def get(key):
        full = os.path.join(directory, *key.split("/"))
        if not os.path.isfile(full):
            return None
        with open(full, "rb") as fh:
            return fh.read()
    return get


def read_checkpoint_orbax(path) -> dict:
    """The payload tree of an orbax checkpoint directory, as numpy arrays:
    ``{"params", "batch_stats", "extra_vars", "opt_state", "step"}`` in the
    msgpack route's layout."""
    directory = os.path.abspath(str(path))
    where = os.path.join(directory, "_METADATA")
    if not os.path.isfile(where):
        raise ValueError(f"{where}: missing; {directory} is not an orbax checkpoint")
    with open(where) as fh:
        meta = json.load(fh)
    if meta.get("use_zarr3"):
        raise ValueError(f"{where}: use_zarr3 true is refused (zarr v2 arrays are read)")
    get = _getter(directory, meta.get("use_ocdbt", False))
    payload: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value_meta = entry["value_metadata"]
        kind = value_meta.get("value_type")
        if kind in _ARRAY_TYPES and not value_meta.get("skip_deserialize"):
            value = ocdbt.read_zarr(get, ".".join(keys), directory)
        elif kind in _EMPTY_TYPES:
            value = None if keys == ["batch_stats"] else {}
        else:
            raise ValueError(f"{where}: {'.'.join(keys)} has value_type {kind!r}, which is "
                             f"refused ({', '.join(_ARRAY_TYPES + _EMPTY_TYPES)} are read)")
        node = payload
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    if "step" in payload:
        payload["step"] = int(payload["step"])
    return payload


def restore_checkpoint_orbax(path, state_template: TrainState) -> TrainState:
    """Load a checkpoint that either package's ``save_checkpoint_orbax``
    wrote into ``state_template`` (a freshly created state for the same
    model and optimiser, on the device the restored state should live on)
    and return it."""
    return _state_from_payload(read_checkpoint_orbax(path), state_template)
