"""Model checkpoint and resume over ``torch.distributed.checkpoint``.

Port of the reference's ``models/checkpoint.py`` (orbax).  A state is a
nested dict whose leaves are tensors or plain Python values: a params
tree, an optimizer's ``state_dict()`` (its ``param_groups`` hold Python
numbers, tuples and lists), or a dict of both.  Tensors are written in
their own dtype, bf16 included, and restored bit for bit.

Restoring onto another device goes through :func:`abstract_like`:
empty tensors of each leaf's shape and dtype on the target device, which
:func:`restore_checkpoint` fills in place.  Restoring onto a sharded
layout, as the reference's ``abstract_like(state, shardings)``: given a
tree of ``parallel.sharding.NamedSharding`` (e.g. of
``llama.param_pspecs`` over a mesh) the targets are
``parallel.sharding.Sharded`` leaves, and every local tensor is filled
with its slice of the saved tensor.  A sharded state is saved whole.
Without a process group the checkpoint is written and read by this one
process.
"""

from __future__ import annotations

import contextlib
import copy
import os
import warnings
from typing import Any, Optional, Union

import torch
import torch.distributed.checkpoint as dcp

from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import (
    NamedSharding,
    Sharded,
    empty,
    unshard,
)

# What torch.distributed.checkpoint says when no process group is up
# (the single-process save and load this module makes on purpose) and
# when a save replaces a checkpoint (as save_checkpoint documents).
_EXPECTED = (
    "torch.distributed is disabled, unavailable or uninitialized",
    "Detected an existing checkpoint",
)


@contextlib.contextmanager
def _quiet():
    """Keep those warnings out of every caller's output, as the
    reference keeps orbax's restore warning out."""
    with warnings.catch_warnings():
        for message in _EXPECTED:
            warnings.filterwarnings("ignore", message=message, category=UserWarning)
        yield


def _detached(state: Any) -> Any:
    if isinstance(state, dict):
        return {key: _detached(value) for key, value in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach()
    if isinstance(state, Sharded):
        return unshard(state, "cpu")
    return state


def _staged(target: Any) -> Any:
    """``target`` with each sharded leaf replaced by a host tensor of its
    global shape, which ``dcp.load`` can fill."""
    if isinstance(target, dict):
        return {key: _staged(value) for key, value in target.items()}
    if isinstance(target, Sharded):
        return torch.empty(target.shape, dtype=target.dtype)
    return target


def _fill(target: Any, staged: Any) -> Any:
    """Copy each staged tensor's slices into its sharded leaf's locals;
    take every other loaded leaf as it is, into ``target``'s own dicts."""
    if isinstance(target, dict):
        for key, value in target.items():
            target[key] = _fill(value, staged[key])
        return target
    if isinstance(target, Sharded):
        with torch.no_grad():
            for coord, tensor in target.distinct():
                tensor.copy_(staged[target.slices(target.shard_index(coord))])
        return target
    return staged


def save_checkpoint(path: str, state: Any) -> str:
    """Write ``state`` (a nested dict of tensors and Python values) as a
    checkpoint directory at ``path``, over any checkpoint already
    there.  Returns the absolute path."""
    path = os.path.abspath(path)
    with _quiet():
        dcp.save(_detached(state), storage_writer=dcp.FileSystemWriter(path, overwrite=True))
    return path


def _unflatten(flat: dict, mappings: dict) -> Any:
    """The nested state of a flattened one, from its key paths.  In a
    path a dict key is a string and a list index an int, so a node whose
    keys are all ints was a list."""
    state: dict = {}
    for key, value in flat.items():
        path = mappings[key]
        node = state
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [rebuild(node[i]) for i in range(len(node))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(state)


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Read a checkpoint written by :func:`save_checkpoint`.

    ``target`` (e.g. :func:`abstract_like` of the state, on the device
    or the sharded layout to restore onto) is filled IN PLACE, tensors
    keeping their device, and returned; a sharded leaf is read whole
    into host memory and each local gets its slice.  With None, the
    state comes back as CPU tensors in the dtypes it was saved in, every
    dict key as a string (an optimizer's ``state`` is keyed by int:
    restore that into a target)."""
    path = os.path.abspath(path)
    with _quiet():
        if target is not None:
            staged = _staged(target)
            dcp.load(staged, checkpoint_id=path)
            return _fill(target, staged)
        metadata = dcp.FileSystemReader(path).read_metadata()
        flat = {}
        for key, meta in metadata.state_dict_metadata.items():
            if isinstance(meta, dcp.metadata.TensorStorageMetadata):
                flat[key] = torch.empty(meta.size, dtype=meta.properties.dtype)
            else:
                flat[key] = None  # a Python value, read back as itself
        dcp.load(flat, checkpoint_id=path)
    return _unflatten(flat, metadata.planner_data)


def abstract_like(state: Any, shardings: Optional[Any] = None,
                  device: Optional[Union[str, torch.device]] = None) -> Any:
    """The restore target for ``state``: an empty tensor of each tensor
    leaf's shape and dtype, on ``device`` (None: the leaf's own), and a
    copy of every other leaf (restore overwrites it with the saved
    value).  ``shardings``, a tree of ``NamedSharding`` shaped like
    ``state`` (or like one of its subtrees' keys), makes each tensor leaf
    it covers an empty ``Sharded`` of that layout instead; a sharded
    leaf of ``state`` keeps its own layout."""
    if isinstance(shardings, NamedSharding):
        return empty(tuple(state.shape), state.dtype, shardings.mesh, shardings.spec)
    if isinstance(state, dict):
        sub = shardings if isinstance(shardings, dict) else {}
        return {key: abstract_like(value, sub.get(key), device) for key, value in state.items()}
    if isinstance(state, Sharded):
        return empty(state.shape, state.dtype, state.mesh, state.spec)
    if isinstance(state, torch.Tensor):
        return torch.empty(state.shape, dtype=state.dtype,
                           device=state.device if device is None else device)
    return copy.deepcopy(state)
