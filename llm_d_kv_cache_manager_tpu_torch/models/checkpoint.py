"""Model checkpoint and resume over ``torch.distributed.checkpoint``.

Port of the reference's ``models/checkpoint.py`` (orbax).  A state is a
nested dict whose leaves are tensors or plain Python values: a params
tree, an optimizer's ``state_dict()`` (its ``param_groups`` hold Python
numbers, tuples and lists), or a dict of both.  Tensors are written in
their own dtype, bf16 included, and restored bit for bit.

Restoring onto another device goes through :func:`abstract_like`:
empty tensors of each leaf's shape and dtype on the target device, which
:func:`restore_checkpoint` fills in place.  Without a process group the
checkpoint is written and read by this one process.
"""

from __future__ import annotations

import contextlib
import copy
import os
import warnings
from typing import Any, Optional, Union

import torch
import torch.distributed.checkpoint as dcp

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
    return state


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
    to restore onto) is filled IN PLACE, tensors keeping their device,
    and returned.  With None, the state comes back as CPU tensors in the
    dtypes it was saved in, every dict key as a string (an optimizer's
    ``state`` is keyed by int: restore that into a target)."""
    path = os.path.abspath(path)
    with _quiet():
        if target is not None:
            dcp.load(target, checkpoint_id=path)
            return target
        metadata = dcp.FileSystemReader(path).read_metadata()
        flat = {}
        for key, meta in metadata.state_dict_metadata.items():
            if isinstance(meta, dcp.metadata.TensorStorageMetadata):
                flat[key] = torch.empty(meta.size, dtype=meta.properties.dtype)
            else:
                flat[key] = None  # a Python value, read back as itself
        dcp.load(flat, checkpoint_id=path)
    return _unflatten(flat, metadata.planner_data)


def abstract_like(state: Any, device: Optional[Union[str, torch.device]] = None) -> Any:
    """The restore target for ``state``: an empty tensor of each tensor
    leaf's shape and dtype, on ``device`` (None: the leaf's own), and a
    copy of every other leaf (restore overwrites it with the saved
    value)."""
    if isinstance(state, dict):
        return {key: abstract_like(value, device) for key, value in state.items()}
    if isinstance(state, torch.Tensor):
        return torch.empty(state.shape, dtype=state.dtype,
                           device=state.device if device is None else device)
    return copy.deepcopy(state)
