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
with its slice of the saved tensor.  Without a process group the
checkpoint is written and read by this one process, a sharded state
saved whole.

Across processes, as orbax does per host: a state whose ``Sharded``
leaves lie on a mesh of several processes (``make_hybrid_mesh``) is
saved through the default process group, every process writing only
the slices it is the first holder of, each slice in pieces of at most
``PIECE_BYTES`` along its first axis; a ``Sharded`` target on such a
mesh reads only the pieces that overlap this process's slices, and no
process builds a tensor of a leaf's global shape.  DCP's planner maps
saved pieces onto any target layout, so a state saved on one layout
restores onto another, on one process or on several.

An optimizer's ``state_dict()`` is keyed by its local parameter
indices, which differ between processes and layouts: save AdamW's state
as :func:`optimizer_state_tree` lays it out, its moments mirroring the
params (as optax's state mirrors them in the reference), and restore it
into :func:`optimizer_state_like` of the target params, then
:func:`load_optimizer_state_tree`.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.default_planner import (
    DefaultLoadPlanner,
    DefaultSavePlanner,
    create_default_local_load_plan,
)
from torch.distributed.checkpoint.metadata import (
    ChunkStorageMetadata,
    MetadataIndex,
    TensorProperties,
)
from torch.distributed.checkpoint.planner import (
    LoadPlan,
    SavePlan,
    TensorWriteData,
    WriteItem,
    WriteItemType,
)
from torch.distributed.checkpoint.planner_helpers import create_read_items_for_chunk_list

from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import (
    NamedSharding,
    Sharded,
    distinct_locals,
    empty,
    unshard,
)

# The largest piece of a slice that a save across processes writes as
# one item: what a restore reads, and holds on the host, at once.
PIECE_BYTES = 64 << 20

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


class _Pieces:
    """A sharded leaf's pieces in this process, by their offsets in the
    global tensor: the ones it writes (a save) or the first local copy
    of each of its slices (a restore, which fills them in place)."""

    def __init__(self, shape: Tuple[int, ...], pieces: Dict[Tuple[int, ...], torch.Tensor]):
        self.shape, self.pieces = tuple(shape), pieces

    def chunks(self) -> List[ChunkStorageMetadata]:
        return [ChunkStorageMetadata(offsets=torch.Size(o), sizes=t.size())
                for o, t in self.pieces.items()]


def _across(leaf: Any) -> bool:
    return isinstance(leaf, Sharded) and leaf.mesh.multi_process


def _offsets(leaf: Sharded, coord: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(s.start for s in leaf.slices(leaf.shard_index(coord)))


def _written(leaf: Sharded) -> _Pieces:
    """The pieces this process writes of ``leaf``: each slice whose first
    holder (in coordinate order) is one of its ranks, cut along its
    first axis into pieces of at most ``PIECE_BYTES``."""
    first: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
    for coord in np.ndindex(leaf.mesh.devices.shape):
        first.setdefault(leaf.shard_index(coord), coord)
    pieces = {}
    for coord in first.values():
        if not leaf.mesh.is_local(coord):
            continue
        tensor, start = leaf.locals[coord].detach(), _offsets(leaf, coord)
        if tensor.dim() == 0:
            pieces[start] = tensor
            continue
        rows = max(1, PIECE_BYTES // max(1, tensor[0].numel() * tensor.element_size()))
        for a in range(0, tensor.shape[0], rows):
            pieces[(start[0] + a,) + start[1:]] = tensor[a:a + rows]
    return _Pieces(leaf.shape, pieces)


def _detached(state: Any) -> Any:
    if isinstance(state, dict):
        return {key: _detached(value) for key, value in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach()
    if _across(state):
        return _written(state)
    if isinstance(state, Sharded):
        return unshard(state, "cpu")
    return state


def _staged(target: Any) -> Any:
    """``target`` with each sharded leaf replaced by what ``dcp.load``
    fills: across processes the first local copy of each of this
    process's slices (:class:`_Pieces`); on one process a host tensor of
    its global shape."""
    if isinstance(target, dict):
        return {key: _staged(value) for key, value in target.items()}
    if _across(target):
        pieces = {}
        for coord, tensor in target.distinct():
            pieces.setdefault(_offsets(target, coord), tensor)
        return _Pieces(target.shape, pieces)
    if isinstance(target, Sharded):
        return torch.empty(target.shape, dtype=target.dtype)
    return target


def _fill(target: Any, staged: Any) -> Any:
    """Copy each staged tensor's slices into its sharded leaf's locals
    (each read piece into the slice's other local copies); take every
    other loaded leaf as it is, into ``target``'s own dicts."""
    if isinstance(target, dict):
        for key, value in target.items():
            target[key] = _fill(value, staged[key])
        return target
    if isinstance(target, Sharded):
        with torch.no_grad():
            for coord, tensor in target.distinct():
                if isinstance(staged, _Pieces):
                    read = staged.pieces[_offsets(target, coord)]
                    if read is not tensor:
                        tensor.copy_(read)
                else:
                    tensor.copy_(staged[target.slices(target.shard_index(coord))])
        return target
    return staged


def _item_bytes(sizes, dtype: torch.dtype) -> int:
    return math.prod(sizes) * torch.empty((), dtype=dtype).element_size()


class _SavePlanner(DefaultSavePlanner):
    """DCP's default save planner, with each :class:`_Pieces` leaf
    written as shards of its global tensor; ``bytes`` is what this
    process writes."""

    def create_local_plan(self) -> SavePlan:
        mine = {k: v for k, v in self.state_dict.items() if isinstance(v, _Pieces)}
        everything = self.state_dict
        self.state_dict = {k: v for k, v in everything.items() if k not in mine}
        try:
            plan = super().create_local_plan()
        finally:
            self.state_dict = everything
        items = [WriteItem(index=MetadataIndex(fqn, offsets), type=WriteItemType.SHARD,
                           tensor_data=TensorWriteData(
                               chunk=ChunkStorageMetadata(offsets=torch.Size(offsets),
                                                          sizes=piece.size()),
                               properties=TensorProperties.create_from_tensor(piece),
                               size=torch.Size(pieces.shape)))
                 for fqn, pieces in mine.items() for offsets, piece in pieces.pieces.items()]
        self.plan = SavePlan(plan.items + items, plan.storage_data, plan.planner_data)
        return self.plan

    def finish_plan(self, new_plan: SavePlan) -> SavePlan:
        plan = super().finish_plan(new_plan)
        self.bytes = sum(_item_bytes(item.tensor_data.chunk.sizes, item.tensor_data.properties.dtype)
                         for item in plan.items if item.tensor_data is not None)
        return plan

    def lookup_object(self, index: MetadataIndex) -> Any:
        obj = self.state_dict[index.fqn]
        if isinstance(obj, _Pieces):
            return obj.pieces[tuple(index.offset)]
        return super().lookup_object(index)


class _LoadPlanner(DefaultLoadPlanner):
    """DCP's default load planner, with each :class:`_Pieces` leaf read
    from the saved chunks that overlap its pieces and nothing else;
    ``bytes`` is what this process's plan reads."""

    def set_up_planner(self, state_dict, metadata=None, is_coordinator: bool = False) -> None:
        # The default set-up replaces every leaf it does not know with
        # None: put the pieces back, nested and flattened.
        pieces = dict(_pieces_at(state_dict))
        super().set_up_planner(state_dict, metadata, is_coordinator)
        for path, obj in pieces.items():
            node = state_dict
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = obj
            self.state_dict[".".join(path)] = obj

    def create_local_plan(self) -> LoadPlan:
        mine = {k: v for k, v in self.state_dict.items() if isinstance(v, _Pieces)}
        plan = create_default_local_load_plan(
            {k: v for k, v in self.state_dict.items() if k not in mine}, self.metadata,
            not self.allow_partial_load)
        items = list(plan.items)
        for fqn, pieces in mine.items():
            md = self.metadata.state_dict_metadata.get(fqn)
            if md is None:
                raise RuntimeError(f"Missing key in checkpoint state_dict: {fqn}.")
            if tuple(md.size) != pieces.shape:
                raise ValueError(f"Size mismatch between saved {tuple(md.size)} and current: "
                                 f"{pieces.shape} for {fqn}")
            items += create_read_items_for_chunk_list(fqn, md, pieces.chunks())
        meta = self.metadata.state_dict_metadata
        self.bytes = sum(_item_bytes(item.lengths, meta[item.storage_index.fqn].properties.dtype)
                         for item in items if hasattr(meta[item.storage_index.fqn], "chunks"))
        return LoadPlan(items)

    def lookup_tensor(self, index: MetadataIndex) -> torch.Tensor:
        obj = self.state_dict.get(index.fqn)
        if isinstance(obj, _Pieces):
            return obj.pieces[tuple(index.offset)]
        return super().lookup_tensor(index)


def _pieces_at(tree: dict, path: Tuple[str, ...] = ()):
    """(key path, :class:`_Pieces`) of every such leaf of a nested dict."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _pieces_at(value, path + (key,))
        elif isinstance(value, _Pieces):
            yield path + (key,), value


def save_checkpoint(path: str, state: Any, force: bool = True,
                    report: Optional[dict] = None) -> str:
    """Write ``state`` (a nested dict of tensors and Python values) as a
    checkpoint directory at ``path``, over any checkpoint already there
    (``force=False``: refuse one with the reference's ``ValueError``).
    Returns the absolute path.  Where the state's sharded leaves lie on
    a mesh of several processes, every process of the default group
    calls it and writes only its own slices.  ``report``, a dict, gets
    ``bytes``: the tensor bytes this process wrote."""
    path = os.path.abspath(path)
    if not force:
        exists = os.path.exists(path)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()  # every process looks before any of them writes
        if exists:
            raise ValueError(f"Destination {path} already exists.")
    planner = _SavePlanner()
    with _quiet():
        dcp.save(_detached(state), storage_writer=dcp.FileSystemWriter(path, overwrite=True),
                 planner=planner)
    if report is not None:
        report["bytes"] = planner.bytes
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


def restore_checkpoint(path: str, target: Optional[Any] = None,
                       report: Optional[dict] = None) -> Any:
    """Read a checkpoint written by :func:`save_checkpoint`.

    ``target`` (e.g. :func:`abstract_like` of the state, on the device
    or the sharded layout to restore onto) is filled IN PLACE, tensors
    keeping their device, and returned.  A sharded leaf on a mesh of one
    process is read whole into host memory and each local gets its
    slice; on a mesh of several processes, whose every process calls
    this, each reads only the saved pieces that overlap its own slices.
    ``report``, a dict, gets ``bytes``: the tensor bytes this process's
    read plan asks for.  With None, the state comes back as CPU tensors
    in the dtypes it was saved in, every dict key as a string (an
    optimizer's ``state`` is keyed by int: restore that into a
    target)."""
    path = os.path.abspath(path)
    with _quiet():
        if target is not None:
            staged = _staged(target)
            planner = _LoadPlanner()
            dcp.load(staged, checkpoint_id=path, planner=planner)
            if report is not None:
                report["bytes"] = planner.bytes
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


def optimizer_state_tree(optimizer: torch.optim.Optimizer, params: Any) -> dict:
    """AdamW's state (``llama.make_optimizer``, which steps every distinct
    local tensor of ``params``) laid out as ``params``: ``exp_avg`` and
    ``exp_avg_sq`` trees shaped as ``params`` (a ``Sharded`` leaf's
    moments a ``Sharded`` over its mesh and spec, each local the moment
    of the param local there), the ``step`` and the param group's
    settings (``hyper``).  It saves and restores onto any layout, as the
    params do."""
    def moment(node, key):
        if isinstance(node, dict):
            return {k: moment(v, key) for k, v in node.items()}
        if not isinstance(node, Sharded):
            return _adam_state(optimizer, node)[key]
        locals_ = np.empty(node.locals.shape, dtype=object)
        for coord, tensor in np.ndenumerate(node.locals):
            if tensor is not None:
                locals_[coord] = _adam_state(optimizer, tensor)[key]
        value = next(t for t in locals_.flat if t is not None)
        return Sharded(node.mesh, node.spec, node.shape, value.dtype, locals_)

    first = distinct_locals(params)[0]
    return {"step": _adam_state(optimizer, first)["step"], "exp_avg": moment(params, "exp_avg"),
            "exp_avg_sq": moment(params, "exp_avg_sq"), "hyper": _hyper(optimizer)}


def optimizer_state_like(optimizer: torch.optim.Optimizer, params: Any) -> dict:
    """The restore target of an :func:`optimizer_state_tree` for
    ``optimizer`` (fresh, from ``make_optimizer(params)``) over
    ``params`` on any layout: empty moments laid out as ``params``, a
    step, and the group's settings (overwritten by the saved ones)."""
    return {"step": torch.zeros((), dtype=torch.float32),
            "exp_avg": abstract_like(params), "exp_avg_sq": abstract_like(params),
            "hyper": _hyper(optimizer)}


def load_optimizer_state_tree(optimizer: torch.optim.Optimizer, params: Any, tree: dict) -> None:
    """Give ``optimizer`` (over ``params``' distinct locals) the state of
    ``tree`` (:func:`optimizer_state_tree`'s layout, restored onto
    ``params``' layout): each param local its moments' locals at its
    coordinate, the step, the group's settings."""
    def walk(node, m, v):
        if isinstance(node, dict):
            for key in node:
                walk(node[key], m[key], v[key])
        elif isinstance(node, Sharded):
            for coord, tensor in node.distinct():
                optimizer.state[tensor] = {"step": tree["step"].clone(),
                                           "exp_avg": m.locals[coord],
                                           "exp_avg_sq": v.locals[coord]}
        else:
            optimizer.state[node] = {"step": tree["step"].clone(), "exp_avg": m, "exp_avg_sq": v}

    walk(params, tree["exp_avg"], tree["exp_avg_sq"])
    optimizer.param_groups[0].update(tree["hyper"])


def _adam_state(optimizer: torch.optim.Optimizer, tensor: torch.Tensor) -> dict:
    state = optimizer.state.get(tensor)
    if not state:
        raise ValueError("the optimizer holds no state for a param: step it first")
    return state


def _hyper(optimizer: torch.optim.Optimizer) -> dict:
    if len(optimizer.param_groups) != 1:
        raise ValueError("an optimizer of one param group (make_optimizer) is laid out here")
    return {k: copy.deepcopy(v) for k, v in optimizer.param_groups[0].items() if k != "params"}
