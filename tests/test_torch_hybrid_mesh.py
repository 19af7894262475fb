"""The port's ``make_hybrid_mesh`` against the JAX reference's, on the CPU.

- Every case of the reference's ``tests/test_mesh.py::TestHybridMesh``
  runs on both packages over eight devices (the JAX suite's virtual host
  devices; ``cpu:0`` .. ``cpu:7`` for the port) and gives the same shape
  and device order; so do more one-process plans.
- Across processes, the port's order (``hybrid_layout``) is held against
  ``mesh_utils.create_hybrid_device_mesh(..., process_is_granule=True)``
  on fake devices that carry a ``process_index``, entry by entry: the
  same device of the same process.
- Built in real gloo groups (2 and 4 spawned processes), every process
  sees that same mesh and owns exactly its own entries.
- It raises where ``WORLD_SIZE`` says several processes run and no group
  is initialized; ``make_mesh`` keeps its one-process behaviour.
"""

from dataclasses import dataclass

import jax
import numpy as np
import pytest
from jax.experimental import mesh_utils

from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from tests.helpers import torch_dist
from tests.helpers.torch_port import port

mesh = port("parallel.mesh")

DEVICES = [f"cpu:{i}" for i in range(8)]


def _order(side, m):
    """The mesh's devices as indices 0..7, in mesh order."""
    if side == "ref":
        return [d.id for d in m.devices.flat]
    return [int(str(d).split(":")[1]) for d in m.devices.flat]


def _build(side, ici=None, dcn=None):
    module = jax_mesh if side == "ref" else mesh
    kwargs = {}
    if ici is not None:
        kwargs["ici_plan"] = module.MeshPlan(**ici)
    if dcn is not None:
        kwargs["dcn_plan"] = module.MeshPlan(**dcn)
    if side == "port":
        kwargs["devices"] = DEVICES
    return module.make_hybrid_mesh(**kwargs)


class TestHybridMesh:
    """The reference's cases, on both packages, and the two packages'
    meshes against each other."""

    @pytest.mark.parametrize("side", ["ref", "port"])
    def test_single_process_degenerates_to_flat(self, side):
        m = _build(side, dict(dp=1, tp=4, sp=2), dict(dp=1))
        assert m.shape["tp"] == 4
        assert m.shape["sp"] == 2
        assert m.axis_names == (jax_mesh if side == "ref" else mesh).AXIS_ORDER
        want = _build("ref", dict(dp=1, tp=4, sp=2), dict(dp=1))
        assert dict(m.shape) == dict(want.shape)
        assert _order(side, m) == _order("ref", want)

    @pytest.mark.parametrize("side", ["ref", "port"])
    def test_defaults_use_all_devices(self, side):
        m = _build(side)
        assert int(np.prod(list(m.shape.values()))) == len(jax.devices()) == len(DEVICES)
        want = _build("ref")
        assert dict(m.shape) == dict(want.shape)
        assert _order(side, m) == _order("ref", want)


ONE_PROCESS_PLANS = [
    (dict(dp=2, sp=4), dict(dp=1)),
    (dict(dp=1, pp=2, tp=2, sp=2), None),
    (dict(dp=-1, sp=2), dict(dp=1, sp=1)),
    (dict(dp=2, ep=2, tp=2), dict(dp=1, tp=1)),
]


@pytest.mark.parametrize("ici,dcn", ONE_PROCESS_PLANS)
def test_one_process_plans_match_reference(ici, dcn):
    want, got = _build("ref", ici, dcn), _build("port", ici, dcn)
    assert dict(got.shape) == dict(want.shape)
    assert _order("port", got) == _order("ref", want)
    assert not got.multi_process and got.crossing_axes() == ()


@dataclass(frozen=True)
class FakeDevice:
    """What ``create_hybrid_device_mesh`` reads of a device."""

    id: int
    process_index: int
    platform: str = "cpu"
    device_kind: str = "cpu"


def _plan(axes):
    return {a: axes.get(a, 1) for a in mesh.AXIS_ORDER}


MULTI_PROCESS = [
    # (processes, ici degrees, dcn degrees)
    (4, dict(sp=2), dict(dp=2, sp=2)),
    (2, dict(tp=4), dict(dp=2)),  # the default plans over 2 processes of 4 devices
    (4, dict(tp=2), dict(dp=4)),  # the default plans over 4 processes of 2 devices
    (4, dict(tp=2, sp=2), dict(dp=2, pp=2)),
    (2, dict(sp=2, tp=2), dict(sp=2)),
    (8, dict(), dict(dp=2, sp=4)),
]


@pytest.mark.parametrize("n,ici,dcn", MULTI_PROCESS)
def test_multi_process_order_matches_create_hybrid_device_mesh(n, ici, dcn):
    ici, dcn = _plan(ici), _plan(dcn)
    per = int(np.prod(list(ici.values())))
    fakes = [FakeDevice(i, i // per) for i in range(n * per)]
    want = mesh_utils.create_hybrid_device_mesh(
        mesh_shape=tuple(ici[a] for a in mesh.AXIS_ORDER),
        dcn_mesh_shape=tuple(dcn[a] for a in mesh.AXIS_ORDER),
        devices=fakes, process_is_granule=True)
    devices, processes = mesh.hybrid_layout(
        ici, dcn, [[f"cpu:{p * per + j}" for j in range(per)] for p in range(n)])
    assert devices.shape == want.shape == processes.shape
    assert [int(str(d).split(":")[1]) for d in devices.flat] == [d.id for d in want.flat]
    assert processes.tolist() == np.vectorize(lambda d: d.process_index)(want).tolist()


def test_hybrid_layout_rejects_uneven_processes():
    with pytest.raises(ValueError, match="want 2 processes"):
        mesh.hybrid_layout(_plan({}), _plan(dict(dp=2)), [["cpu"]] * 3)
    with pytest.raises(ValueError, match="process 1 has 1"):
        mesh.hybrid_layout(_plan(dict(sp=2)), _plan(dict(dp=2)), [["cpu"] * 2, ["cpu"]])


@pytest.mark.parametrize("n,ici,dcn,per", [
    (2, dict(dp=1, sp=2), dict(dp=2), 2),
    (4, None, None, 2),  # the reference's defaults: dcn dp = 4, ici tp = 2
], ids=["ici-sp2-dcn-dp2", "defaults-4"])
def test_make_hybrid_mesh_in_a_gloo_group(n, ici, dcn, per):
    got = torch_dist.run_group(torch_dist.mesh_layout, n, ici or dict(dp=1, tp=per),
                               dcn or dict(dp=n), per, timeout=120.0)
    full_ici = _plan(ici or dict(tp=per))
    full_dcn = _plan(dcn or dict(dp=n))
    devices, processes = mesh.hybrid_layout(
        full_ici, full_dcn, [[f"cpu:{p * per + j}" for j in range(per)] for p in range(n)])
    for rank, seen in enumerate(got):
        assert seen["devices"] == [str(d) for d in devices.flat]
        assert seen["processes"] == processes.tolist()
        assert seen["shape"] == {a: full_ici[a] * full_dcn[a] for a in mesh.AXIS_ORDER}
        owned = [c for c in np.ndindex(processes.shape) if processes[c] == rank]
        assert [tuple(c) for c in seen["owned"]] == owned and len(owned) == per
        assert seen["crossing"] == tuple(a for a in mesh.AXIS_ORDER if full_dcn[a] > 1)
        assert f"over processes {list(range(n))}" in seen["repr"]


def test_make_hybrid_mesh_raises_without_a_group(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_hybrid_mesh(devices=["cpu"])
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dict(mesh.make_hybrid_mesh(devices=["cpu"] * 2).shape)["tp"] == 2


def test_make_mesh_keeps_one_process_behaviour():
    """``make_mesh`` in one process: every entry this process's, the
    repr of before, nothing crossing."""
    m = mesh.make_mesh(mesh.MeshPlan(dp=1, sp=4), ["cpu"] * 4)
    assert repr(m) == "Mesh(dp=1, pp=1, ep=1, sp=4, tp=1; ['cpu'])"
    assert not m.multi_process and m.crossing_axes() == ()
    assert all(m.is_local(c) and m.process_of(c) == 0 for c in np.ndindex(m.devices.shape))
