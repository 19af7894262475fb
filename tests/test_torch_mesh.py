"""The port's ``parallel/mesh.py`` against the JAX reference's: the same
axis order, the same ``MeshPlan.resolve`` (sizes and error messages),
and meshes of the same shape over the reference suite's eight devices
(here eight CPU ranks, which may name one device)."""

import jax
import pytest
import torch

from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from tests.helpers.torch_port import port

mesh = port("parallel.mesh")

PLANS = [
    dict(),
    dict(dp=2, sp=4),
    dict(dp=1, sp=8),
    dict(dp=-1, sp=2),
    dict(dp=1, tp=2, sp=2),
    dict(dp=1, pp=2, tp=2, sp=2),
    dict(dp=2, ep=2, tp=-1),
    dict(dp=-1, pp=3),  # 8 % 3: not divisible
    dict(dp=-1, tp=-1),  # two free axes
    dict(dp=0),  # invalid size
    dict(dp=1, sp=-2),  # invalid size
    dict(dp=1, sp=4),  # wants 4, has 8
    dict(dp=16),  # wants 16, has 8
]


def _resolve(module, kwargs, n):
    try:
        return module.MeshPlan(**kwargs).resolve(n)
    except ValueError as exc:
        return f"ValueError: {exc}"


def test_axis_order_matches_reference():
    assert mesh.AXIS_ORDER == jax_mesh.AXIS_ORDER
    for name in ("AXIS_DP", "AXIS_PP", "AXIS_TP", "AXIS_SP", "AXIS_EP"):
        assert getattr(mesh, name) == getattr(jax_mesh, name)


@pytest.mark.parametrize("n_devices", [1, 4, 8])
@pytest.mark.parametrize("kwargs", PLANS, ids=[str(p) for p in PLANS])
def test_resolve_matches_reference(kwargs, n_devices):
    """Sizes, and the same ValueError with the same message."""
    assert _resolve(mesh, kwargs, n_devices) == _resolve(jax_mesh, kwargs, n_devices)


@pytest.mark.parametrize(
    "kwargs", [dict(dp=2, sp=4), dict(dp=1, sp=8), dict(dp=1, tp=2, sp=2, pp=2)],
    ids=str,
)
def test_mesh_shape_matches_reference(kwargs):
    want = jax_mesh.make_mesh(jax_mesh.MeshPlan(**kwargs), jax.devices()[:8])
    got = mesh.make_mesh(mesh.MeshPlan(**kwargs), ["cpu"] * 8)
    assert got.axis_names == tuple(want.axis_names)
    assert dict(got.shape) == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_mesh_keeps_device_order():
    """Distinct entries land in row-major AXIS_ORDER, as the reference
    reshapes jax.devices()."""
    devices = [torch.device("cpu", i) for i in range(8)]
    got = mesh.make_mesh(mesh.MeshPlan(dp=2, sp=4), devices)
    assert got.shape["sp"] == 4 and got.shape["dp"] == 2
    assert [d.index for d in got.devices[1, 0, 0, :, 0]] == [4, 5, 6, 7]


def test_make_mesh_rejects_wrong_device_count():
    with pytest.raises(ValueError, match="mesh plan wants 4 devices, have 3"):
        mesh.make_mesh(mesh.MeshPlan(dp=1, sp=4), ["cpu"] * 3)


class TestMeshContext:
    """The reference suite's TestMeshContext: ``activate`` and ``with
    mesh:`` make a mesh active for the block, ``mesh_is_active`` says
    so, and a placement constraint resolves under ``activate``."""

    def test_inactive_outside_any_context(self):
        assert not mesh.mesh_is_active() and mesh.active_mesh() is None
        assert mesh.mesh_is_active() == jax_mesh.mesh_is_active()

    def test_activate_enters_and_exits(self):
        tmesh = mesh.make_mesh(mesh.MeshPlan(dp=4, tp=2), ["cpu"] * 8)
        with mesh.activate(tmesh) as entered:
            assert entered is tmesh and mesh.mesh_is_active()
            assert mesh.active_mesh() is tmesh
        assert not mesh.mesh_is_active()

    def test_legacy_with_mesh_still_detected(self):
        tmesh = mesh.make_mesh(mesh.MeshPlan(dp=4, tp=2), ["cpu"] * 8)
        inner = mesh.make_mesh(mesh.MeshPlan(dp=2, tp=4), ["cpu"] * 8)
        with tmesh:
            assert mesh.mesh_is_active()
            with mesh.activate(inner):
                assert mesh.active_mesh() is inner
            assert mesh.active_mesh() is tmesh
        assert not mesh.mesh_is_active()

    def test_sharding_constraint_resolves_under_activate(self):
        """The reference's case places ones(8, 2) by P("dp", "tp") under
        activate and sums to 16; here the port's constraint
        (``moe._constrain``) gives each of the 8 ranks its [2, 1] slice."""
        moe, sharding = port("models.moe"), port("parallel.sharding")
        tmesh = mesh.make_mesh(mesh.MeshPlan(dp=4, tp=2), ["cpu"] * 8)
        with mesh.activate(tmesh):
            y = moe._constrain(torch.ones((8, 2)), sharding.P("dp", "tp"))
        assert y.local_shape == (2, 1) and len(y.distinct()) == 8
        assert float(sharding.unshard(y).sum()) == 16.0


def test_rank_coordinates():
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=2, pp=2, tp=2),
                           [torch.device("cpu", i) for i in range(8)])
    assert tmesh.coord(dp=1, tp=1) == (1, 0, 0, 0, 1)
    assert tmesh.devices[tmesh.coord(dp=1, pp=1, tp=1)].index == 7
    assert tmesh.size("tp") == 2 and tmesh.size("ep") == 1
    with pytest.raises(ValueError, match="no axes"):
        tmesh.coord(heads=1)
