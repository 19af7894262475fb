"""The port names every public name of the JAX package, and the last two
it gained: ``models/kv_cache_pool.py:supports_pinned_host`` and (in
tests/test_torch_ring_routing.py) ``ops/ring_attention.py:resolve_auto_impl``.

The name check reads both packages with ``ast``: module-level functions
and classes, and the methods of those classes, whose names do not start
with ``_``, module by module; the reference's Pallas modules
(``*_pallas.py``) have the port's CUDA kernels in their place, and a name
the port imports into the same module (a re-export) counts as present.
"""

import ast
import pathlib

import jax
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import kv_cache_pool as ref_pool
from tests.helpers.torch_port import PACKAGE, port

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_PACKAGE = "llm_d_kv_cache_manager_tpu"


def public_names(package: str, imports: bool = False) -> set:
    """{(module path, name)} of ``package``'s public defs, classes and
    methods; with ``imports``, also the names its modules import."""
    root = REPO / package
    out = set()
    for path in root.rglob("*.py"):
        module = path.relative_to(root).as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                if node.name.startswith("_"):
                    continue
                out.add((module, node.name))
                if isinstance(node, ast.ClassDef):
                    out.update((module, f"{node.name}.{item.name}") for item in node.body
                               if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                               and not item.name.startswith("_"))
            elif imports and isinstance(node, ast.ImportFrom):
                out.update((module, alias.asname or alias.name) for alias in node.names)
    return out


def test_the_port_names_every_public_name_of_the_reference():
    missing = sorted(name for name in public_names(REF_PACKAGE)
                     - public_names(PACKAGE, imports=True)
                     if not name[0].endswith("_pallas.py"))
    assert missing == []


def test_supports_pinned_host_off_cuda_is_false():
    sph = port("models.kv_cache_pool").supports_pinned_host
    assert sph("cpu") is False
    assert sph(torch.device("cpu")) is False
    assert sph("meta") is False


def test_supports_pinned_host_on_cuda_follows_cuda_availability(monkeypatch):
    sph = port("models.kv_cache_pool").supports_pinned_host
    assert sph() is torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert sph() is True and sph("cuda") is True and sph(torch.device("cuda:0")) is True
    assert sph("cpu") is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sph("cuda:0") is False


def test_the_pool_decides_its_pinned_path_through_supports_pinned_host(monkeypatch):
    mod = port("models.kv_cache_pool")
    pool = mod.KVCachePool(mod.KVCachePoolConfig(1, 2, 4, 1, 8), device="cpu")
    assert pool.pinned_host is False
    seen = []

    def probe(device=None):
        seen.append(device)
        return True

    monkeypatch.setattr(mod, "supports_pinned_host", probe)
    assert pool.pinned_host is True
    assert seen == [pool.kv.device]


@pytest.mark.parametrize("side", ["ref", "port"])
def test_supports_pinned_host_returns_a_bool_on_both_packages(side):
    """The reference asks its backend for a ``pinned_host`` memory space
    (CPU jaxlib may offer one); the port asks for CUDA.  Both answer with
    a bool and never raise."""
    if side == "ref":
        got = ref_pool.supports_pinned_host(jax.devices("cpu")[0])
        assert isinstance(got, bool) and isinstance(ref_pool.supports_pinned_host(), bool)
    else:
        got = port("models.kv_cache_pool").supports_pinned_host(None)
        assert got is torch.cuda.is_available()
