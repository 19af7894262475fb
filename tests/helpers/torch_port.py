"""Access to the PyTorch/CUDA port from the tests.

The port (``llm_d_kv_cache_manager_tpu_torch``) is a second top-level
package of this repository.  Tests reach its modules through
:func:`port` rather than an ``import`` statement, so the CI dependency
check (tests/test_ci_deps.py), which maps every top-level import name
to a pip distribution, keeps seeing only the names it knows.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import torch

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"

# The port's tests run tiny shapes; one intra-op thread per test worker
# keeps torch from competing for every core with the suite's other
# workers, some of whose tests compare wall-clock timings.
torch.set_num_threads(1)


def port(name: str):
    """``port("ops.attention")`` is the port's ``ops/attention.py``."""
    return importlib.import_module(f"{PACKAGE}.{name}")


def namespace(side: str, ref_modules: dict, names: dict):
    """A flat namespace of ``names`` ({module path: (name, ...)}) taken
    from the JAX package (``side == "ref"``, its modules given in
    ``ref_modules`` by the same paths) or from the port (``"port"``), so
    one test body runs against either package as ``m.Name``."""
    ns = SimpleNamespace(side=side)
    for path, wanted in names.items():
        module = ref_modules[path] if side == "ref" else port(path)
        for name in wanted:
            setattr(ns, name, getattr(module, name))
    return ns
