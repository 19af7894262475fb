"""Mesh axes, the device mesh (``parallel.mesh``) and its transport
across processes (``parallel.process_group``).

``__all__`` is the reference's (its ``parallel/__init__.py``): the axis
names, ``MeshPlan`` and ``make_mesh``.  ``make_hybrid_mesh``, which the
reference defines in ``parallel/mesh.py``, is importable from the
package too.
"""

from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    MeshPlan,
    make_hybrid_mesh,
    make_mesh,
)

__all__ = [
    "AXIS_DP",
    "AXIS_PP",
    "AXIS_TP",
    "AXIS_SP",
    "AXIS_EP",
    "MeshPlan",
    "make_mesh",
]
