"""Mesh axes and the single-controller device mesh (``parallel.mesh``).

The package exports the reference's names (its ``parallel/__init__.py``):
the axis names, ``MeshPlan`` and ``make_mesh``.
"""

from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    MeshPlan,
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
