"""Mesh axes and the single-controller device mesh (``parallel.mesh``)."""
