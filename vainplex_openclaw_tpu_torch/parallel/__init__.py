"""Device grids, sharding plans and ring attention for mesh serving."""

from .mesh import Mesh, cached_mesh, make_mesh

__all__ = ["Mesh", "cached_mesh", "make_mesh"]
