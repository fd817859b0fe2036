from intrinsic3d_torch.mesh.extract import extract_surface, extract_surface_tet  # noqa: F401
from intrinsic3d_torch.mesh.marching_cubes import extract_surface_mc  # noqa: F401
from intrinsic3d_torch.mesh.util import (  # noqa: F401
    remove_degenerate_faces,
    remove_loose_components,
    remove_unused_vertices,
)
