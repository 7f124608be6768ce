"""Command-line launchers of the port (``python -m repro_torch.launch.serve``)
and the meshes of the dry run (``launch.mesh``)."""
from .mesh import fake_world, host_world, make_host_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "fake_world",
           "host_world"]
