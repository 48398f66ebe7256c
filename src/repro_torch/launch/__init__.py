"""Command-line entry points of the port and the mesh construction
(``launch/mesh.py``). The dry run (``launch/dryrun.py``) is a CLI of its
own, ``python -m repro_torch.launch.dryrun``, and is not re-exported."""
from repro_torch.launch.mesh import make_host_mesh, make_mesh, \
    make_production_mesh

__all__ = ["make_host_mesh", "make_mesh", "make_production_mesh"]
