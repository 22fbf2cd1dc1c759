"""Multi-device layer: the ("gop", "tile") mesh of ranks, the sharded
encode pipelines, and GOP-parallel processes.

Counterpart of fasthevc_tpu/parallel: GOP-parallel frames over the "gop"
axis, CTU tile columns over the "tile" axis, and the halo exchange of
boundary pixels (source references, ME windows, deblocking strips, SAO
columns) between tile neighbours, kernel K16.  The mesh's ranks run in
this process (`group.ThreadGroup`: one thread and one CUDA stream per
rank, so a one-card host runs a whole mesh) or one per process over
torch.distributed (`group.DistGroup`).
"""

from .mesh import Mesh, gop_tile_mesh, sharded_search_step

__all__ = ["Mesh", "gop_tile_mesh", "sharded_search_step"]
