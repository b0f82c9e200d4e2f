"""Multi-device layer on torch.distributed (counterpart of
holoagent_tpu/parallel).

The reference drives a (data, model) mesh from one process through
``shard_map`` and GSPMD placements.  The port runs one process a rank with
the same program on every rank (SPMD over a process group: NCCL on cards,
gloo on the CPU), and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with dims ("data", "model").  What the reference holds as a sharded global
array is a local shard on each rank plus explicit collectives
(``parallel.comm``); an entry point returns on every rank what the
reference returns as a global array unless its docstring says otherwise.
``parallel.launch`` starts the ranks.
"""

from .mesh import local_mesh, make_mesh
from .sharding import clip_param_sharding, data_sharding, replicated, shard_params

__all__ = ["make_mesh", "local_mesh", "clip_param_sharding", "data_sharding", "replicated", "shard_params"]
