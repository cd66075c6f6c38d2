from rectpu_torch.parallel.embedding_ep import make_ep_lookup
from rectpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, distributed_init, make_mesh
from rectpu_torch.parallel.plan import ParallelPlan

__all__ = [
    "make_ep_lookup",
    "DATA_AXIS",
    "MODEL_AXIS",
    "distributed_init",
    "make_mesh",
    "ParallelPlan",
]
