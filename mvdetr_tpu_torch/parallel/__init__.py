"""Several processes: the (data, view, bev) mesh, its collectives, process
start-up and the data-parallel steps (port of ``mvdetr_tpu/parallel``)."""

from mvdetr_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh
from mvdetr_tpu_torch.parallel.multihost import initialize_distributed, process_batch_slice

__all__ = ["AXES", "Mesh", "make_mesh", "initialize_distributed", "process_batch_slice"]
