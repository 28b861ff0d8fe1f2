"""Parallelism of the port (counterpart of ``ray_tpu/parallel``): so far
the dataflow substrate (``flow``), ``MeshSpec`` (``mesh``) and the gang
fan-out with eager rank-death detection (``mesh_group.gang_get``), which
the Train stack needs.  Meshes over devices, sharding, ring attention,
pipelines and the rest of ``MeshGroup`` are ROADMAP Queue 1 items 6 and 8.
"""
from ray_tpu_torch.parallel.mesh import MeshSpec  # noqa: F401
