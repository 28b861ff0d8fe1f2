"""Parallelism of the port (counterpart of ``ray_tpu/parallel``): the
dataflow substrate (``flow``), meshes as process groups with named axes
(``mesh``), sharding rules (``sharding``), the ZeRO update (``zero``),
the gang (``mesh_group``: ``MeshGroup``, ``StepPipeline``, ``gang_get``)
and elastic data parallelism (``elastic``, loaded on first use).  Ring
attention and the pipelines are ROADMAP Queue 1 item 8.
"""
from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    local_mesh,
    make_mesh,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    batch_sharding,
    replicated,
    shard_params,
)
from ray_tpu_torch.parallel.flow import (  # noqa: F401
    CancellationToken,
    RefStream,
    Stage,
    Window,
)
from ray_tpu_torch.parallel.mesh_group import (  # noqa: F401
    MeshGroup,
    StepPipeline,
    bootstrap_torch_distributed,
    driver_sync_count,
    gang_get,
    is_transport_abort,
    process_group_backend,
    rendezvous,
)


def __getattr__(name):
    # elastic.py imports torch at import time; `import
    # ray_tpu_torch.parallel` stays torch-free for CPU workers.
    if name in ("ElasticMeshGroup", "LocalElastic", "build_elastic_step",
                "reference_trajectory"):
        from ray_tpu_torch.parallel import elastic

        return getattr(elastic, name)
    raise AttributeError(name)
