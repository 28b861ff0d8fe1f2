"""Parallelism of the port (counterpart of ``ray_tpu/parallel``): the
dataflow substrate (``flow``), meshes as process groups with named axes
(``mesh``), sharding rules (``sharding``), the ZeRO update (``zero``),
the gang (``mesh_group``: ``MeshGroup``, ``StepPipeline``, ``gang_get``)
elastic data parallelism (``elastic``) and sequence parallelism
(``ring_attention``: ``ring_attention`` and ``ulysses_attention``), the
last two loaded on first use.  The pipelines are ROADMAP Queue 1 item 8.
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
    # elastic.py and ring_attention.py import torch at import time;
    # `import ray_tpu_torch.parallel` stays torch-free for CPU workers.
    if name in ("ElasticMeshGroup", "LocalElastic", "build_elastic_step",
                "reference_trajectory"):
        from ray_tpu_torch.parallel import elastic

        return getattr(elastic, name)
    if name in ("ring_attention", "ulysses_attention"):
        import importlib

        # The module is callable as its function (it shares its name).
        mod = importlib.import_module("ray_tpu_torch.parallel.ring_attention")
        return mod if name == "ring_attention" else mod.ulysses_attention
    raise AttributeError(name)
