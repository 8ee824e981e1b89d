"""Parallelism toolkit of the port: sharding plans over a named
``DeviceMesh`` and mixture-of-experts — the counterpart of
``paddle_tpu/parallel`` (its ``api.py`` and ``moe.py``). Where the JAX
package hands XLA's SPMD partitioner ``PartitionSpec``s, the port places
DTensors, which insert the collectives. ``sequence_parallel.py`` (ring
and Ulysses attention) and ``pipeline.py`` (GPipe over ``pp``) exchange
activations by explicit P2P and all-to-all over the mesh's groups.
"""
from .api import (  # noqa: F401
    P,
    PartitionSpec,
    ShardingPlan,
    current_mesh,
    make_mesh,
    mesh_context,
    plan_data_parallel,
    plan_fsdp,
    plan_moe_ep,
    plan_sequence_parallel,
    plan_transformer_tp,
    spec_to_placements,
)
from .moe import moe_ffn, top1_dispatch  # noqa: F401
from .pipeline import (  # noqa: F401
    pipeline_apply,
    shard_stage_params,
    stack_stage_params,
)
from .sequence_parallel import (  # noqa: F401
    ring_attention_shard,
    sequence_parallel_attention,
    ulysses_attention_shard,
)
