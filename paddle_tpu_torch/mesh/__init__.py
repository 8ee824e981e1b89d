"""The SPMD mesh layer of the port — the counterpart of
``paddle_tpu/mesh``: named logical device axes and name-based parameter
sharding as one serializable object pair, on ``torch.distributed``
``DeviceMesh`` and DTensor.

  - ``MeshSpec``: named logical axes -> a ``DeviceMesh`` with these dim
    names; parse/build/serialize (``"dp=2,tp=2,fsdp=2"`` <-> dict);
  - ``ShardingRules``: ordered regex -> PartitionSpec assignment over
    var/param names, speaking the plan protocol the ParallelExecutor
    consumes (``spec_for``/``feed_spec``/``batch_axis``) and JSON
    round-tripping;
  - stock rule sets: ``transformer_rules()`` (dp x tp x fsdp training
    over the Fluid Transformer's param names), ``decoder_rules()``
    (tensor-parallel rules over the serving decoder's param tree, which
    ``DecodeEngine(mesh=)`` serves on);
  - observability (``observe.py``): mesh gauges, per-collective-kind
    counters, ``mesh_status()``.

``python -m paddle_tpu_torch.mesh --describe AXES`` prints a spec and the
stock rules' assignments; ``--selftest`` runs the layer's cases in a gloo
world of CPU ranks it spawns (a torch process drives one device).
"""
from .spec import (  # noqa: F401
    MeshSpec,
    ShardingRules,
    decoder_rules,
    flatten_param_names,
    shard_param_tree,
    transformer_rules,
)
from .observe import (  # noqa: F401
    mesh_status,
    note_mesh,
    note_sharded_compile,
    sharded_step_counter,
)

__all__ = [
    "MeshSpec", "ShardingRules", "transformer_rules", "decoder_rules",
    "flatten_param_names", "shard_param_tree", "note_mesh",
    "note_sharded_compile", "mesh_status", "sharded_step_counter",
]
