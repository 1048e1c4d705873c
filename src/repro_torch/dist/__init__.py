"""repro_torch.dist — the aggregation and sharding layer (counterpart of
``repro.dist``):

- ``repro_torch.dist.registry``     named ``AggregationRule`` objects
  bundling, per rule, the torch reference (``core.gradagg``), the SPMD
  collective (``dist.collectives``) and the kernel-backed device twin.
  ``EngineConfig.rule`` and ``TrainConfig.mode`` both resolve here.
- ``repro_torch.dist.collectives``  SPMD twins of the reference rules on
  ``torch.distributed`` (all-reduce only).
- ``repro_torch.dist.sharding``     logical-axis -> mesh-axis resolution
  (``MeshRules``), the per-dim axis specs of trees, batches and caches,
  and the storage of a tree by its specs (shard, gather, ``Placement``).
- ``repro_torch.dist.act_sharding`` the models' activation constraint
  points (``constrain``, ``act_policy``) and the storage -> compute
  gather (``constrain_tree``).
- ``repro_torch.dist.tp``           tensor-parallel compute over the
  "model" axes for the attention decoders (GQA or MLA), the Mamba
  hybrids and RWKV-6: the context the layers read and Megatron's four
  autograd Functions on all-reduces.
"""
from repro_torch.dist import registry  # noqa: F401
from repro_torch.dist.registry import (AggregationRule, get_rule,  # noqa: F401
                                       rule_names)
