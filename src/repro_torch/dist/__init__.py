"""repro_torch.dist — the aggregation-rule registry (``registry``).

The SPMD layer of ``repro.dist`` (collectives, sharding, the
``collective``/``spmd`` registry columns) is ported in a later slice.
"""
from repro_torch.dist import registry  # noqa: F401
from repro_torch.dist.registry import (AggregationRule, get_rule,  # noqa: F401
                                       rule_names)
