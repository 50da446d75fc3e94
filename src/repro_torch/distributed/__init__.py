"""Device meshes for the serving engines, the LM's logical-axis sharding
rules and partition specs (port of ``repro.distributed``'s mesh
constructors, rules and ``partition``)."""

from . import partition, sharding
from .partition import (batch_specs, cache_specs, opt_state_specs,
                        param_specs, place, to_shardings, train_state_specs)
from .sharding import (ShardingRules, make_device_mesh, make_rules, shard,
                       use_rules)

__all__ = ["partition", "sharding", "batch_specs", "cache_specs",
           "opt_state_specs", "param_specs", "place", "to_shardings",
           "train_state_specs", "ShardingRules", "make_rules", "shard",
           "use_rules", "make_device_mesh"]
