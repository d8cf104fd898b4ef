"""The task axis of the sharded AMTL engine on `torch.distributed`: the
placement classes and the collectives (`sharding`).  The LM rule engine of
the reference's `distributed/sharding.py` comes with ROADMAP.md Queue 1
item 11(i)."""
from repro_torch.distributed.sharding import (TASK_AXIS, barrier,
                                              collective_stats,
                                              gather_columns, gather_shards,
                                              prox_cache_spec,
                                              reset_collective_stats,
                                              sum_partials, task_shard_specs)

__all__ = ["TASK_AXIS", "task_shard_specs", "prox_cache_spec",
           "gather_columns", "gather_shards", "sum_partials", "barrier",
           "collective_stats", "reset_collective_stats"]
