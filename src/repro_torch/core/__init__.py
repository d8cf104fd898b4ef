"""AMTL core in PyTorch: the engine session and the pieces it runs on."""
from repro_torch.core.amtl import (AMTLConfig, AMTLEngine, AMTLResult,
                                   AMTLState, BatchAMTLState, DeltaAMTLState,
                                   ShardedAMTLState, amtl_events_only,
                                   amtl_solve, current_iterate,
                                   default_config, gather_state,
                                   init_sharded_state, init_state,
                                   local_state, make_engine, shard_problem,
                                   validate_config)
from repro_torch.core.dynamic_step import DelayHistory, dynamic_multiplier
from repro_torch.core.losses import MTLProblem, get_loss
from repro_torch.core.operators import (amtl_max_step, backward,
                                        backward_forward,
                                        fixed_point_residual, forward,
                                        forward_backward, km_block_update,
                                        km_step, rollback_columns,
                                        rollback_columns_batch,
                                        rollback_columns_shard)
from repro_torch.core.prox import (ProxPlan, apply_prox, get_regularizer,
                                   l21_prox, sketch_width, svt,
                                   svt_randomized, svt_randomized_dist)
from repro_torch.core.simulator import (NetworkModel, SimProblem, SimResult,
                                        make_synthetic, simulate_amtl,
                                        simulate_smtl)
from repro_torch.core.smtl import (SolveResult, fista_solve,
                                   reference_optimum, smtl_solve)

__all__ = [
    "AMTLConfig", "AMTLEngine", "AMTLResult", "AMTLState", "BatchAMTLState",
    "DeltaAMTLState", "ShardedAMTLState", "amtl_events_only", "amtl_solve",
    "current_iterate", "default_config", "gather_state",
    "init_sharded_state", "init_state", "local_state", "make_engine",
    "shard_problem", "validate_config",
    "DelayHistory", "dynamic_multiplier", "MTLProblem", "get_loss",
    "amtl_max_step", "backward", "backward_forward", "fixed_point_residual",
    "forward", "forward_backward", "km_block_update", "km_step",
    "rollback_columns", "rollback_columns_batch", "rollback_columns_shard",
    "ProxPlan", "apply_prox", "get_regularizer", "l21_prox", "sketch_width",
    "svt", "svt_randomized", "svt_randomized_dist",
    "NetworkModel", "SimProblem", "SimResult", "make_synthetic",
    "simulate_amtl", "simulate_smtl", "SolveResult", "fista_solve",
    "reference_optimum", "smtl_solve",
]
