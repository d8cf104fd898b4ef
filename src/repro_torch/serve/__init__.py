"""Online learning-while-serving for the port (port of `repro/serve`).

A central `AMTLServer` (`serve.server`) keeps an `AMTLEngine` session
learning from asynchronously streamed task feedback while serving
predictions off a committed, atomically flipped serving snapshot.  The
chunk runner lives on a background learner thread (`serve.learner`,
optionally supervised with bounded auto-restart and a circuit breaker),
a latency-SLO admission controller (`serve.admission`) trades the chunk
budget against the request path's p95, and a `FaultPlan`
(`serve.faults`) injects deterministic crashes, NaNs and torn
checkpoints.  On the card a server's engine work runs on its own CUDA
stream; predictions run on the caller's.  The contracts — frozen serving
is bitwise the frozen engine, feedback-driven serving is bitwise a plain
`engine.run` over the same coalesced chunks, a checkpoint restart is
invisible to later predictions — are documented in
`repro_torch.serve.server` and held by tests/test_torch_serve*.py.
"""
from repro_torch.serve.admission import (LatencySLOController, SLODecision,
                                         degraded_budget)
from repro_torch.serve.faults import (FaultPlan, InjectedFault, corrupt_leaf,
                                      truncate_record)
from repro_torch.serve.learner import BackgroundLearner, LearnerSupervisor
from repro_torch.serve.server import (AMTLServer, FeedbackReceipt,
                                      ServeConfig, ServingSnapshot)

__all__ = ["AMTLServer", "FeedbackReceipt", "ServeConfig",
           "ServingSnapshot", "BackgroundLearner", "LearnerSupervisor",
           "LatencySLOController", "SLODecision", "degraded_budget",
           "FaultPlan", "InjectedFault", "corrupt_leaf",
           "truncate_record"]
