"""The ops that only the tests' scripts of `launch.serve_lockstep` use,
and the session their ranks run with them.  `launch.mesh.run_world`'s
spawned ranks import this module by name (the tests' directory is on the
parent's path, which the spawned ranks inherit), so it imports no JAX.

  ("predict", t, x)              a predict of rows x of tasks t
  ("feedback", t) or ("feedback", t, x, y)
                                 label-free or labelled feedback
  ("predict_rows_while", k, t, x)  the predict k times (the learner runs)
  ("wait", what)                 poll until "breaker" latched or
                                 "restarts" >= 1
  ("kill", rank)                 that rank's process kills itself
                                 (SIGKILL) in its next chunk
"""
import os
import signal
import time

from repro_torch.launch import serve_lockstep


def _predict(server, op, res, out, mesh):
    res["preds"].append(out(server.predict(op[1], op[2])))
    res["requests"] += len(op[1])


def _feedback(server, op, res, out, mesh):
    r = server.submit_feedback(*op[1:])
    res["receipts"].append((tuple(r), r.reason))


def _predict_rows_while(server, op, res, out, mesh):
    for _ in range(op[1]):
        server.predict(op[2], op[3])
    res["requests"] += op[1] * len(op[2])


def _wait(server, op, res, out, mesh):
    deadline = time.monotonic() + serve_lockstep.WAIT_S
    while True:
        health = server.stats()["health"]
        if (op[1] == "breaker" and server.breaker_tripped) or (
                op[1] == "restarts" and health["learner_restarts"] >= 1):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"{op[1]} not reached within "
                               f"{serve_lockstep.WAIT_S} s")
        time.sleep(0.002)


def _kill(server, op, res, out, mesh):
    """The rank op[1] kills itself inside its next `engine.run`."""
    if mesh.rank != op[1]:
        return

    def run(*args, **kw):
        os.kill(os.getpid(), signal.SIGKILL)
    make = server._make_engine
    server._make_engine = lambda p: make(p)._replace(run=run)
    server.engine = server.engine._replace(run=run)


OPS = {"predict": _predict, "feedback": _feedback,
       "predict_rows_while": _predict_rows_while, "wait": _wait,
       "kill": _kill}


def session(spec: dict) -> list:
    """`serve_lockstep.session` with the ops above."""
    return serve_lockstep.session(spec, OPS)
