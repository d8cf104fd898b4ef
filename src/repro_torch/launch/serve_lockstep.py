"""Scripts of the learn-while-serve `AMTLServer` on a lockstep world, run
by every rank (`launch.mesh.run_world`) or by one process at one rank.

    from repro_torch.launch import mesh, serve_lockstep
    out = mesh.run_world(serve_lockstep.session, 2, spec, device="cuda")
    one = serve_lockstep.session(dict(spec, device="cuda"))   # one rank

`session(spec)` builds the problem in the rank (its block of it where the
store is drawn from a seed), then runs the spec's servers in turn, each
through a script of the calls a user makes, the same on every rank, and
returns for each what every call gave: receipts, predictions, the
snapshot after each boundary, the chunk log, the engine state (as the
one-rank batch engine holds it: `state_view`), the rank's store shard and
the whole store's row counts, the kernels' launches against the count
the rank's events call for (`expected_launches`), the collectives'
issuing threads, the wire's telemetry, and the times, host peaks
(sampled: `HostPeak`) and device peaks of the calls.  With `digest`
every array comes back as the SHA-256 of its bytes.

The spec (plain values; arrays as numpy):

  device     "cpu" or "cuda"
  problem    {"xs", "ys", "row_counts", "loss", "reg", "lam"} host arrays,
             or {"store_seed", "t", "d", "lo", "hi", "lam"} for
             `amtl_sharded.make_store`
  v0, key    the (d, T) initial iterate and the raw uint32[2] key
  traffic    {"seed", "batches", "rows"}: request batches drawn after the
             store from its row maker (`traffic`)
  digest     arrays as digests; `keep_snapshots` keeps the first k
             snapshots as arrays all the same
  servers    a list of {"cfg": AMTLConfig fields, "serve": ServeConfig
             fields, "resume": bool, "faults": {rank: FaultPlan kwargs},
             "offsets": (T,) or None, "ops": [op, ...], "store": False to
             leave the store out of the results, "blocks": n for the
             store's n blocks of tasks too (a one-rank run, to hold n
             ranks' shards against)}

An op is a tuple:

  ("serve", i)            traffic batch i: predict, labelled feedback, step
  ("ask", i), ("submit", i)  traffic batch i's predict, its feedback
  ("step",)               one boundary, the snapshot after it recorded
  ("drain",)              step until a boundary runs nothing
  ("checkpoint",)         its seconds, the records' bytes, the host peak
  ("start",)              start_learner()
  ("predict_while", k, i) predict traffic batch i k times (the learner
                          runs)
  ("stop", drain)         stop_learner(drain); the exception, if any

`session(spec, extra_ops)` takes further ops as {name: fn(server, op,
res, out, mesh)}, where `res` is the server's results so far and `out` puts
an array in the results' form.

Imports torch, numpy and the port only.
"""
from __future__ import annotations

import gc
import hashlib
import os
import resource
import threading
import time

import numpy as np
import torch

from repro_torch.core import AMTLConfig, MTLProblem, place_rings
from repro_torch.core.amtl import plan_events
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (collective_stats,
                                              reset_collective_stats)
from repro_torch.interop import state_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch.amtl_sharded import make_store
from repro_torch.launch.mesh import make_task_mesh
from repro_torch.serve import AMTLServer, FaultPlan, ServeConfig

WAIT_S = 120.0
KERNELS = ("amtl_event_batch", "gauss_sketch", "svt_reconstruct",
           "lstsq_grad", "lstsq_grad_sampled")


class HostPeak:
    """The process's peak resident bytes over a `with` block (`peak`, and
    `rise` over the resident bytes at its start), sampled from
    /proc/self/statm every `every_s` by a thread of its own (a peak
    shorter than that can be missed).  Unlike `ru_maxrss`, which Linux
    carries from a parent into a spawned child, it is the process's own."""

    def __init__(self, every_s: float = 0.002):
        self.every_s = every_s
        self.peak = self.start = 0
        self._done = threading.Event()

    @staticmethod
    def resident() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self) -> None:
        while not self._done.is_set():
            self.peak = max(self.peak, self.resident())
            self._done.wait(self.every_s)

    @property
    def rise(self) -> int:
        return self.peak - self.start

    def __enter__(self) -> "HostPeak":
        self.peak = self.start = self.resident()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._thread.join()
        self.peak = max(self.peak, self.resident())


def max_rss_bytes() -> int:
    """`ru_maxrss` of the process, in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def traffic(rows, t: int, d: int, seed: int, batches: int, k: int) -> list:
    """`batches` request batches: (prediction task ids, features, feedback
    task ids, features, labels), k rows each, the feedback rows drawn by
    the store's row maker `rows`."""
    rng = np.random.default_rng(seed + 4)
    out = []
    for _ in range(batches):
        qt = rng.integers(0, t, k)
        qx = rng.standard_normal((k, d), dtype=np.float32) \
            / np.float32(d ** 0.5)
        ft = rng.integers(0, t, k)
        fx, fy = zip(*(rows(int(i), 1) for i in ft))
        out.append((qt, qx, ft, np.concatenate(fx), np.concatenate(fy)))
    return out


def state_view(state, mesh, cfg) -> list[np.ndarray]:
    """The engine state's leaves as the one-rank batch engine holds them:
    the global view (a collective on a mesh of n > 1 ranks) with its
    undo rings placed as one ring (`place_rings`)."""
    leaves = state_to_numpy(state, mesh=mesh, cfg=cfg)
    ring = torch.from_numpy(np.ascontiguousarray(leaves[1]))
    leaves[1] = place_rings(ring, leaves[2], leaves[0].shape[1],
                            None).numpy()
    return leaves


def expected_launches(server, cfg, state, offsets, chunks) -> dict:
    """The launches this rank's kernels owe `chunks` run from `state`,
    from a host replay of the event stream: one event-batch update,
    sketch and reconstruction a step, and one gradient launch a step with
    an event of the rank's tasks."""
    problem = server.problem
    engine = server._make_engine(problem)
    per = cfg.event_batch
    steps = owned = 0
    offs = np.zeros(server.num_tasks, np.float32) if offsets is None \
        else np.asarray(offsets, np.float32)
    for n in chunks:
        plan = plan_events(engine.problem, cfg, state, offs, n, engine.mesh)
        steps += n // per
        own = (plan.local_tasks < problem.num_tasks).reshape(-1, per)
        owned += int(own.any(axis=1).sum())
        state = state._replace(task_ring=plan.task_ring, ptr=plan.ptr,
                               event=plan.event, history=plan.history,
                               key=plan.key)
    grad = "lstsq_grad" if cfg.batch_size is None else "lstsq_grad_sampled"
    out = {k: 0 for k in KERNELS}
    out.update(amtl_event_batch=steps, gauss_sketch=steps,
               svt_reconstruct=steps)
    out[grad] = owned
    return out


def _problem(p: dict, mesh):
    """(the problem or the rank's block of it, on the host; the store's
    row maker or None)."""
    if "store_seed" in p:
        n_local = mesh.n_local(p["t"])
        tasks = range(mesh.rank * n_local, (mesh.rank + 1) * n_local)
        store, rows = make_store(p["store_seed"], p["t"], p["d"], p["lo"],
                                 p["hi"], p["lam"], tasks=tasks)
        return store.problem("cpu"), rows
    counts = p.get("row_counts")
    return MTLProblem(
        torch.as_tensor(np.asarray(p["xs"], np.float32)),
        torch.as_tensor(np.asarray(p["ys"], np.float32)), p["loss"],
        p["reg"], float(p["lam"]),
        None if counts is None else torch.as_tensor(
            np.asarray(counts, np.int32))), None


class _Out:
    """Arrays as they are, or as digests."""

    def __init__(self, digest: bool):
        self.digest = digest

    def __call__(self, x):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        if not self.digest:
            return x
        return hashlib.sha256(
            np.ascontiguousarray(x).reshape(-1).view(np.uint8)).hexdigest()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ckpt_bytes(server, path) -> int:
    if path is None:
        return 0
    step = os.path.basename(path)
    store = os.path.join(server.serve_cfg.ckpt_dir, "store", step)
    return os.path.getsize(path) + (os.path.getsize(store)
                                    if os.path.exists(store) else 0)


def run_server(spec: dict, run: dict, problem, batches, mesh, dev,
               extra_ops: dict | None = None) -> dict:
    """One server of the spec through its ops and the further `extra_ops`
    (see the module doc)."""
    out = _Out(spec.get("digest", False))
    keep = spec.get("keep_snapshots", 0)
    cfg = AMTLConfig(**run["cfg"])
    plan = FaultPlan(**run.get("faults", {}).get(mesh.rank, {}))
    sc = ServeConfig(**run.get("serve", {}))
    v0 = np.asarray(spec["v0"], np.float32)
    key = np.asarray(spec["key"], np.uint32)
    offsets = run.get("offsets")
    kw = dict(device=dev, delay_offsets=offsets, fault_plan=plan,
              mesh=mesh if cfg.engine == "sharded" else None)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    reset_collective_stats()
    t0 = time.perf_counter()
    make = AMTLServer.resume if run.get("resume") else AMTLServer
    with HostPeak() as peak:
        server = make(problem, cfg, v0, key, sc, **kw)
    res = {"build_s": time.perf_counter() - t0,
           "build_host_peak": (peak.peak, peak.rise), "receipts": [],
           "preds": [], "snapshots": [], "ran": [], "ckpts": [],
           "stops": [], "requests": 0, "learn_s": 0.0,
           "ask_s": 0.0}
    res["start_event"] = server.event_count
    res["streams"] = []
    start = server._state

    def snap():
        s = server.serving()
        whole = not out.digest or len(res["snapshots"]) < keep
        res["snapshots"].append(
            (s.event, s.v.cpu().numpy() if whole else out(s.v)))
        st = server._state       # the event stream: the host leaves
        res["streams"].append([out(np.asarray(x)) for x in (
            st.task_ring, st.ptr, st.event, st.history.buf,
            st.history.count, st.key)])

    def step():
        res["ran"].append(server.step())
        snap()

    for op in run["ops"]:
        t1 = time.perf_counter()
        name = op[0]
        if name == "serve":
            qt, qx, ft, fx, fy = batches[op[1]]
            res["preds"].append(out(server.predict(qt, qx)))
            r = server.submit_feedback(ft, fx, fy)
            res["receipts"].append((tuple(r), r.reason))
            step()
            res["requests"] += len(qt)
        elif name == "ask":
            qt, qx = batches[op[1]][:2]
            res["preds"].append(out(server.predict(qt, qx)))
            res["requests"] += len(qt)
        elif name == "submit":
            r = server.submit_feedback(*batches[op[1]][2:])
            res["receipts"].append((tuple(r), r.reason))
        elif name == "step":
            step()
        elif name == "drain":
            step()
            while res["ran"][-1]:
                step()
        elif name == "checkpoint":
            _sync(dev)
            t2 = time.perf_counter()
            with HostPeak() as peak:
                path = server.checkpoint()
            res["ckpts"].append(dict(
                s=time.perf_counter() - t2, bytes=_ckpt_bytes(server, path),
                path=path and os.path.basename(path),
                host_peak=(peak.peak, peak.rise)))
        elif name == "start":
            reset_collective_stats()
            server.start_learner()
        elif name == "predict_while":
            qt, qx = batches[op[2]][:2]
            for _ in range(op[1]):
                server.predict(qt, qx)
            _sync(dev)
            res["requests"] += op[1] * len(qt)
        elif name == "stop":
            try:
                res["stops"].append(server.stop_learner(drain=op[1],
                                                        timeout=WAIT_S))
            except Exception as e:       # the world's failures, reported
                res["stops"].append(repr(e))
            threads = collective_stats()["threads"]
            res["learner_threads"] = (len(threads),
                                      _main_ident() in threads)
        elif extra_ops and name in extra_ops:
            extra_ops[name](server, op, res, out, mesh)
        else:
            raise ValueError(f"unknown op {op!r}")
        _sync(dev)
        if name in ("serve", "step", "drain"):
            res["learn_s"] += time.perf_counter() - t1
        elif name == "ask":
            res["ask_s"] += time.perf_counter() - t1
    res["launches"] = ops.launch_counts()
    res["expected"] = expected_launches(server, cfg, start, offsets,
                                        server.chunk_log)
    res["chunk_log"] = list(server.chunk_log)
    res["state"] = [out(x) for x in state_view(server._state, server.mesh,
                                               cfg)]
    store = server._store if run.get("store", True) else None
    res["store"] = None if store is None else [out(x) for x in
                                               store.buffers()]
    n = run.get("blocks")
    if n and store is not None:
        st, k = store.buffers(), store.num_tasks // n
        res["store_blocks"] = [[out(x[r * k:(r + 1) * k]) for x in st]
                               for r in range(n)]
    res["counts"] = None if server._store is None else (
        server._counts.tolist() if server.lockstep is not None
        else server._store.row_counts.tolist())
    res["block"] = (tuple(server.problem.xs.shape),
                    tuple(server.engine.problem.xs.shape),
                    None if server._store is None
                    else server._store.num_tasks)
    stats = server.stats()
    stats["slo"] = None
    res["stats"] = stats
    res["wire"] = server.wire_stats()
    res["breaker"] = server.breaker_tripped
    res["max_rss"] = max_rss_bytes()
    res["device_peak"] = (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0)
    res["total_s"] = time.perf_counter() - t0
    del server, store, start
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _main_ident() -> int:
    return threading.main_thread().ident


def session(spec: dict, extra_ops: dict | None = None) -> list[dict]:
    """Run the spec's servers in this rank, with the further `extra_ops`
    (see the module doc)."""
    t0 = time.perf_counter()
    dev = resolve_device(spec["device"])
    mesh = make_task_mesh(device=dev)
    problem, rows = _problem(spec["problem"], mesh)
    if mesh.size == 1:
        problem = problem.to(dev)
    batches = []
    if "traffic" in spec:
        p, tr = spec["problem"], spec["traffic"]
        batches = traffic(rows, p["t"], p["d"], tr["seed"], tr["batches"],
                          tr["rows"])
    setup_s = time.perf_counter() - t0
    with HostPeak(0.01) as peak:
        out = [run_server(spec, run, problem, batches, mesh, dev, extra_ops)
               for run in spec["servers"]]
    out[0].update(setup_s=setup_s, servers_host_peak=peak.peak)
    return out
