"""Dry run of every (arch x shape) on the meta device: the byte counts of
each combo, with nothing allocated (the twin of `repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --kv-int8 \
        --out build/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \
        --shape decode_32k --kv-int8

For each combo of `configs.ARCH_NAMES` x `launch.shapes.SHAPES` (or the
one `--arch`, `--shape`) it writes one JSON row, appended to `--out` or
printed: the reference's `arch`, `shape`, `mesh`, `status` ("ok", or
"skip" with `applicable`'s `reason`), `kv_cache` ("int8" with --kv-int8,
else "model"), `params_total` and `params_active` (`param_counts`, the
routed experts counted at top_k / num_experts), and the port's own bytes:
`param_bytes` (every leaf in its dtype), `batch_bytes` (the batch of
`shapes.batch_struct`, or a decode step's token and position),
`opt_state_bytes` on a train shape (`launch.steps.default_optimizer`'s
state) and `cache_bytes` on a decode shape (`serving.init_cache` at the
shape's batch and length).  Every tensor it makes is on the meta device,
so it runs the same on a machine with a card or without one, and
touches neither.

The reference lowers and compiles each combo under XLA on a 16 x 16 mesh
and reads HLO memory and cost analyses and collective bytes; that has no
PyTorch twin here, and the mesh comes with the sharded LM (ROADMAP item
11(i)).  So `mesh` reads "1": one device, nothing sharded.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import shapes as shp
from repro_torch.launch.steps import default_optimizer
from repro_torch.models import serving
from repro_torch.models.transformer import param_dtypes, param_shapes
from repro_torch.optim.optimizers import tree_build, tree_items

EXPERT_LEAVES = ("w_in", "w_out", "w_gate")


def param_counts(cfg: ArchConfig) -> tuple[float, float]:
    """(total params, active params): a routed expert weight (a
    .moe.{w_in, w_out, w_gate} leaf) counts at top_k / num_experts among
    the active ones."""
    total = expert_n = 0
    for path, shape in param_shapes(cfg).items():
        n = math.prod(shape)
        total += n
        names = path.split(".")
        if "moe" in names and names[-1] in EXPERT_LEAVES:
            expert_n += n
    active = total
    if cfg.moe:
        active = total - expert_n + expert_n * cfg.moe.top_k \
            / cfg.moe.num_experts
    return float(total), float(active)


def meta_params(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors in their dtypes."""
    dtypes = param_dtypes(cfg)
    return tree_build((tuple(path.split(".")),
                       torch.empty(shape, dtype=dtypes[path], device="meta"))
                      for path, shape in param_shapes(cfg).items())


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (dicts and NamedTuples of tensors;
    None leaves count nothing)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(tree_bytes(v) for v in tree if v is not None)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def run_combo(arch: str, shape_name: str, kv_int8: bool = False) -> dict:
    cfg = get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    shape = shp.SHAPES[shape_name]
    row = {"arch": arch, "shape": shape_name, "mesh": "1",
           "kv_cache": cfg.kv_cache_dtype}
    ok, reason = shp.applicable(cfg, shape)
    if not ok:
        row.update(status="skip", reason=reason)
        return row
    params = meta_params(cfg)
    total, active = param_counts(cfg)
    row.update(status="ok", params_total=total, params_active=active,
               param_bytes=tree_bytes(params))
    if shape.kind == "decode":
        row["batch_bytes"] = shp.struct_bytes(shp.decode_structs(cfg, shape))
        row["cache_bytes"] = tree_bytes(serving.init_cache(
            cfg, shape.batch, shape.seq, device="meta"))
    else:
        row["batch_bytes"] = shp.struct_bytes(
            shp.batch_struct(cfg, shape).values())
    if shape.kind == "train":
        opt = default_optimizer(cfg)
        row["opt_state_bytes"] = sum(
            leaf.numel() * leaf.element_size()
            for _, leaf in tree_items(opt.init(params)))
    return row


def main(argv: Optional[list[str]] = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(shp.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV caches (decode combos)")
    ap.add_argument("--out", default=None,
                    help="append the rows to this file (default: print)")
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s) for a in ARCH_NAMES for s in shp.SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --all, or --arch and --shape")
    rows = [run_combo(a, s, args.kv_int8) for a, s in combos]
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    else:
        for r in rows:
            print(json.dumps(r))
    ok = sum(r["status"] == "ok" for r in rows)
    print(f"[dryrun] done: {len(rows)} combos, {ok} ok, {len(rows) - ok} "
          "skip")
    return rows


if __name__ == "__main__":
    main()
