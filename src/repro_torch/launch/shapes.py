"""The four input shapes of the dry run, their applicability matrix, and
the batch structures (port of `repro/launch/shapes.py`).

`batch_struct` gives each model input as a `(shape, torch.dtype)` pair
with the reference's names, shapes and dtypes (its `ShapeDtypeStruct`s),
allocating nothing.  `concrete_batch` draws a batch of those names,
shapes, dtypes and ranges from numpy, seeded by `seed` and the input's
name; it is not `jax.random`'s draw of the reference's.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

Struct = tuple[tuple[int, ...], torch.dtype]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs, the reason it is skipped): an encoder has no decode, and
    only a sub-quadratic arch takes long_500k."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full attention: long_500k requires sub-quadratic"
    return True, ""


def batch_struct(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Struct]:
    """The training / prefill batch's inputs as (shape, dtype)."""
    b, s = shape.batch, shape.seq
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        batch = {"features": ((b, s, cfg.feature_dim), dtype),
                 "mask": ((b, s), torch.bool),
                 "targets": ((b, s), torch.int32)}
    else:
        batch = {"tokens": ((b, s), torch.int32),
                 "targets": ((b, s), torch.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = ((b, cfg.vision_seq, cfg.d_model), dtype)
    if shape.kind == "train":
        batch["task_ids"] = ((b,), torch.int32)
        batch["mtl_targets"] = ((b,), torch.float32)
    return batch


def decode_structs(cfg: ArchConfig, shape: ShapeSpec) -> tuple[Struct,
                                                                 Struct]:
    """(token, pos) of a decode step; the cache comes from
    `serving.init_cache(..., device="meta")`."""
    return ((shape.batch, 1), torch.int32), ((), torch.int32)


def struct_bytes(structs) -> int:
    """The bytes of (shape, dtype) pairs."""
    return sum(math.prod(s) * torch.empty((), dtype=d).element_size()
               for s, d in structs)


def concrete_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int,
                   num_tasks: Optional[int] = None) -> dict[str,
                                                            torch.Tensor]:
    """A random batch on the CPU: token ids and targets uniform in the
    vocabulary, task ids in [0, num_tasks or cfg.mtl.num_tasks), the mask
    Bernoulli(0.3), other int32 inputs zero, float inputs 0.05 N(0, 1) in
    their dtype; each input from numpy seeded by (seed, crc32 of its
    name)."""
    t = num_tasks or cfg.mtl.num_tasks
    out = {}
    for name, (shp, dt) in batch_struct(cfg, shape).items():
        rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
        if name in ("tokens", "targets"):
            a = rng.integers(0, cfg.vocab_size, shp)
        elif name == "task_ids":
            a = rng.integers(0, t, shp)
        elif name == "mask":
            a = rng.random(shp) < 0.3
        elif dt == torch.int32:
            a = np.zeros(shp)
        else:
            a = 0.05 * rng.standard_normal(shp, dtype=np.float32)
        out[name] = torch.as_tensor(a).to(dt)
    return out
