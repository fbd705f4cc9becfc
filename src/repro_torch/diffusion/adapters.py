"""Model adapters (paper §5.2): request converter + task executors +
artifact codecs behind a narrow interface, so policies never see model
internals and new pipelines only add an adapter.

The converter records each denoise task's exact token count in
``task.meta["tokens"]``; together with the request's model name it forms
the *pack signature* (``core/scheduler.py::pack_signature``) that
decides which denoise steps may share one batched executor call
(DESIGN.md §9 step packing).  Executors that support packing expose
``execute_packed`` next to ``execute`` (see ``diffusion/pipeline.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.trajectory import (Artifact, ExecutionLayout, FieldSpec,
                                   Request, RequestGraph, TrajectoryTask,
                                   fresh_id)


# ---------------------------------------------------------------------------
# Request converter: request -> trajectory task graph (§5.2)
# ---------------------------------------------------------------------------

def convert_request(req: Request, cfg: ModelConfig) -> RequestGraph:
    """encode -> denoise_0..denoise_{n-1} -> decode, linked by artifacts."""
    dc = cfg.dit
    f = req.frames
    f_lat = max(1, (f + 3) // 4) if f > 1 else 1
    h_lat, w_lat = req.height // 8, req.width // 8
    n_tok = f_lat * (h_lat // dc.patch_size) * (w_lat // dc.patch_size)
    patch_dim = dc.patch_size * dc.patch_size * dc.in_channels

    artifacts: dict[str, Artifact] = {}
    tasks: dict[str, TrajectoryTask] = {}

    def art(role: str, fields: dict[str, FieldSpec]) -> Artifact:
        a = Artifact(id=fresh_id("art"), request_id=req.id, role=role,
                     fields=fields)
        artifacts[a.id] = a
        return a

    txt_fields = {
        "embeds": FieldSpec("replicated", (77, dc.cond_dim), "float32"),
    }
    if req.guidance is not None:
        # classifier-free guidance (DESIGN.md §14): the null-prompt
        # branch embedding must be DECLARED so the migration planner
        # carries it between layouts like any replicated field
        txt_fields["embeds_uncond"] = FieldSpec(
            "replicated", (77, dc.cond_dim), "float32")
    txt = art("text_embeds", txt_fields)
    enc = TrajectoryTask(id=fresh_id("task"), request_id=req.id,
                         kind="encode", outputs=[txt.id],
                         meta={"tokens": n_tok})
    tasks[enc.id] = enc

    prev_latent = art("latent", {
        "latent": FieldSpec("sharded", (n_tok, patch_dim), "float32", 0),
        "sigma": FieldSpec("meta"),
    })
    # the initial noisy latent is produced by the encode task (latent prep)
    enc.outputs.append(prev_latent.id)

    for step in range(req.steps):
        nxt = art("latent", {
            "latent": FieldSpec("sharded", (n_tok, patch_dim), "float32", 0),
            "sigma": FieldSpec("meta"),
        })
        t = TrajectoryTask(id=fresh_id("task"), request_id=req.id,
                           kind="denoise", step_index=step,
                           inputs=[txt.id, prev_latent.id],
                           outputs=[nxt.id],
                           meta={"tokens": n_tok, "step": step,
                                 "latent_shape": (f_lat, h_lat, w_lat,
                                                  dc.in_channels)})
        tasks[t.id] = t
        prev_latent = nxt

    # cross-step feature cache (DESIGN.md §11): a side artifact — NOT an
    # input of any task, so it never gates readiness — holding, per
    # rank, the per-layer gathered K/V snapshot of the last refresh
    # step.  Replicated fields: every rank's copy is the bit-identical
    # snapshot of one gather, which is what lets a same-degree
    # Reallocate move a warm cache through the ordinary migration
    # planner.  The codec-declared shapes also give the planner/cost
    # model an honest byte count for pricing that move.
    kv_fields: dict[str, FieldSpec] = {}
    for layer in range(cfg.num_layers):
        for f in ("k", "v"):
            kv_fields[f"{f}{layer}"] = FieldSpec(
                "replicated", (n_tok, cfg.num_kv_heads, cfg.head_dim),
                "float32")
    art("kv_cache", kv_fields)

    out = art("output", {
        "pixels": FieldSpec("replicated",
                            (f_lat, h_lat * 8, w_lat * 8, 3), "float32"),
    })
    dec = TrajectoryTask(id=fresh_id("task"), request_id=req.id,
                         kind="decode", inputs=[prev_latent.id],
                         outputs=[out.id],
                         meta={"tokens": n_tok})
    tasks[dec.id] = dec
    req.task_ids = list(tasks)
    return RequestGraph(request=req, tasks=tasks, artifacts=artifacts)


# ---------------------------------------------------------------------------
# Artifact codecs (§5.2): layout views for the migration planner
# ---------------------------------------------------------------------------

@dataclass
class FieldView:
    """Per-rank ownership of one artifact field under a layout."""
    kind: str
    global_shape: tuple[int, ...]
    shard_axis: int
    # rank -> (offset, size) along shard_axis
    slices: dict[int, tuple[int, int]]


def field_view(spec: FieldSpec, layout: ExecutionLayout) -> FieldView:
    """Equal contiguous split along shard_axis (replicated -> every rank
    owns the full range).

    Under a CFG shape (``layout.cfg > 1``, DESIGN.md §14) the split runs
    over one branch's ``sp`` ranks and repeats per branch: the rank at
    branch-local index ``i`` of EVERY branch owns SP-slice ``i``, so
    branch peers hold the same token range (the merged velocity is
    identical across branches, making shards replicated across the CFG
    dimension)."""
    if spec.kind != "sharded" or layout.sp == 1:
        full = spec.global_shape[spec.shard_axis] if spec.global_shape \
            else 0
        return FieldView(spec.kind, spec.global_shape, spec.shard_axis,
                         {r: (0, full) for r in layout.ranks})
    n = spec.global_shape[spec.shard_axis]
    k = layout.sp
    base, rem = divmod(n, k)
    slices = {}
    off = 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        for b in range(layout.cfg):
            slices[layout.branch_ranks(b)[i]] = (off, size)
        off += size
    return FieldView("sharded", spec.global_shape, spec.shard_axis, slices)
