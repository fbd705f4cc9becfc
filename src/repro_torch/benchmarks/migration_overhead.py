"""§5.3 analogue: layout-aware migration plan vs naive full re-gather.

Measures (a) planned transfer bytes vs the naive gather-everything-
rebroadcast strategy across layout transitions, and (b) wall time of the
real migration executor on the shared-memory plane.

Twin of ``benchmarks/migration_overhead.py`` on the port: GFC's shared-
memory plane moves numpy buffers between rank threads on the host and
takes no device; its byte counts equal the JAX script's, its times are
the host's.

    python -m repro_torch.benchmarks.migration_overhead [--out DIR]
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core.gfc import GroupFreeComm
from repro_torch.core.migration import (execute_migration, plan_bytes,
                                        plan_migration)
from repro_torch.core.trajectory import Artifact, ExecutionLayout, FieldSpec
from repro_torch.diffusion.adapters import field_view

RESULTS = common.RESULTS

TRANSITIONS = [((0, 1, 2, 3), (0, 1)), ((0, 1), (0, 1, 2, 3)),
               ((0, 1, 2, 3), (4, 5)), ((0,), (0, 1, 2, 3)),
               ((0, 1, 2, 3), (2, 3, 4, 5))]
N_TOK, D = 4096, 64


def run(out_dir=None) -> dict:
    out = {}
    for src_ranks, dst_ranks in TRANSITIONS:
        src, dst = ExecutionLayout(src_ranks), ExecutionLayout(dst_ranks)
        fields = {"latent": FieldSpec("sharded", (N_TOK, D), "float32", 0)}
        entries = plan_migration(fields, src, dst)
        planned = plan_bytes(entries)
        naive = N_TOK * D * 4 * (1 + len(dst_ranks))   # gather + rebroadcast
        key = f"{len(src_ranks)}to{len(dst_ranks)}" + \
            ("_disjoint" if not set(src_ranks) & set(dst_ranks) else "")
        out[f"planned_bytes_{key}"] = planned
        out[f"naive_bytes_{key}"] = naive

        # real execution wall time
        art = Artifact(id="a", request_id="r", role="latent",
                       fields=fields, layout=src)
        full = np.random.default_rng(0).standard_normal(
            (N_TOK, D)).astype(np.float32)
        view = field_view(fields["latent"], src)
        art.data = {r: {"latent": full[o:o + s].copy()}
                    for r, (o, s) in view.slices.items()}
        comm = GroupFreeComm(8)
        t0 = time.perf_counter()
        execute_migration(comm, art, dst, entries)
        out[f"exec_us_{key}"] = (time.perf_counter() - t0) * 1e6
    (common.out_dir(out_dir, RESULTS) / "migration_overhead.json").write_text(
        json.dumps(out, indent=1))
    return out


def rows(data: dict):
    out = []
    for k, v in data.items():
        if k.startswith("planned"):
            key = k[len("planned_bytes_"):]
            save = 1 - v / data[f"naive_bytes_{key}"]
            out.append((f"migration.{key}", data[f"exec_us_{key}"],
                        f"bytes_saved_vs_naive={save:.0%}"))
    return out


if __name__ == "__main__":
    sys.exit(common.main(sys.modules[__name__]))
