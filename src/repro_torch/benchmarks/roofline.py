"""Deliverable (g): 3-term roofline per (arch x shape) from the dry-run,
plus the fast-path kernel-traffic model (DESIGN.md §12).

  compute term    = HLO_FLOPs / (chips x peak_FLOP/s)
  memory term     = HLO_bytes / (chips x HBM_bw)
  collective term = collective_bytes / (chips x link_bw)

Twin of ``benchmarks/roofline.py`` on the port, with the H100's
constants in place of the TPU v5e's.  The cells come from the port's
dry run (``repro_torch.launch.dryrun``: its ``--out`` JSON, by default
``build/dryrun/dryrun.json``, or a directory of ``cells-*.json`` such as
``chip_smoke.py``'s ``build/dryrun/``).  Its ``flops`` and ``hlo_bytes``
are rank 0's local ops, traced on ``meta`` tensors under the cell's mesh:
``flops`` by ``torch.utils.flop_counter``, and ``hlo_bytes`` the operand
and result bytes of every local op, op by op, which stands where JAX's
``hlo_bytes`` (XLA's ``cost_analysis`` of the partitioned module) stands.
Both are per device already, so the terms divide by one device's rates
(the "chips x" division happened in partitioning).  Collective bytes are
the traced collectives' payloads by kind.

MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE) tokens-processed model
flops; the ratio MODEL_FLOPS/HLO_FLOPs measures how much traced compute
is useful (remat/recompute waste shows up here; ~1/4 is expected for
remat=full training: fwd 2ND + bwd 4ND + remat 2ND per token).

The kernel-traffic section models per-denoise-step HBM bytes for the
served DiT request classes under the fused kernels (K1-K3) versus an
unfused plain-op path, and ASSERTS fused < unfused for every shape —
the gate for the fast path's raison d'etre (the flash kernel never
writes the N^2 score matrix, the fused adaLN halves elementwise passes,
and the §11 splice kernel never materializes the concatenated KV).  The
bytes do not depend on the chip: they equal the JAX script's; the
``*_hbm_s`` times divide them by the H100's HBM rate.  Results land in
``roofline.json`` and ``kernel_traffic.json`` of the output directory.

    python -m repro_torch.benchmarks.roofline [--cells PATH] [--out DIR]
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

from repro_torch.benchmarks import common
from repro_torch.configs import SHAPES, get_config

RESULTS = common.RESULTS
#: the dry run's default output (``python -m repro_torch.launch.dryrun``)
DRYRUN = RESULTS.parent / "dryrun" / "dryrun.json"

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS = 989e12          # bf16 on the tensor cores, per GPU
FP32_FLOPS = 67e12           # fp32 on the CUDA cores (no tensor cores)
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU
ICI_BW = 900e9               # NVLink 4, bytes/s per GPU (all links)


def load_cells(path: Path | None = None) -> list[dict]:
    """The ``ok`` cells of a dry-run JSON file, or of every
    ``cells-*.json`` in a directory."""
    path = Path(path or DRYRUN)
    files = sorted(path.glob("cells-*.json")) if path.is_dir() else [path]
    return [r for f in files if f.exists()
            for r in json.loads(f.read_text()) if r["ok"]]


def _chips(mesh: str) -> int:
    """Devices of a mesh named like ``16x16`` (the dry run's names; JAX's
    script takes 256, its single pod, for every cell)."""
    return math.prod(int(n) for n in mesh.split("x"))


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    cell = SHAPES[shape]
    n_active = cfg.param_count(active_only=True)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


def analyze(cells: list[dict]) -> list[dict]:
    out = []
    for r in cells:
        coll_bytes = sum(r["collective_bytes"].values())
        compute_s = r["flops"] / PEAK_FLOPS
        memory_s = r["hlo_bytes"] / HBM_BW
        coll_s = coll_bytes / ICI_BW
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": coll_s}
        dominant = max(terms, key=terms.get)
        bound = max(terms.values())
        mf = model_flops(r["arch"], r["shape"]) / _chips(r["mesh"])
        out.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant,
            "model_flops_per_dev": mf,
            "useful_ratio": mf / r["flops"] if r["flops"] else 0.0,
            # fraction of roofline-bound time that is compute: how close
            # the cell is to being compute-limited (the perf score axis)
            "roofline_fraction": compute_s / bound if bound else 0.0,
            "per_device_memory_gb": r["per_device_memory_bytes"] / 2**30,
        })
    return out


# ---------------------------------------------------------------------------
# Fast-path kernel-traffic model (DESIGN.md §12)
# ---------------------------------------------------------------------------

DTYPE_BYTES = 2              # bf16 serving activations

#: served request classes (configs/dit_models.py docstring):
#: Qwen-Image-style S/M/L squares; Wan-style S/M/L videos.
REQUEST_CLASSES = [
    ("dit-image", "img_S", 512, 512, 0),
    ("dit-image", "img_M", 1024, 1024, 0),
    ("dit-image", "img_L", 1536, 1536, 0),
    ("dit-video", "vid_S", 480, 832, 49),
    ("dit-video", "vid_M", 480, 832, 81),
    ("dit-video", "vid_L", 720, 1280, 81),
]


def kernel_traffic_cell(cfg, label: str, h: int, w: int, f: int) -> dict:
    """Modeled HBM bytes for ONE denoise step of one request, fused vs
    unfused.  Counts whole-activation HBM passes (read or write of an
    (N, D) activation = one pass); O(D) modulation vectors are ignored.

      attention   unfused: QKVO + the score round trips — write S, read
                  S, write P, read P = 4*H*N^2 elements on top of QKVO.
                  fused (flash): QKVO only; softmax stats stay in
                  shared memory and registers.
      adaLN       per block 2 modulated-norms (LN pass + modulate pass =
                  4 unfused vs 2 fused) and 2 gated residuals (mul pass
                  + add pass = 5 unfused vs 3 fused); final layer one
                  modulated-norm.
      §11 splice  unfused materializes splice(stale, fresh) for K and V
                  (write + re-read by attention = 4*N*H*d extra
                  elements); fused streams stale and patches fresh
                  in-register.
    """
    from repro_torch.models import dit

    n = dit.token_count(cfg, h, w, f)
    H, d, D, L, e = (cfg.num_heads, cfg.head_dim, cfg.d_model,
                     cfg.num_layers, DTYPE_BYTES)
    qkvo = 4 * n * H * d * e
    score_rt = 4 * H * n * n * e
    attn_unfused = L * (qkvo + score_rt)
    attn_fused = L * qkvo
    nde = n * D * e
    adaln_unfused = L * (2 * 4 + 2 * 5) * nde + 4 * nde
    adaln_fused = L * (2 * 2 + 2 * 3) * nde + 2 * nde
    splice_extra = L * 4 * n * cfg.num_kv_heads * d * e
    unfused = attn_unfused + adaln_unfused + splice_extra
    fused = attn_fused + adaln_fused
    return {
        "model": cfg.name, "class": label, "tokens": n,
        "attn_unfused_bytes": attn_unfused, "attn_fused_bytes": attn_fused,
        "adaln_unfused_bytes": adaln_unfused,
        "adaln_fused_bytes": adaln_fused,
        "splice_saved_bytes": splice_extra,
        "unfused_bytes": unfused, "fused_bytes": fused,
        "traffic_ratio": unfused / fused,
        "fused_hbm_s": fused / HBM_BW,
        "unfused_hbm_s": unfused / HBM_BW,
    }


def kernel_traffic() -> list[dict]:
    from repro_torch.configs.dit_models import DIT_IMAGE, DIT_VIDEO

    cfgs = {"dit-image": DIT_IMAGE, "dit-video": DIT_VIDEO}
    table = [kernel_traffic_cell(cfgs[m], label, h, w, f)
             for m, label, h, w, f in REQUEST_CLASSES]
    for row in table:
        # the CI gate: the fused path must win on modeled traffic for
        # every served shape, strictly
        assert row["fused_bytes"] < row["unfused_bytes"], row
    return table


def run(out_dir=None, cells=None) -> dict:
    table = analyze(load_cells(cells))
    ktable = kernel_traffic()
    results = common.out_dir(out_dir, RESULTS)
    (results / "roofline.json").write_text(json.dumps(table, indent=1))
    (results / "kernel_traffic.json").write_text(
        json.dumps(ktable, indent=1))
    return {"table": table, "kernel_traffic": ktable}


def rows(data: dict):
    out = []
    for row in data["table"]:
        out.append((
            f"roofline.{row['arch']}.{row['shape']}",
            row["compute_s"] * 1e6,
            f"dom={row['dominant']};mem_s={row['memory_s']:.2e};"
            f"coll_s={row['collective_s']:.2e};"
            f"useful={row['useful_ratio']:.2f};"
            f"roofline_frac={row['roofline_fraction']:.2f}"))
    for row in data["kernel_traffic"]:
        out.append((
            f"kernel_traffic.{row['model']}.{row['class']}",
            row["fused_hbm_s"] * 1e6,
            f"tokens={row['tokens']};"
            f"fused_mb={row['fused_bytes'] / 2**20:.1f};"
            f"unfused_mb={row['unfused_bytes'] / 2**20:.1f};"
            f"ratio={row['traffic_ratio']:.2f}"))
    return out


def main(argv=None) -> int:
    ap = common.parser(sys.modules[__name__])
    ap.add_argument("--cells", default=None,
                    help=f"dry-run JSON, or a directory of cells-*.json "
                         f"(default {DRYRUN})")
    args = ap.parse_args(argv)
    common.print_rows(rows(run(out_dir=args.out, cells=args.cells)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
