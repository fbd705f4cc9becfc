#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves DiT-image on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: the CUDA kernels of ``src/repro_torch/csrc`` with nvcc, before
   any engine starts (a first-use build inside a rank thread would
   outlast GFC's collective timeout).
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's full-width DIT_IMAGE shapes, fp32 and bf16, with
   kernel, plain-version and one-PyTorch-call times from CUDA events.
4. serve: ``ServingEngine(DIT_IMAGE, SP-4, cache_interval=2)`` at full
   width serves two 512 px and one 1024 px request; every request must
   finish with finite pixels, through all three kernels, with both §11
   refresh and hit steps.
5. sp: one 512 px request at SP1 and SP4 (cache_interval=1) agree.
6. cpu: on DIT_IMAGE.reduced() the card (kernels) and the CPU (plain
   versions) give the same pixels.

The line before the last is the ``kernels`` JSON summary; the last line
is ``{"ok": true, "device": {...}}``.  Exits 2 without CUDA.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.core.scheduler import Decision, Policy  # noqa: E402
from repro_torch.core.trajectory import ExecutionLayout, Request  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12           # CUDA cores; the kernels use no TF32
BUDGET = {torch.float32: 1e-5, torch.bfloat16: 3e-2}   # DESIGN.md §12
PIXEL_BUDGET = 1e-4                # rel-L2 on decoded pixels
SOURCES = {
    "fused_adaln": ("src/repro_torch/csrc/adaln.cu",
                    "src/repro/kernels/adaln.py:66"),
    "attention": ("src/repro_torch/csrc/attention.cu",
                  "src/repro/kernels/flash_attention.py:82"),
    "splice_attention": ("src/repro_torch/csrc/attention.cu",
                         "src/repro/kernels/splice.py:78"),
}


class FixedSP(Policy):
    """Encode/decode on one rank, every denoise step on ``k`` ranks."""
    name = "fixed-sp"

    def __init__(self, k):
        self.k = k

    def schedule(self, view):
        out, free = [], list(view.free_ranks)
        for t, req, g in sorted(view.ready, key=lambda x: x[0].id):
            k = 1 if t.kind in ("encode", "decode") else self.k
            if len(free) < k:
                break
            out.append(Decision(t.id, ExecutionLayout(tuple(free[:k]))))
            free = free[k:]
        return out


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after warm-up; inputs stay warm in L2 as on the serving path)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def liven(pipeline, seed: int = 123):
    """Give the adaLN-Zero gates and the zero output head small seeded
    values (as repro/serving/cache_demo.py does), scaled by d_model^-1/2
    so that the modulation has the size it has at the reduced width.
    Otherwise the DiT outputs exactly zero and a run proves nothing."""
    model = pipeline.dit
    scale = 0.05 * math.sqrt(128 / pipeline.cfg.d_model)
    gen = torch.Generator().manual_seed(seed)
    params = [p for blk in model.blocks for p in (blk.ada_w, blk.ada_b)]
    params += [model.final_ada_w, model.final_ada_b, model.final_out]
    with torch.no_grad():
        for p in params:
            p.copy_(scale * torch.randn(p.shape, generator=gen))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 off", flush=True)
    return smi


def phase_build() -> None:
    """Build and load the kernels; ptxas's full report (registers, shared
    memory, spills) is written beside the library as a ``.log`` file."""
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    log = build.build_info.get("ptxas", "")
    spills = [ln.strip() for ln in log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"build: {seconds:.1f} s ({build.build_info.get('seconds', 0):.1f} s"
          f" nvcc), {len(spills)} ptxas lines with spills (report in "
          f"{build.BUILD_DIR}/libgfdit-*.log)", flush=True)


def _rand(shape, dtype, gen, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)


def _check(label, kernel, plain, dtype, results, timing=None):
    out_k, out_p = kernel(), plain()
    torch.cuda.synchronize()
    diff = (out_k.float() - out_p.float()).abs().max().item()
    rel = diff / max(out_p.float().abs().max().item(), 1e-30)
    ok = math.isfinite(rel) and rel <= BUDGET[dtype]
    line = (f"  {label} {str(dtype)[6:]}: max rel err {rel:.2e} "
            f"(budget {BUDGET[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
    if timing is not None:
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        lib = timing.get("library")
        lib_ms = time_ms(lib) if lib is not None else None
        b_ms, b_by = bound_ms(timing["bytes"], timing["flops"])
        line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                 f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                 f", bound {b_ms:.4f} ms ({b_by})")
        if timing.get("summary"):
            results[timing["summary"]] = {
                "max_abs_err": diff, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "case": label}
    print(line, flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version ({rel:.2e} > {BUDGET[dtype]:.0e})")


def phase_kernels() -> dict:
    """Every kernel against its plain version at the serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: dict = {}
    d_model, heads, hd = DIT_IMAGE.d_model, DIT_IMAGE.num_heads, \
        DIT_IMAGE.head_dim
    print("kernels:", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        fp32 = dtype == torch.float32
        # K1: every adaLN variant at the SP-4 shard (1024) and SP-1 (4096)
        for n in (1024, 4096):
            x = _rand((1, n, d_model), dtype, gen)
            res = _rand((1, n, d_model), dtype, gen)
            sh, sc, g = (_rand((1, d_model), dtype, gen, 0.5)
                         for _ in range(3))
            variants = {
                "mod_norm": dict(shift=sh, scale=sc),
                "ln": dict(),
                "gated_residual": dict(gate=g, residual=res, ln=False),
                "full": dict(shift=sh, scale=sc, gate=g, residual=res),
            }
            for vname, kw in variants.items():
                timing = None
                if n == 1024:
                    rows = 2 + ("residual" in kw)       # x, out, residual
                    mod_rows = len({"shift", "scale", "gate"} & set(kw))
                    timing = {"bytes": (rows * n + mod_rows) * d_model * es,
                              "flops": {"mod_norm": 8, "ln": 6,
                                        "gated_residual": 2,
                                        "full": 10}[vname] * n * d_model}
                    if vname == "mod_norm":
                        w, b = (1.0 + sc[0]).contiguous(), sh[0].contiguous()
                        timing["library"] = (
                            lambda x=x, w=w, b=b: F.layer_norm(
                                x, (d_model,), w, b, eps=1e-6))
                        if fp32:
                            timing["summary"] = "fused_adaln"
                _check(f"adaln {vname} N={n} D={d_model}",
                       lambda x=x, kw=kw: ops.fused_adaln(x, **kw),
                       lambda x=x, kw=kw: ref.adaln_ref(x, **kw),
                       dtype, results, timing)
        # K2: the SP-4 self-attention shard over the gathered K/V, the
        # cross-attention to 77 text tokens, the text encoder (d=256), a
        # causal case and a GQA case
        cases = [
            ("self", (1, 1024, heads, hd), (1, 4096, heads, hd), False),
            ("cross Lt=77", (1, 1024, heads, hd), (1, 77, heads, hd), False),
            ("text-encoder d=256", (1, 77, 4, 256), (1, 77, 4, 256), False),
            ("causal", (1, 1024, heads, hd), (1, 1024, heads, hd), True),
            ("gqa H=24 KV=6", (1, 1000, heads, hd), (1, 1000, 6, hd), False),
        ]
        for label, qs, ks, causal in cases:
            q, k, v = (_rand(s, dtype, gen) for s in (qs, ks, ks))
            b, sq, h, d = qs
            sk = ks[1]
            pairs = sq * (sq + 1) // 2 if causal else sq * sk
            timing = None
            if label == "self":
                timing = {
                    "bytes": (2 * q.numel() + k.numel() + v.numel()) * es,
                    "flops": 4 * b * h * d * pairs,
                    "library": lambda q=q, k=k, v=v:
                        F.scaled_dot_product_attention(
                            q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))}
                if fp32:
                    timing["summary"] = "attention"
            _check(f"attention {label} q{qs} kv{ks}",
                   lambda q=q, k=k, v=v, c=causal: ops.attention(
                       q, k, v, causal=c),
                   lambda q=q, k=k, v=v, c=causal: ref.attention_ref(
                       q, k, v, causal=c),
                   dtype, results, timing)
        # K3: the §11 hit at SP-4 of a 4096-token request, first, a middle
        # and the last shard
        q = _rand((1, 1024, heads, hd), dtype, gen)
        ks_, vs_ = (_rand((1, 4096, heads, hd), dtype, gen) for _ in range(2))
        kf, vf = (_rand((1, 1024, heads, hd), dtype, gen) for _ in range(2))
        for offset in (0, 2048, 3072):
            timing = None
            if offset == 2048:
                timing = {"bytes": (2 * q.numel() + ks_.numel()
                                    + vs_.numel()) * es,
                          "flops": 4 * heads * hd * 1024 * 4096}
                if fp32:
                    timing["summary"] = "splice_attention"
            _check(f"splice offset={offset} q(1,1024) stale(1,4096)",
                   lambda o=offset: ops.splice_attention(
                       q, ks_, vs_, kf, vf, offset=o),
                   lambda o=offset: ref.splice_attention_ref(
                       q, ks_, vs_, kf, vf, offset=o),
                   dtype, results, timing)
    return results


def _serve(cfg, policy, reqs, *, cache_interval, device="cuda", setup=None,
           during=contextlib.nullcontext):
    """Serve ``reqs`` on a fresh four-rank engine with livened weights.
    ``setup(engine)`` runs before serving; the timed serve runs inside the
    context manager ``during()`` (serve_profile.py passes a profiler)."""
    eng = ServingEngine(cfg, policy, 4, cache_interval=cache_interval,
                        device=device)
    try:
        liven(eng.pipeline)
        if setup is not None:
            setup(eng)
        if device == "cuda":
            torch.cuda.synchronize()
        with during():
            t0 = time.perf_counter()
            metrics = eng.serve(reqs, timeout=600)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        pixels = {r.id: eng.result_pixels(r) for r in reqs}
        modes = [e.get("cache") for e in eng.cp.events
                 if e["ev"] == "dispatch" and e["kind"] == "denoise"]
        lat = {rid: req.done_time - req.arrival
               for rid, req in eng.cp.requests.items()
               if req.done_time is not None}
        return {"metrics": metrics, "wall": wall, "pixels": pixels,
                "modes": modes, "latency": lat, "engine": eng}
    finally:
        eng.shutdown()


def make_request(rid, res, steps=4):
    return Request(id=rid, model="dit-image", height=res, width=res,
                   frames=1, steps=steps, arrival=0.0)


def serve_requests() -> list:
    """The serve phase's traffic: two 512 px and one 1024 px request."""
    return [make_request("img512-a", 512), make_request("img512-b", 512),
            make_request("img1024", 1024)]


def phase_serve() -> dict:
    reqs = serve_requests()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run = _serve(DIT_IMAGE, FixedSP(4), reqs, cache_interval=2)
    counts = dict(ops.launches)
    del run["engine"]
    for r in reqs:
        px = run["pixels"][r.id]
        if px is None or px.shape != (1, r.height, r.width, 3) \
                or not np.isfinite(px).all():
            raise AssertionError(f"{r.id}: no finite pixels of the "
                                 f"expected shape")
    if run["metrics"]["completed"] != len(reqs):
        raise AssertionError(f"completed {run['metrics']['completed']} of "
                             f"{len(reqs)}")
    if not {"refresh", "hit"} <= set(run["modes"]):
        raise AssertionError(f"cache modes {run['modes']}: expected "
                             f"refresh and hit steps")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {counts}")
    lat = ", ".join(f"{k} {v:.2f} s" for k, v in sorted(run["latency"].items()))
    print(f"serve: DIT_IMAGE full width ({DIT_IMAGE.num_layers} layers, "
          f"d={DIT_IMAGE.d_model}), SP-4, cache_interval=2, steps=4: "
          f"{len(reqs)} done; latency {lat}; wall {run['wall']:.2f} s; "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"cache {run['modes'].count('refresh')} refresh / "
          f"{run['modes'].count('hit')} hit; launches {counts}", flush=True)
    return counts


def phase_sp() -> None:
    req = make_request("sp-check", 512)
    px = {}
    for k in (1, 4):
        run = _serve(DIT_IMAGE, FixedSP(k), [req], cache_interval=1)
        del run["engine"]
        px[k] = run["pixels"][req.id]
        torch.cuda.empty_cache()
    err = rel_l2(px[4], px[1])
    print(f"sp: 512 px at SP1 vs SP4 (cache_interval=1): pixel rel-L2 "
          f"{err:.2e} (budget {PIXEL_BUDGET:.0e})", flush=True)
    if not err <= PIXEL_BUDGET:
        raise AssertionError(f"SP1 vs SP4 rel-L2 {err:.2e}")


def phase_cpu() -> None:
    cfg = DIT_IMAGE.reduced()
    req = make_request("cpu-check", 128, steps=3)
    cpu = _serve(cfg, FixedSP(2), [req], cache_interval=2, device="cpu")

    def copy_weights(eng):
        src = cpu["engine"].pipeline
        for name in ("dit", "text_encoder", "vae"):
            getattr(eng.pipeline, name).load_state_dict(
                getattr(src, name).state_dict())
    card = _serve(cfg, FixedSP(2), [req], cache_interval=2,
                  setup=copy_weights)
    err = rel_l2(card["pixels"][req.id], cpu["pixels"][req.id])
    print(f"cpu: DIT_IMAGE.reduced() 128 px SP-2 cache_interval=2, card "
          f"(kernels) vs CPU (plain): pixel rel-L2 {err:.2e} (budget "
          f"{PIXEL_BUDGET:.0e})", flush=True)
    if not err <= PIXEL_BUDGET:
        raise AssertionError(f"CUDA vs CPU rel-L2 {err:.2e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    phase_device()
    phase_build()
    results = phase_kernels()
    counts = phase_serve()
    phase_sp()
    phase_cpu()
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
