#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves DiT-image and Mamba2 on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: the CUDA kernels of ``src/repro_torch/csrc`` with nvcc, before
   any engine starts (a first-use build inside a rank thread would
   outlast GFC's collective timeout).
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's full-width shapes (DIT_IMAGE for K1-K3, the mamba2-1.3b
   prefill for K4, timed at batch 4 and 1), fp32 and bf16, with kernel,
   plain-version and one-PyTorch-call times from CUDA events; K4's device
   time by stage kernel (``torch.profiler``) and each stage's occupancy.
4. serve: ``ServingEngine(DIT_IMAGE, SP-4, cache_interval=2)`` at full
   width serves two 512 px and one 1024 px request; every request must
   finish with finite pixels, through K1-K3, with both §11 refresh and
   hit steps.
5. sp: one 512 px request at SP1 and SP4 (cache_interval=1) agree.
6. cpu: on DIT_IMAGE.reduced() the card (kernels) and the CPU (plain
   versions) give the same pixels.
7. lm: mamba2-1.3b at full width (48 layers, d_model 2048, seeded random
   weights with Mamba2's published A/dt ranges) prefills 4 prompts of
   2048 tokens in bf16 and decodes 32 tokens greedily through the
   serve-loop steps: finite logits, K4 once per layer per prefill; then
   in fp32 prefill + decode reproduce the teacher-forced forward.
8. lm-cpu: on mamba2-1.3b.reduced() the card (K4) and the CPU (the
   sequential plain version) give the same logits.

Kernel times (phase 3): ``ms`` is device time, from CUDA-event timing of
replays of a CUDA graph that holds ``iters`` calls, so it leaves out the
host cost of each launch; ``call_ms`` is the same calls made eagerly from
Python between two events, what a Python caller pays per call; ``host_us``
is the host's cost of one wrapper call (many calls, no synchronise).  The
library call is timed both ways too.

The line before the last is the ``kernels`` JSON summary; the last line
is ``{"ok": true, "device": {...}}``.  Exits 2 without CUDA.

    python3 chip_smoke.py --kernels-only [--src DIR] [--json FILE]

runs phases 1-3 only, importing ``repro_torch`` from ``DIR`` (default:
``src`` beside this script; another checkout's ``src`` times that tree's
kernels with this script's timing) and writing every timed case to FILE.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def _src_dir() -> Path:
    """``--src DIR`` if given (read before the imports below), else the
    ``src`` beside this script."""
    if "--src" in sys.argv[1:-1]:
        return Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
    return Path(__file__).resolve().parent / "src"


sys.path.insert(0, str(_src_dir()))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.core.scheduler import Decision, Policy  # noqa: E402
from repro_torch.core.trajectory import ExecutionLayout, Request  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12           # CUDA cores; the kernels use no TF32
BUDGET = {torch.float32: 1e-5, torch.bfloat16: 3e-2}   # DESIGN.md §12
# K4 vs the sequential recurrence: two summation orders over 2048 steps,
# the JAX package's own kernel vs sequential bound (tests/test_kernels.py)
SSD_BUDGET = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
PIXEL_BUDGET = 1e-4                # rel-L2 on decoded pixels
MAMBA = get_config("mamba2-1.3b")
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LOGIT_BUDGET = 1e-3                # of the largest |logit|, fp32 decode
LM_CPU_BUDGET = 1e-4               # rel-L2 on logits, card vs CPU
DIT_KERNELS = ("fused_adaln", "attention", "splice_attention")
SOURCES = {
    "fused_adaln": ("src/repro_torch/csrc/adaln.cu",
                    "src/repro/kernels/adaln.py:66"),
    "attention": ("src/repro_torch/csrc/attention.cu",
                  "src/repro/kernels/flash_attention.py:82"),
    "splice_attention": ("src/repro_torch/csrc/attention.cu",
                         "src/repro/kernels/splice.py:78"),
    "ssd": ("src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd.py:65"),
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


def call_ms(fn, iters: int = 20) -> float:
    """Mean time of ``iters`` eager Python calls of ``fn`` between two
    CUDA events, after warm-up: the device time, or the host's cost of
    enqueueing the calls where that is longer (inputs stay warm in L2, as
    on the serving path)."""
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


def device_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``iters`` calls are captured in
    one CUDA graph (after a warm-up on a side stream) and ``replays``
    back-to-back replays are timed with CUDA events, so no per-call host
    work is counted.  Fails unless a replay rewrites the captured output
    (a launch that escaped the capture would leave it as it was)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            out = fn()
    out = out[0] if isinstance(out, tuple) else out
    graph.replay()
    torch.cuda.synchronize()
    want = out.clone()
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("a graph replay did not rewrite its output")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls with no
    synchronise between them (the device runs behind; keep calls x device
    time short enough that the launch queue never fills)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


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


# the DiT path's instantiations (fp32, d_model 1536, head dim 64), by
# their mangled-name prefixes
WATCHED = {"attn_kernel<float, 64>": "_ZN5gfdit11attn_kernelIfLi64E",
           "adaln_kernel<float, float4 x 12>":
               "_ZN5gfdit12adaln_kernelIfLi4ELi12E"}


def ptxas_report(log: str) -> dict:
    """Per compiled kernel (mangled name): registers, spill bytes (stores
    + loads) and stack frame bytes, from ``nvcc -Xptxas -v``."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            out[fn] = {"registers": None, "spill_bytes": 0, "stack": 0}
        elif fn and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            out[fn]["stack"], out[fn]["spill_bytes"] = nums[0], nums[1] + nums[2]
        elif fn and "Used" in ln and "registers" in ln:
            out[fn]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def phase_build() -> None:
    """Build and load the kernels; ptxas's full report (registers, shared
    memory, spills) is written beside the library as a ``.log`` file.
    Prints every kernel that spills and the DiT path's instantiations."""
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    report = ptxas_report(build.build_info.get("ptxas", ""))
    spills = sorted(f for f, r in report.items() if r["spill_bytes"])
    print(f"build: {seconds:.1f} s ({build.build_info.get('seconds', 0):.1f} s"
          f" nvcc), {len(report)} kernels, {len(spills)} spill (report in "
          f"{build.BUILD_DIR}/libgfdit-*.log)", flush=True)
    for f in spills:
        print(f"  spills: {f} {report[f]}", flush=True)
    for label, prefix in WATCHED.items():
        hits = [r for f, r in report.items() if f.startswith(prefix)]
        if hits:
            regs = sorted({r["registers"] for r in hits})
            spill = max(r["spill_bytes"] for r in hits)
            print(f"  {label}: {len(hits)} instantiation(s), registers "
                  f"{regs}, spill bytes {spill}", flush=True)
    for f in sorted(report):      # K4 at (p, n, chunk) = (64, 128, 128)
        m = re.match(r"_ZN5gfdit(\d+)", f)
        name = f[m.end():m.end() + int(m[1])] if m else f
        if name.startswith("ssd") and "Li128ELi128E" in f and (
                "Li64ELi128E" in f or name == "ssd_cb"):
            print(f"  {name}<{'bf16' if 'bfloat' in f else 'fp32'}, (64,) "
                  f"128, 128>: {report[f]}", flush=True)


def _rand(shape, dtype, gen, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)


def _check(label, kernel, plain, dtype, results, timing=None, budget=BUDGET):
    """Kernel against plain version: max abs error over max |plain|, per
    output (a kernel may return a tuple), within ``budget[dtype]``."""
    out_k, out_p = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(out_k, tuple):
        out_k, out_p = (out_k,), (out_p,)
    diff = rel = 0.0
    for k_, p_ in zip(out_k, out_p):
        d = (k_.float() - p_.float()).abs().max().item()
        diff = max(diff, d)
        rel = max(rel, d / max(p_.float().abs().max().item(), 1e-30))
    ok = math.isfinite(rel) and rel <= budget[dtype]
    line = (f"  {label} {str(dtype)[6:]}: max rel err {rel:.2e} "
            f"(budget {budget[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
    if timing is not None:
        ms, cms = device_ms(kernel), call_ms(kernel)
        hus = host_us(kernel, timing.get("host_calls", 1000))
        plain_ms = call_ms(plain, timing.get("plain_iters", 20))
        lib = timing.get("library")
        lib_ms = device_ms(lib) if lib is not None else None
        lib_cms = call_ms(lib) if lib is not None else None
        b_ms, b_by = bound_ms(timing["bytes"], timing["flops"])

        def fmt(t):
            return "-" if t is None else f"{t:.4f} ms"
        line += (f"; kernel {ms:.4f} ms device, {cms:.4f} ms a call, "
                 f"{hus:.1f} us host; plain {plain_ms:.4f} ms; library "
                 f"{fmt(lib_ms)} device, {fmt(lib_cms)} a call; bound "
                 f"{b_ms:.4f} ms ({b_by})")
        entry = {"max_abs_err": diff, "ms": ms, "call_ms": cms,
                 "host_us": hus, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms,
                 "library_call_ms": lib_cms, "case": label,
                 "dtype": str(dtype)[6:]}
        results.setdefault("timed", []).append(entry)
        if timing.get("summary"):
            results[timing["summary"]] = entry
    print(line, flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version ({rel:.2e} > {budget[dtype]:.0e})")


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
                if n == 1024 or vname == "mod_norm":
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
                        if fp32 and n == 1024:
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
        if fp32 and hasattr(ops, "attention_occupancy"):
            blocks, smem = ops.attention_occupancy(hd)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            bq = 64 if hd <= 128 else 32
            grid = -(-1024 // bq) * heads
            print(f"  attention occupancy d={hd}: {grid} blocks of 128 "
                  f"threads at Sq=1024, {blocks} resident per SM "
                  f"({smem / 1024:.1f} KB shared memory each), {sms} SMs: "
                  f"{grid / (blocks * sms):.2f} waves", flush=True)
            results["attention_occupancy"] = {
                "blocks_per_sm": blocks, "smem_bytes": smem, "sms": sms,
                "grid": grid}
        for label, qs, ks, causal in cases:
            q, k, v = (_rand(s, dtype, gen) for s in (qs, ks, ks))
            b, sq, h, d = qs
            sk = ks[1]
            pairs = sq * (sq + 1) // 2 if causal else sq * sk
            timing = None
            if label in ("self", "cross Lt=77", "text-encoder d=256"):
                timing = {
                    "bytes": (2 * q.numel() + k.numel() + v.numel()) * es,
                    "flops": 4 * b * h * d * pairs, "host_calls": 200,
                    "library": lambda q=q, k=k, v=v:
                        F.scaled_dot_product_attention(
                            q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))}
                if fp32 and label == "self":
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
                          "flops": 4 * heads * hd * 1024 * 4096,
                          "host_calls": 200}
                if fp32:
                    timing["summary"] = "splice_attention"
            _check(f"splice offset={offset} q(1,1024) stale(1,4096)",
                   lambda o=offset: ops.splice_attention(
                       q, ks_, vs_, kf, vf, offset=o),
                   lambda o=offset: ref.splice_attention_ref(
                       q, ks_, vs_, kf, vf, offset=o),
                   dtype, results, timing)
        _check_ssd(dtype, results)
    return results


def ssd_inputs(b, l, h, p, n, dtype, gen):
    """K4's inputs on the card, dt and A in Mamba2's published ranges.
    At the JAX init (A = -1, dt near 0.7) exp(cum) underflows within one
    128-row chunk, the carried-state term is exactly zero and a check
    proves nothing about the state carry."""
    dt, A = ssm.sample_dt_a((b, l, h), h, gen)
    x = _rand((b, l, h, p), dtype, gen)
    B, C = (_rand((b, l, n), dtype, gen) for _ in range(2))
    return x, dt, A, B, C


def ssd_flops(b, l, h, p, n, c) -> int:
    """Operations the SSD function needs, two per multiply-add: per
    (batch, chunk) of r rows the causal C·Bᵀ once (B and C have one
    group), r(r+1)/2 · n; per head the causal scores·xb, r(r+1)/2 · p,
    C·state, r·p·n (none in the first chunk, whose state is zero), and
    the state update, r·p·n."""
    total = 0
    for k, l0 in enumerate(range(0, l, c)):
        r = min(c, l - l0)
        tri = r * (r + 1) // 2
        total += tri * n + h * (tri * p + (2 if k else 1) * r * p * n)
    return 2 * b * total


def ssd_stage_ms(fn, b: int, calls: int = 10) -> dict:
    """Device ms a call of each K4 kernel (by name) over ``calls`` calls
    under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for avg in prof.key_averages():
        m = re.search(r"gfdit::(\w+)", avg.key)
        if m and "ssd" in m[1] and avg.self_device_time_total > 0:
            out[m[1]] = out.get(m[1], 0.0) + avg.self_device_time_total
    out = {k: v / calls / 1e3 for k, v in out.items()}
    print(f"  ssd b={b} device ms a call by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    return out


def _check_ssd(dtype, results) -> None:
    """K4 at the full-width mamba2-1.3b prefill (b=4, l=2048, h=64, p=64,
    n=128, chunk=128), timed in fp32; in fp32 also at batch 1 (timed), a
    ragged l (the forward's 2080) and the reduced model's (16, 16, 16)
    with a ragged l; then the occupancy of each stage kernel."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    _, heads, _ = ssm.ssm_dims(MAMBA)
    s = MAMBA.ssm
    es = torch.finfo(dtype).bits // 8
    full = (heads, s.head_dim, s.state_dim, s.chunk)
    cases = [(LM_BATCH, LM_PROMPT) + full]
    if dtype == torch.float32:
        cases += [(1, LM_PROMPT) + full, (LM_BATCH, LM_PROMPT + LM_DECODE)
                  + full, (2, 40, 16, 16, 16, 16)]
    for i, (b, l, h, p, n, c) in enumerate(cases):
        x, dt, A, B, C = ssd_inputs(b, l, h, p, n, dtype, gen)
        timing = None
        if i < 2 and dtype == torch.float32:
            timing = {
                "bytes": (2 * x.numel() + 2 * B.numel()) * es
                + (dt.numel() + h + b * h * p * n) * 4,
                "flops": ssd_flops(b, l, h, p, n, c),
                "plain_iters": 3, "host_calls": 200}
            if i == 0:
                timing["summary"] = "ssd"
        _check(f"ssd b={b} l={l} h={h} (p, n, chunk)={(p, n, c)}",
               lambda a=(x, dt, A, B, C), c=c: ops.ssd(*a, chunk=c),
               lambda a=(x, dt, A, B, C): ref.ssd_ref(*a),
               dtype, results, timing, SSD_BUDGET)
        if timing is not None:
            results.setdefault("ssd_stages", {})[f"b={b}"] = ssd_stage_ms(
                lambda a=(x, dt, A, B, C), c=c: ops.ssd(*a, chunk=c), b)
    if dtype == torch.float32:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        occ = {}
        for b in (LM_BATCH, 1):
            if hasattr(ops, "SSD_STAGES"):     # the chunk-parallel stages
                stages = ops.ssd_occupancy(b, LM_PROMPT, *full)
            else:                              # one kernel per (b, h)
                blocks, smem = ops.ssd_occupancy(*full[1:])
                stages = {"ssd_kernel": (blocks, smem, b * heads)}
            for name, (blocks, smem, grid) in stages.items():
                waves = grid / (blocks * sms)
                occ[f"b={b} {name}"] = {
                    "blocks_per_sm": blocks, "smem_bytes": smem, "sms": sms,
                    "grid": grid, "waves": waves}
                print(f"  ssd occupancy b={b} {name}: {grid} blocks of 256 "
                      f"threads, {blocks} resident per SM ({smem / 1024:.1f}"
                      f" KB shared memory each), {sms} SMs: {waves:.2f} "
                      f"waves", flush=True)
        results["ssd_occupancy"] = occ


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
    counts = {k: ops.launches[k] for k in DIT_KERNELS}
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


def _lm_run(model, cfg, prompt, steps, dtype, feed=None):
    """Prefill ``prompt`` and decode ``steps`` tokens through the
    serve-loop steps: greedily, or teacher-forced on ``feed``'s columns.
    Returns the logits (b, 1 + steps, vocab), the tokens fed to decode
    (b, steps) and the prefill and decode wall times."""
    prefill = serve_loop.make_prefill_step(cfg, dtype=dtype)
    step = serve_loop.make_serve_step(cfg, dtype=dtype)
    b, s = prompt.shape
    cache = ssm.init_cache(cfg, b, dtype=dtype, device=prompt.device)
    sync = torch.cuda.synchronize if prompt.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    lg, cache = prefill(model, prompt, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    logits, fed = [lg[:, 0]], []
    t0 = time.perf_counter()
    for i in range(steps):
        tok = (lg[:, -1].argmax(-1, keepdim=True) if feed is None
               else feed[:, i:i + 1])
        fed.append(tok)
        pos = torch.full((b,), s + i, device=prompt.device)
        lg, cache = step(model, tok, cache, pos)
        logits.append(lg[:, 0])
    sync()
    t_decode = time.perf_counter() - t0
    return (torch.stack(logits, 1), torch.cat(fed, 1), t_prefill,
            t_decode)


def phase_lm(smi: str) -> dict:
    """The Mamba2 serving path at full width through K4; returns the
    launch counts of its bf16 prefill + decode."""
    cfg = MAMBA
    held = torch.cuda.memory_allocated() / 2**30      # left by earlier phases
    model = ssm.Mamba2(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    ssm.init_published_a_dt(model)
    weights = torch.cuda.memory_allocated() / 2**30 - held
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator().manual_seed(1)).cuda()
    _lm_run(model, cfg, prompt, 1, torch.bfloat16)     # warm-up, uncounted
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    logits, fed, t_prefill, t_decode = _lm_run(model, cfg, prompt,
                                               LM_DECODE, torch.bfloat16)
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not torch.isfinite(logits).all() or logits.shape != (
            LM_BATCH, LM_DECODE + 1, cfg.vocab_size):
        raise AssertionError(f"lm: logits {tuple(logits.shape)} not all "
                             f"finite")
    if counts["ssd"] != cfg.num_layers or any(counts[k] for k in DIT_KERNELS):
        raise AssertionError(f"lm: launches {counts}, expected ssd = "
                             f"{cfg.num_layers} (one per layer, prefill)")
    d_inner, heads, _ = ssm.ssm_dims(cfg)
    print(f"lm: mamba2-1.3b full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {heads} SSD heads), bf16, batch {LM_BATCH}: "
          f"prefill {LM_PROMPT} tokens {LM_BATCH * LM_PROMPT / t_prefill:.0f}"
          f" tokens/s ({t_prefill * 1e3:.1f} ms); decode {LM_DECODE} tokens "
          f"{t_decode / LM_DECODE * 1e3:.2f} ms/token (one step of "
          f"{LM_BATCH} sequences); peak mem {peak:.2f} GiB ({held:.2f} "
          f"held before the phase, {weights:.2f} of weights); launches "
          f"{counts}; on {smi}", flush=True)

    # fp32: prefill + decode (teacher-forced on the bf16 run's tokens)
    # against the forward over the same 2080 tokens
    before = ops.launches["ssd"]
    got, _, _, _ = _lm_run(model, cfg, prompt, LM_DECODE, torch.float32,
                           feed=fed)
    with torch.inference_mode():
        full, _ = ssm.forward(model, torch.cat([prompt, fed], 1), cfg,
                              dtype=torch.float32)
    want = full[:, LM_PROMPT - 1:]
    del full
    launched = ops.launches["ssd"] - before
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"lm: fp32 prefill + {LM_DECODE} decode steps vs the "
          f"teacher-forced forward ({LM_PROMPT + LM_DECODE} tokens, K4 at "
          f"l={LM_PROMPT} and at the ragged l={LM_PROMPT + LM_DECODE}, "
          f"{launched} launches): max |diff| / max |logit| {err:.2e} "
          f"(budget {LOGIT_BUDGET:.0e})", flush=True)
    if not err <= LOGIT_BUDGET or launched != 2 * cfg.num_layers:
        raise AssertionError(f"lm: decode vs forward {err:.2e}, "
                             f"{launched} K4 launches")
    del model, got, want
    torch.cuda.empty_cache()
    return {"ssd": counts["ssd"]}


def phase_lm_cpu() -> None:
    """mamba2-1.3b.reduced() with the same weights on the card (K4) and
    on the CPU (plain versions): forward, prefill and decode logits."""
    cfg = MAMBA.reduced()
    cpu = ssm.Mamba2(cfg, device="cpu")
    ssm.init_published_a_dt(cpu)
    card = ssm.Mamba2(cfg)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = next(model.parameters()).device
        t = toks.to(dev)
        with torch.inference_mode():
            full, _ = ssm.forward(model, t, cfg, dtype=torch.float32)
        steps, _, _, _ = _lm_run(model, cfg, t[:, :32], 8, torch.float32,
                                 feed=t[:, 32:])
        out[name] = [full.cpu(), steps.cpu()]
    err = max(rel_l2(a, b) for a, b in zip(out["card"], out["cpu"]))
    print(f"lm-cpu: mamba2-1.3b.reduced() forward (40 tokens) and prefill "
          f"32 + decode 8, card (K4) vs CPU (plain): logit rel-L2 "
          f"{err:.2e} (budget {LM_CPU_BUDGET:.0e})", flush=True)
    if not err <= LM_CPU_BUDGET:
        raise AssertionError(f"lm-cpu: card vs CPU rel-L2 {err:.2e}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="run the device, build and kernels phases only")
    parser.add_argument("--src", help="import repro_torch from this src "
                        "directory (default: the one beside this script)")
    parser.add_argument("--json", help="write every timed kernel case here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "src": str(_src_dir()),
             "timed": results["timed"]}, indent=1))
    if args.kernels_only:
        return 0
    counts = phase_serve()
    phase_sp()
    phase_cpu()
    gc.collect()                   # the DiT engines' reference cycles
    torch.cuda.empty_cache()
    counts.update(phase_lm(smi))
    phase_lm_cpu()
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "call_ms": r["call_ms"], "host_us": r["host_us"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library_call_ms": r["library_call_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
