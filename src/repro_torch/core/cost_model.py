"""Profiled cost model (paper §2.2, §5.5; step packing in DESIGN.md §9).

Costs are indexed by (model, task kind, shape bucket, parallel degree).
Entries come from four sources, in priority order:
  1. online calibration — measured task durations reported by the executor
     (§5.1 "calibrate the runtime cost model with measured task durations");
  2. profiled seed table — measured offline on this container (benchmarks
     write it);
  3. neighbor interpolation — when a key is uncalibrated mid-trace, scale
     a calibrated neighbor (adjacent shape bucket or degree, same
     model|kind prefix) by the analytical ratio between the two cells;
  4. analytical fallback — roofline-style estimate from task FLOPs and an
     SP efficiency curve (mirrors the paper's Fig. 3 shapes: large tasks
     scale well, small tasks are communication-bound).

Packed (batched) denoise costs use the same hierarchy with a batch
dimension appended to the key: :meth:`estimate_packed` prices one
executor call that co-schedules N batch-compatible tasks (DESIGN.md §9).
The analytical pack curve is sub-linear — collectives and per-call
overhead are paid once, and compute is roughly free until the pack fills
the per-rank roofline, then additive.

Topology (DESIGN.md §10): collective terms split into intra-host and
inter-host components keyed by *span* — the number of hosts a layout
touches.  Span-1 keys are byte-identical to the pre-topology keys, so
every existing measurement (and saved table) is reused for single-host
layouts; spanning keys append ``|s{span}``.  An uncalibrated spanning
cell is priced by scaling the span-1 estimate through the analytical
intra/inter ratio before falling to the raw analytical curve.

Feature cache (DESIGN.md §11): a cache-hit denoise step skips the KV
all-gather, so its analytical cost drops the collective term entirely
(SP efficiency 1.0 — compute still shards over the degree, and the
per-step multi-rank dispatch overhead remains).  Cached cells calibrate
under their own ``|c``-suffixed keys — hit durations must never poison
the uncached calibration the policies compare against — and an
uncalibrated cached cell scales the best uncached estimate through the
analytical cached/uncached ratio.  ``request_remaining`` prices a
request served under a staleness window of ``cache_interval`` steps as
the 1-refresh : (interval-1)-hits mixture.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

# Reference throughputs for the analytical fallback (arbitrary units
# calibrated so one denoise step of a 1024x1024 image at SP1 ~ 1.0 s,
# matching the scale of the paper's H20 measurements).
_REF_TOKEN_RATE = 4.0e6          # DiT tokens^1.x per second per rank
_ENCODE_COST = 0.12              # text encode: effectively single-rank
_DECODE_PER_MPIX = 0.35          # VAE decode per megapixel(-frame)

# Step packing (DESIGN.md §9): tokens-per-rank at which one denoise call
# saturates the device; below it, co-batched tasks ride along nearly free.
_PACK_SAT_TOKENS = 8192
_PACK_MEMBER_OVERHEAD = 0.04     # per extra member, fraction of base cost

# Topology (DESIGN.md §10): default cost ratio of an inter-host byte to
# an intra-host byte when no ClusterTopology is attached to the model.
_INTER_COST_FACTOR = 4.0


def sp_efficiency(degree: int, tokens: int, span: int = 1,
                  inter_factor: float = _INTER_COST_FACTOR,
                  comm_scale: float = 1.0) -> float:
    """Parallel efficiency of sequence parallelism (Fig. 3b shape):
    large token counts amortize collectives; small ones don't.

    ``span`` is the number of hosts the SP group touches: the collective
    term splits into an intra-host component and an inter-host component
    — the (span-1)/(degree-1) fraction of ring edges that cross hosts
    pays ``inter_factor`` x the intra-host byte cost.

    ``comm_scale`` multiplies the collective payload: a batched-CFG
    guided step (DESIGN.md §14) gathers B=2 rows of KV per layer, so its
    collective term doubles while compute scales separately.
    """
    if degree == 1:
        return 1.0
    comm = 0.35 * (degree - 1) * (4096 / max(tokens, 256)) ** 0.5
    comm *= comm_scale
    if span > 1:
        inter_frac = min(span - 1, degree - 1) / (degree - 1)
        comm *= 1.0 + (inter_factor - 1.0) * inter_frac
    return 1.0 / (1.0 + comm)


def pack_scale(batch: int, tokens: int, degree: int) -> float:
    """Analytical duration multiplier of a pack of `batch` compatible
    tasks versus a single task at the same (tokens, degree).

    Each rank sees ``tokens/degree`` tokens per member.  Until the pack
    fills the per-rank roofline (`_PACK_SAT_TOKENS`), added members only
    cost a small dispatch/stacking overhead — the TetriServe observation
    that small-shape denoise steps leave the device underutilized.
    Beyond the knee, compute is additive.
    """
    if batch <= 1:
        return 1.0
    tok_rank = max(tokens / max(degree, 1), 1.0)
    fill = tok_rank / _PACK_SAT_TOKENS            # roofline share of one
    compute = max(1.0, batch * fill) / max(1.0, fill)
    return compute + _PACK_MEMBER_OVERHEAD * (batch - 1)


@dataclass
class CostModel:
    table: dict = field(default_factory=dict)   # key -> seconds
    calibration: dict = field(default_factory=dict)
    pack_table: dict = field(default_factory=dict)       # packed key -> s
    pack_calibration: dict = field(default_factory=dict)
    ema: float = 0.5
    # attached by the control plane (DESIGN.md §10); prices the
    # inter-host share of collective terms for spanning layouts
    topology: object = None

    # ------------------------------------------------------------------
    @staticmethod
    def _bucket(tokens: int) -> int:
        return 1 << max(0, int(math.log2(max(tokens, 1))))

    @staticmethod
    def _key(model: str, kind: str, tokens: int, degree: int,
             span: int = 1, cached: bool = False, cfg: int = 0) -> str:
        """Span-1 uncached keys stay byte-identical to the pre-topology
        format so single-host measurements (and saved tables) are
        reused; cache-hit cells append ``|c`` (DESIGN.md §11).  Guided
        shapes append ``|cfg{c}`` (DESIGN.md §14): ``cfg=0`` means
        unguided (key unchanged), ``cfg=1`` a batched-CFG step on one
        group, ``cfg>=2`` a split-branch step — each calibrates its own
        cell so guided durations (2x the work) never poison the unguided
        calibration the policies compare against."""
        bucket = CostModel._bucket(tokens)
        base = f"{model}|{kind}|{bucket}|{degree}"
        if span > 1:
            base += f"|s{span}"
        if cached:
            base += "|c"
        if cfg >= 1:
            base += f"|cfg{cfg}"
        return base

    @staticmethod
    def _pack_key(model: str, kind: str, tokens: int, degree: int,
                  batch: int, span: int = 1, cached: bool = False) -> str:
        return CostModel._key(model, kind, tokens, degree, span,
                              cached) + f"|b{batch}"

    def _inter_factor(self) -> float:
        topo = self.topology
        if topo is not None and getattr(topo, "num_hosts", 1) > 1:
            return topo.inter_cost_factor
        return _INTER_COST_FACTOR

    # ------------------------------------------------------------------
    def estimate(self, model: str, kind: str, tokens: int,
                 degree: int, span: int = 1,
                 cached: bool = False, cfg: int = 0) -> float:
        key = self._key(model, kind, tokens, degree, span, cached, cfg)
        if key in self.calibration:
            return self.calibration[key]
        if key in self.table:
            return self.table[key]
        if cfg >= 1:
            # uncalibrated shape cell: scale the (measured-where-
            # possible) unguided estimate by the analytical shape ratio
            # — the ratio is exactly the doubled work plus the changed
            # collective structure (DESIGN.md §14).  Interpolation never
            # crosses cfg cells: each shape calibrates independently.
            base = self.estimate(model, kind, tokens, degree, span,
                                 cached)
            ref = self.analytical(model, kind, tokens, degree, span,
                                  cached)
            if ref > 0:
                return base * (self.analytical(model, kind, tokens,
                                               degree, span, cached,
                                               cfg) / ref)
            return base
        if cached:
            # scale the best uncached estimate (measured where possible)
            # through the analytical cached/uncached ratio — the ratio
            # captures exactly the dropped collective term
            base = self.estimate(model, kind, tokens, degree, span)
            ref = self.analytical(model, kind, tokens, degree, span)
            if ref > 0:
                return base * (self.analytical(model, kind, tokens,
                                               degree, span, cached=True)
                               / ref)
            return base
        if span > 1:
            # scale the (measured-where-possible) span-1 estimate through
            # the analytical intra/inter collective ratio
            base = self.estimate(model, kind, tokens, degree, 1)
            ref = self.analytical(model, kind, tokens, degree, 1)
            if ref > 0:
                return base * (self.analytical(model, kind, tokens,
                                               degree, span) / ref)
            return base
        interp = self._interpolate(model, kind, tokens, degree)
        if interp is not None:
            return interp
        return self.analytical(model, kind, tokens, degree)

    def analytical(self, model: str, kind: str, tokens: int,
                   degree: int, span: int = 1,
                   cached: bool = False, cfg: int = 0) -> float:
        factor = self._inter_factor()
        if kind == "encode":
            return _ENCODE_COST
        if kind == "decode":
            base = _DECODE_PER_MPIX * (tokens / 4096)
            eff = sp_efficiency(degree, tokens, span, factor)
            return base / (degree * eff) + 0.01
        # denoise: attention ~ tokens^2/flops but MLP dominates until long
        scale = 2.2 if model.endswith("video") else 1.0
        work = scale * (tokens / 4096) ** 1.35
        if cfg >= 2 and kind == "denoise":
            # split-CFG (DESIGN.md §14): each branch runs its guidance
            # row B=1 over sp ranks — the SP collective term shrinks to
            # the branch (no cross-branch bytes until the merge), and a
            # single cheap merge exchange of the local velocity shard
            # joins branch peers once per step.  SP stays host-tight:
            # branch span is ceil(span/cfg); a CFG pair that straddles
            # hosts pays the inter factor only on the merge.
            sp = max(degree // cfg, 1)
            branch_span = max(1, -(-span // cfg))
            eff = 1.0 if cached else sp_efficiency(sp, tokens,
                                                   branch_span, factor)
            merge = 0.01 * (cfg - 1) * (tokens / sp / 4096) ** 0.5
            if span > branch_span:
                merge *= factor
            return max((2.0 / cfg) * work / (sp * eff), 1e-4) \
                + merge + 0.004 * (degree > 1)
        if cfg == 1 and kind == "denoise":
            # batched-CFG on one group: 2x the rows through one forward,
            # shared collectives — but the KV gather carries B=2, so the
            # collective payload doubles (comm_scale=2)
            eff = 1.0 if cached else sp_efficiency(degree, tokens, span,
                                                   factor, comm_scale=2.0)
            return max(2.0 * work / (degree * eff), 1e-4) \
                + 0.004 * (degree > 1)
        # a cache-hit step (DESIGN.md §11) runs no KV all-gather: the
        # collective term vanishes (efficiency 1.0 at any span) while
        # compute still shards and the multi-rank dispatch overhead stays
        eff = 1.0 if cached else sp_efficiency(degree, tokens, span,
                                               factor)
        return max(work / (degree * eff), 1e-4) + 0.004 * (degree > 1)

    # ------------------------------------------------------------------
    def _interpolate(self, model: str, kind: str, tokens: int,
                     degree: int) -> Optional[float]:
        """Mid-trace fallback for an uncalibrated key: scale the nearest
        calibrated neighbor at the same ``model|kind`` prefix by the
        analytical ratio between the target and neighbor cells, instead
        of dropping all the way to the raw analytical curve.

        Shape-bucket neighbors at the SAME degree are preferred: they
        share the collective structure, so the cross-bucket analytical
        ratio is the trustworthy part of the curve.  Degree neighbors at
        the same bucket project ONLY through a MEASURED cross-degree
        ratio, taken at the nearest bucket calibrated at both degrees:
        the SP-efficiency curve is both token-dependent and exactly what
        online calibration exists to correct (DESIGN.md §8: measured SP
        costs need not follow it), so analytically projecting across
        degrees would smear calibration noise into every
        degree-comparison the policies make.  A far-away ratio source is
        imperfect (SP efficiency shifts with tokens), but measurably
        better than the analytical cross-degree ratio, and with no
        measured ratio at all the estimate falls back to the analytical
        curve rather than cross-degree projection."""
        bucket = self._bucket(tokens)
        anchor = self.analytical(model, kind, tokens, degree)
        if anchor <= 0:
            return None

        def lookup(b: int, d: int) -> Optional[float]:
            k = self._key(model, kind, b, d)
            return self.calibration.get(k, self.table.get(k))

        # 1. shape-bucket neighbors at the same degree
        for shift in (1, 2):
            for nb in (bucket >> shift, bucket << shift):
                if nb < 1:
                    continue
                v = lookup(nb, degree)
                if v is None:
                    continue
                ref = self.analytical(model, kind, nb, degree)
                if ref > 0:
                    return anchor * (v / ref)
        # 2. degree neighbors at the same bucket, measured ratio only:
        # the ratio comes from the nearest bucket calibrated at BOTH
        # degrees.  Shifts 1-2 are provably unreachable here — a
        # (neighbor, degree) sample there would have satisfied step 1 —
        # so the scan starts at 3.
        for nd in (degree // 2, degree * 2):
            if nd < 1 or nd == degree:
                continue
            v = lookup(bucket, nd)
            if v is None:
                continue
            for shift in range(3, 12):
                for nb in (bucket >> shift, bucket << shift):
                    if nb < 1:
                        continue
                    v_src, v_dst = lookup(nb, nd), lookup(nb, degree)
                    if v_src and v_dst:
                        return v * (v_dst / v_src)
        return None

    # ------------------------------------------------------------------
    def estimate_packed(self, model: str, kind: str, tokens: int,
                        degree: int, batch: int, span: int = 1,
                        cached: bool = False) -> float:
        """Duration of ONE executor call running `batch` compatible tasks
        (stacked along the batch axis, collectives shared — DESIGN.md §9).
        Priority: packed calibration -> packed table -> calibrated
        neighbor batch scaled by the analytical pack curve -> single-task
        estimate times the analytical pack multiplier.  ``cached`` prices
        a pack whose every member is a cache hit (DESIGN.md §11: packs
        hit or refresh as a unit)."""
        if batch <= 1:
            return self.estimate(model, kind, tokens, degree, span,
                                 cached)
        key = self._pack_key(model, kind, tokens, degree, batch, span,
                             cached)
        if key in self.pack_calibration:
            return self.pack_calibration[key]
        if key in self.pack_table:
            return self.pack_table[key]
        # neighbor interpolation over the batch axis at the same prefix
        anchor = pack_scale(batch, tokens, degree)
        for nb in sorted(range(max(batch - 2, 2), batch + 3),
                         key=lambda b: (abs(b - batch), b)):
            if nb == batch:
                continue
            k = self._pack_key(model, kind, tokens, degree, nb, span,
                               cached)
            v = self.pack_calibration.get(k, self.pack_table.get(k))
            if v is not None:
                ref = pack_scale(nb, tokens, degree)
                if ref > 0:
                    return v * (anchor / ref)
        return self.estimate(model, kind, tokens, degree, span,
                             cached) * anchor

    # ------------------------------------------------------------------
    def observe(self, model: str, kind: str, tokens: int, degree: int,
                seconds: float, span: int = 1, cached: bool = False,
                cfg: int = 0):
        """Online calibration from measured durations (EMA); spanning
        layouts calibrate their own span-keyed cell (DESIGN.md §10),
        cache-hit steps their own ``|c`` cell (DESIGN.md §11), and
        guided shapes their own ``|cfg{c}`` cell (DESIGN.md §14)."""
        key = self._key(model, kind, tokens, degree, span, cached, cfg)
        old = self.calibration.get(key)
        self.calibration[key] = (seconds if old is None
                                 else self.ema * seconds +
                                 (1 - self.ema) * old)

    def observe_packed(self, model: str, kind: str, tokens: int,
                       degree: int, batch: int, seconds: float,
                       span: int = 1, cached: bool = False):
        """Online calibration from one measured pack duration (EMA over
        the packed key; a batch of 1 calibrates the single-task key)."""
        if batch <= 1:
            return self.observe(model, kind, tokens, degree, seconds,
                                span, cached)
        key = self._pack_key(model, kind, tokens, degree, batch, span,
                             cached)
        old = self.pack_calibration.get(key)
        self.pack_calibration[key] = (seconds if old is None
                                      else self.ema * seconds +
                                      (1 - self.ema) * old)

    # ------------------------------------------------------------------
    def request_remaining(self, model: str, graph, degree: int = 1,
                          span: int = 1, cache_interval: int = 1,
                          cfg: int = 0) -> float:
        """Remaining trajectory work of a request at `degree` (for SRTF).

        With ``cache_interval > 1`` the denoise chain is priced as the
        feature-cache mixture (DESIGN.md §11): one refresh step per
        window, ``interval - 1`` cache hits — the steady-state rate of a
        request whose placement holds still.  Degree-1 steps have no
        collective to skip, so the mixture only applies at degree > 1.

        Guided requests (DESIGN.md §14) auto-price their denoise steps
        at the batched-CFG cell (``cfg=1``) when the caller passed no
        shape — scalar policies then see the honest 2x work without
        knowing shapes exist; pass ``cfg>=2`` to price a split shape.
        Guided steps bypass the feature cache, so no mixture applies.
        """
        if cfg == 0 and getattr(graph.request, "guidance", None) \
                is not None:
            cfg = 1
        total = 0.0
        for t in graph.remaining_tasks():
            tok = t.meta.get("tokens", 4096)
            if t.kind == "denoise" and cfg >= 1:
                total += self.estimate(model, t.kind, tok, degree, span,
                                       cfg=cfg)
            elif t.kind == "denoise" and cache_interval > 1 and degree > 1:
                full = self.estimate(model, t.kind, tok, degree, span)
                hit = self.estimate(model, t.kind, tok, degree, span,
                                    cached=True)
                total += (full + (cache_interval - 1) * hit) \
                    / cache_interval
            else:
                total += self.estimate(model, t.kind, tok, degree, span)
        return total

    # ------------------------------------------------------------------
    def save(self, path: str | Path):
        Path(path).write_text(json.dumps(
            {"table": self.table, "calibration": self.calibration,
             "pack_table": self.pack_table,
             "pack_calibration": self.pack_calibration}))

    @classmethod
    def load(cls, path: str | Path) -> "CostModel":
        d = json.loads(Path(path).read_text())
        return cls(table=d.get("table", {}),
                   calibration=d.get("calibration", {}),
                   pack_table=d.get("pack_table", {}),
                   pack_calibration=d.get("pack_calibration", {}))
