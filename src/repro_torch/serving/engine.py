"""GF-DiT serving engine on PyTorch: binds the control plane to real
executors (``repro/serving/engine.py`` with a ``device``).

Wall-clock serving over the thread backend: arrivals release on
schedule, policies make elastic layout/reallocation/preemption decisions,
rank threads run the DiT on the card (all ranks share one device and its
default stream) with GFC sequence parallelism, and migration happens at
layout changes.  The serving loop is the same :class:`EventLoop` that
drives the simulator; only the clock differs.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import CostModel
from repro_torch.core.event_loop import EventLoop, WallClock
from repro_torch.core.executor import ThreadBackend
from repro_torch.core.gfc import GroupFreeComm
from repro_torch.core.scheduler import ControlPlane, Policy
from repro_torch.core.trajectory import Request, as_topology
from repro_torch.diffusion.adapters import convert_request
from repro_torch.diffusion.pipeline import TorchDiTPipeline


class ServingEngine:
    def __init__(self, cfg: ModelConfig, policy: Policy, num_ranks,
                 cost: Optional[CostModel] = None, seed: int = 0,
                 cache_interval: Optional[int] = None,
                 injector=None, snapshot_interval: Optional[int] = None,
                 snapshot_dir=None, failure_recovery: bool = True,
                 telemetry=None, device=None):
        # `device` defaults to the card; the CPU (the kernels' plain
        # versions) only when the caller asks for it
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine runs on CUDA and none is "
                               "available; pass device='cpu' to run the "
                               "plain PyTorch path")
        # `num_ranks` accepts a bare rank count or a ClusterTopology;
        # `cache_interval` enables the cross-step feature cache (§11)
        topo = as_topology(num_ranks)
        self.cfg = cfg
        self.topology = topo
        self.pipeline = TorchDiTPipeline(cfg, seed=seed, device=device)
        self.comm = GroupFreeComm(topo.num_ranks, topology=topo)
        self.backend = ThreadBackend(self.pipeline, topo.num_ranks,
                                     comm=self.comm)
        self.cp = ControlPlane(topo, policy, cost or CostModel(),
                               self.backend,
                               cache_interval=cache_interval,
                               injector=injector,
                               snapshot_interval=snapshot_interval,
                               snapshot_dir=snapshot_dir,
                               failure_recovery=failure_recovery)
        self.attach_telemetry(telemetry)

    def attach_telemetry(self, telemetry) -> None:
        """Observe the serves from now on with ``telemetry`` (DESIGN.md
        §15; None: observe nothing).  One instance observes the whole
        stack: the control plane's decisions and timelines, GFC's
        registrations and collectives, and the host spans of the rank
        threads, the pipeline's phases and the event loop."""
        self.cp.telemetry = self.cp.cache.telemetry = telemetry
        self.comm.telemetry = self.pipeline.telemetry = telemetry
        if telemetry is not None:
            telemetry.attach(self.cp.num_ranks, self.cp.topology)

    # ------------------------------------------------------------------
    def serve(self, requests: list[Request], *, time_scale: float = 1.0,
              timeout: float = 300.0) -> dict:
        """Run requests to completion; arrivals release at
        ``request.arrival * time_scale`` wall seconds.

        Caller-owned ``Request`` objects are never mutated: the engine
        serves private copies (same ids, so ``result_pixels`` still
        resolves against the originals).
        """
        served = [dataclasses.replace(r, arrival=r.arrival * time_scale,
                                      deadline=(r.deadline * time_scale
                                                if r.deadline is not None
                                                else None),
                                      task_ids=[], done_time=None,
                                      failed=False)
                  for r in requests]
        graphs = [(r, convert_request(r, self.cfg))
                  for r in sorted(served, key=lambda r: r.arrival)]
        # start the clock only after CPU-side graph construction so
        # early arrivals do not release late
        clock = WallClock()
        self.backend.t0 = clock.t0
        if self.cp.telemetry is not None:
            # anchor the wall overlay streams (recorded in absolute
            # monotonic time from worker threads) to plane-relative time
            self.cp.telemetry.t0 = clock.t0
        for r, g in graphs:
            self.cp.submit(r, g)
        EventLoop(self.cp, clock).run(until=timeout)
        if self.backend.errors:
            raise RuntimeError("worker errors:\n"
                               + "\n".join(self.backend.errors[:3]))
        # wall-clock timeout: requests still in flight when the loop gave
        # up are explicitly FAILED in the returned metrics (and logged)
        unfinished = sorted(
            rid for rid, req in self.cp.requests.items()
            if req.done_time is None and not req.failed)
        if unfinished:
            logging.getLogger(__name__).warning(
                "serve timed out at %.1fs with %d unfinished requests: %s",
                timeout, len(unfinished), ", ".join(unfinished))
            for rid in unfinished:
                self.cp._fail_request(rid, "serve-timeout")
        if self.cp.telemetry is not None:
            # end-of-run watermark: whatever the sinks still buffer is
            # flushed out-of-process before the caller reads metrics
            # (DESIGN.md §16); sinks stay attached for post-run exports
            self.cp.telemetry.flush_sinks()
        m = self.cp.metrics()
        m["timed_out_requests"] = unfinished
        return m

    def result_pixels(self, request: Request):
        g = self.cp.graphs[request.id]
        for a in g.artifacts.values():
            if a.role == "output" and a.data:
                for rank_data in a.data.values():
                    if "pixels" in rank_data:
                        return rank_data["pixels"]
        return None

    def shutdown(self):
        """Stop the rank threads and release the model.  The plane and
        the backend refer to each other, so without this the pipeline
        and its device memory would wait for a garbage collection;
        ``result_pixels`` still reads the finished graphs."""
        self.backend.shutdown()
        if self.cp.telemetry is not None:
            self.cp.telemetry.close_sinks()
        self.backend.plane = None
        self.backend.adapter = None
        self.pipeline = None
