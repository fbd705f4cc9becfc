"""DiT serving pipeline: the model-executor side of the adapter (§5.2),
``repro/diffusion/pipeline.py`` in PyTorch.

Holds the text encoder, DiT denoiser and VAE decoder on one device and
executes trajectory tasks per rank with GFC collectives inside
(sequence-parallel denoising).  Artifacts stay numpy arrays on the host:
GFC, migration and the §11 snapshot store work on them unchanged, so
every K/V gather goes device -> numpy -> ``comm.all_gather`` -> device.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gfc import GroupDescriptor, GroupFreeComm
from repro_torch.core.trajectory import (ExecutionLayout, RequestGraph,
                                         TrajectoryTask)
from repro_torch.diffusion import schedule
from repro_torch.diffusion.adapters import field_view
from repro_torch.diffusion.feature_cache import snapshot_kv
from repro_torch.kernels import ops
from repro_torch.models import dit, text_encoder, vae

PROMPT_LEN = 77      # matches the converter's declared text_embeds shape


def _req_seed(request_id: str) -> int:
    return int(hashlib.sha1(request_id.encode()).hexdigest()[:8], 16)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class CallPhases:
    """Where the host's time in one pipeline call went, for telemetry:
    the bounds of its phases in ``time.monotonic``, in order, and the
    bytes each moved.  ``inputs``: host artifacts (and the timestep and
    prompt tokens) to the device; ``forward``: the enqueue of the model;
    ``sync``: the blocking copies of the outputs to the host;
    ``writeback``: the artifact writes (for an encode also the noise
    draw and the initial latent)."""

    OPS = ("inputs", "forward", "sync", "writeback")
    __slots__ = ("marks", "sizes")

    def __init__(self):
        self.marks = [time.monotonic()]
        self.sizes: list[int] = []

    def end(self, nbytes: int = 0):
        """Close the phase in progress; it moved ``nbytes``."""
        self.marks.append(time.monotonic())
        self.sizes.append(nbytes)

    def spans(self) -> list[tuple]:
        """[(op, start, end, bytes)] of the closed phases."""
        return list(zip(self.OPS, self.marks, self.marks[1:], self.sizes))


class TorchDiTPipeline:
    """Executable DiT pipeline; weights drawn from ``seed`` on ``device``."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device="cuda"):
        assert cfg.family == "dit"
        self.cfg = cfg
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.dit = dit.DiT(cfg, generator=gen, device=self.device)
        self.txt_cfg = text_encoder.encoder_config(
            cfg.dit.cond_dim, vocab=512).reduced(
            d_model=cfg.dit.cond_dim, num_heads=4, num_kv_heads=4,
            head_dim=cfg.dit.cond_dim // 4, d_ff=cfg.dit.cond_dim * 2)
        self.text_encoder = text_encoder.TextEncoder(
            self.txt_cfg, generator=gen, device=self.device)
        self.vae = vae.VAE(cfg, hidden=32, generator=gen, device=self.device)
        # set by the serving engine: with telemetry attached, a call
        # returns its CallPhases for the executor to record
        self.telemetry = None

    def _tensor(self, a):
        """A host artifact on the device; float64 (the initial latent is
        noise * a float64 sigma) arrives as float32, as JAX takes it with
        64-bit mode off."""
        t = torch.as_tensor(np.asarray(a), device=self.device)
        return t.float() if t.dtype == torch.float64 else t

    # ------------------------------------------------------------------
    # per-request draws (CPU generators, so every device draws the same)
    # ------------------------------------------------------------------
    def _prompt_tokens(self, req) -> torch.Tensor:
        """Synthetic prompt tokens (1, 77) derived from the request id."""
        gen = torch.Generator().manual_seed(_req_seed(req.id))
        return torch.randint(0, self.txt_cfg.vocab_size, (1, PROMPT_LEN),
                             generator=gen)

    def _initial_noise(self, req, shape) -> np.ndarray:
        """Unit Gaussian noise of ``shape`` (n_tokens, patch_dim)."""
        gen = torch.Generator().manual_seed(_req_seed(req.id) + 1)
        return torch.randn(shape, generator=gen).numpy()

    # ------------------------------------------------------------------
    # adapter interface: execute this rank's share of a trajectory task
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def execute(self, task: TrajectoryTask, layout: ExecutionLayout,
                rank: int, comm: GroupFreeComm, graph: RequestGraph,
                desc: GroupDescriptor):
        """Run this rank's share of ``task``; returns its CallPhases
        with telemetry attached (none closed on a rank with no share),
        else None."""
        ph = CallPhases() if self.telemetry is not None else None
        if task.kind == "encode":
            if rank == layout.ranks[0]:
                self._encode(task, layout, graph, ph)
        elif task.kind == "denoise":
            self._denoise(task, layout, rank, comm, graph, desc, ph)
        elif task.kind == "decode":
            if rank == layout.ranks[0]:
                self._decode(task, layout, graph, ph)
        else:
            raise ValueError(task.kind)
        return ph

    # ------------------------------------------------------------------
    def _gather_fn(self, comm, desc, rank, on_gather=None):
        """kv_gather doing the GFC all-gather of K/V over the token axis
        through the host; ``on_gather(K, V, layer)`` sees the gathered
        numpy arrays (the refresh path snapshots them)."""
        def kv_gather(k, v, layer):
            K = comm.all_gather(desc, rank, _host(k), axis=1)
            V = comm.all_gather(desc, rank, _host(v), axis=1)
            if on_gather is not None:
                on_gather(K, V, layer)
            return self._tensor(K), self._tensor(V)
        return kv_gather

    def _hit_fn(self, stores, off):
        """§11 hit: the stale snapshot and this step's fresh local shard
        go to the splice kernel — no collective, no materialized concat."""
        def kv_gather(k, v, layer):
            K, V = snapshot_kv(stores, layer)
            return ops.SplicedKV(self._tensor(K), self._tensor(V), k, v,
                                 int(off))
        return kv_gather

    @torch.inference_mode()
    def execute_packed(self, members, layout: ExecutionLayout, rank: int,
                       comm: GroupFreeComm, desc: GroupDescriptor):
        """Step packing (DESIGN.md §9): run this rank's share of N
        batch-compatible denoise tasks as ONE batched forward, with one
        set of GFC collectives over the stacked tensors; each member's
        Euler update then uses its own sigma pair.  Returns the call's
        CallPhases with telemetry attached, else None."""
        ph = CallPhases() if self.telemetry is not None else None
        xs, txts, t_steps, sig_pairs = [], [], [], []
        for task, graph in members:
            req = graph.request
            txts.append(graph.artifacts[task.inputs[0]].data[rank]["embeds"])
            xs.append(graph.artifacts[task.inputs[1]].data[rank]["latent"])
            sigmas = schedule.flow_sigmas(req.steps)
            step = task.meta["step"]
            s_now = float(sigmas[step])
            s_next = (float(sigmas[step + 1]) if step + 1 < req.steps
                      else 0.0)
            sig_pairs.append((s_now, s_next))
            t_steps.append(schedule.timestep_of_sigma(s_now))

        task0, graph0 = members[0]
        spec = graph0.artifacts[task0.inputs[1]].fields["latent"]
        view = field_view(spec, layout)
        off, _ = view.slices[rank]
        n_total = spec.global_shape[0]
        t = torch.tensor(t_steps, dtype=torch.float32, device=self.device)

        stamp = task0.meta.get("cache")
        if layout.degree == 1:
            def kv_gather(k, v, layer):
                return k, v
        elif stamp is None:
            kv_gather = self._gather_fn(comm, desc, rank)
        else:
            # cross-step feature cache (DESIGN.md §11): the pack shares
            # ONE plane-stamped decision; per-member snapshots live in
            # each member's kv_cache artifact, batch rows map to members
            stores = [g.artifacts[tk.meta["cache"]["art"]].data[rank]
                      for tk, g in members]
            if stamp["mode"] == "refresh":
                def snapshot(K, V, layer):
                    for j, store in enumerate(stores):
                        store[f"k{layer}"] = K[j]
                        store[f"v{layer}"] = V[j]
                kv_gather = self._gather_fn(comm, desc, rank, snapshot)
            else:
                kv_gather = self._hit_fn(stores, off)

        x = torch.stack([self._tensor(s) for s in xs])     # (B, N_loc, pd)
        txt = torch.stack([self._tensor(s) for s in txts])  # (B, Lt, cond)
        if ph is not None:
            ph.end(sum(np.asarray(a).nbytes for a in xs + txts) + t.nbytes)
        v = dit.forward_sp_tokens(
            self.dit, x, t, txt, self.cfg, pos_offset=off,
            n_total=n_total, kv_gather=kv_gather)
        new_xs = [schedule.flow_step(x[i], v[i], s_now, s_next)
                  for i, (s_now, s_next) in enumerate(sig_pairs)]
        if ph is not None:
            ph.end()
        outs = [_host(new_x) for new_x in new_xs]
        if ph is not None:
            ph.end(sum(o.nbytes for o in outs))
        for (task, graph), out, (_, s_next) in zip(members, outs,
                                                   sig_pairs):
            out_art = graph.artifacts[task.outputs[0]]
            out_art.data[rank]["latent"] = out
            out_art.data[rank]["sigma"] = np.float32(s_next)
        if ph is not None:
            ph.end()
        return ph

    # ------------------------------------------------------------------
    def _encode(self, task, layout, graph, ph=None):
        req = graph.request
        toks = self._prompt_tokens(req).to(self.device)
        if ph is not None:
            ph.end(toks.nbytes)
        fields = {"embeds": text_encoder.encode(
            self.text_encoder, toks, self.txt_cfg,
            dtype=torch.float32)[0]}                          # (Lt, cond)
        if req.guidance is not None:
            # classifier-free guidance (DESIGN.md §14): the uncond branch
            # conditions on the null prompt (all-zero tokens)
            fields["embeds_uncond"] = text_encoder.encode(
                self.text_encoder, torch.zeros_like(toks), self.txt_cfg,
                dtype=torch.float32)[0]
        if ph is not None:
            ph.end()
        # replicated fields: every rank of this layout holds a copy (a
        # same-layout successor consumes without migration)
        copies = {(r, k): _host(e) for k, e in fields.items()
                  for r in layout.ranks}
        if ph is not None:
            ph.end(sum(c.nbytes for c in copies.values()))
        txt_art = graph.artifacts[task.outputs[0]]
        for (r, k), c in copies.items():
            txt_art.data[r][k] = c

        # initial noisy latent (latent preparation is part of encode stage)
        lat_art = graph.artifacts[task.outputs[1]]
        n_tok, patch_dim = lat_art.fields["latent"].global_shape
        noise = self._initial_noise(req, (n_tok, patch_dim))
        sigmas = schedule.flow_sigmas(req.steps)
        full = np.asarray(noise) * sigmas[0]
        view = field_view(lat_art.fields["latent"], layout)
        for r in layout.ranks:
            off, size = view.slices[r]
            lat_art.data[r]["latent"] = full[off:off + size]
            lat_art.data[r]["sigma"] = np.float32(sigmas[0])
        if ph is not None:
            ph.end()

    # ------------------------------------------------------------------
    def _denoise(self, task, layout, rank, comm, graph, desc, ph=None):
        req = graph.request
        if req.guidance is not None:
            return self._denoise_guided(task, layout, rank, comm, graph,
                                        desc, ph)
        txt_art = graph.artifacts[task.inputs[0]]
        lat_art = graph.artifacts[task.inputs[1]]
        out_art = graph.artifacts[task.outputs[0]]
        txt_np = txt_art.data[rank]["embeds"]
        x_np = lat_art.data[rank]["latent"]
        txt = self._tensor(txt_np)
        x_shard = self._tensor(x_np)                            # (N_loc, pd)
        spec = lat_art.fields["latent"]
        view = field_view(spec, layout)
        off, _ = view.slices[rank]
        n_total = spec.global_shape[0]

        sigmas = schedule.flow_sigmas(req.steps)
        step = task.meta["step"]
        sigma_now = float(sigmas[step])
        sigma_next = float(sigmas[step + 1]) if step + 1 < req.steps else 0.0
        t = torch.tensor([schedule.timestep_of_sigma(sigma_now)],
                         dtype=torch.float32, device=self.device)

        stamp = task.meta.get("cache")
        if layout.degree == 1:
            def kv_gather(k, v, layer):
                return k, v
        elif stamp is None:
            kv_gather = self._gather_fn(comm, desc, rank)
        elif stamp["mode"] == "refresh":
            # full gather; snapshot this rank's copy per layer — every
            # rank stores the SAME gathered bytes (replicated fields),
            # and the returned arrays are exactly the uncached ones, so
            # a refresh step equals the non-cached path
            store = graph.artifacts[stamp["art"]].data[rank]

            def snapshot(K, V, layer):
                store[f"k{layer}"] = K[0]
                store[f"v{layer}"] = V[0]
            kv_gather = self._gather_fn(comm, desc, rank, snapshot)
        else:
            kv_gather = self._hit_fn(
                [graph.artifacts[stamp["art"]].data[rank]], off)
        if ph is not None:
            ph.end(np.asarray(x_np).nbytes + np.asarray(txt_np).nbytes
                   + t.nbytes)

        v_shard = dit.forward_sp_tokens(
            self.dit, x_shard[None], t, txt[None], self.cfg,
            pos_offset=off, n_total=n_total, kv_gather=kv_gather)[0]
        new_x = schedule.flow_step(x_shard, v_shard, sigma_now, sigma_next)
        if ph is not None:
            ph.end()
        out = _host(new_x)
        if ph is not None:
            ph.end(out.nbytes)
        out_art.data[rank]["latent"] = out
        out_art.data[rank]["sigma"] = np.float32(sigma_next)
        if ph is not None:
            ph.end()

    # ------------------------------------------------------------------
    def _denoise_guided(self, task, layout, rank, comm, graph, desc,
                        ph=None):
        """Classifier-free guidance denoise (DESIGN.md §14).

        ``cfg == 1``: ONE batched forward with rows [cond, uncond] on the
        whole group.  ``cfg >= 2``: this rank's branch runs its row B=1
        with SP collectives confined to the branch descriptor, then ONE
        merge exchange joins branch peers holding the same token slice.
        Guided steps bypass the §11 feature cache.
        """
        req = graph.request
        g = float(req.guidance)
        txt_art = graph.artifacts[task.inputs[0]]
        lat_art = graph.artifacts[task.inputs[1]]
        out_art = graph.artifacts[task.outputs[0]]
        arrays = [txt_art.data[rank]["embeds"],
                  txt_art.data[rank]["embeds_uncond"],
                  lat_art.data[rank]["latent"]]
        txt_c, txt_u, x_shard = (self._tensor(a) for a in arrays)
        spec = lat_art.fields["latent"]
        view = field_view(spec, layout)
        off, _ = view.slices[rank]
        n_total = spec.global_shape[0]

        sigmas = schedule.flow_sigmas(req.steps)
        step = task.meta["step"]
        sigma_now = float(sigmas[step])
        sigma_next = float(sigmas[step + 1]) if step + 1 < req.steps \
            else 0.0
        ts = schedule.timestep_of_sigma(sigma_now)
        # a timestep a row: cfg == 1 batches [cond, uncond], cfg >= 2
        # runs this rank's branch alone
        t = torch.tensor([ts, ts] if layout.cfg == 1 else [ts],
                         dtype=torch.float32, device=self.device)
        if ph is not None:
            ph.end(sum(np.asarray(a).nbytes for a in arrays) + t.nbytes)

        if layout.cfg == 1:
            if layout.degree == 1:
                def kv_gather(k, v, layer):
                    return k, v
            else:
                kv_gather = self._gather_fn(comm, desc, rank)
            x = torch.stack([x_shard, x_shard])
            txt = torch.stack([txt_c, txt_u])
            v = dit.forward_sp_tokens(
                self.dit, x, t, txt, self.cfg, pos_offset=off,
                n_total=n_total, kv_gather=kv_gather)
            v_c, v_u = v[0], v[1]
        else:
            b = layout.branch_of(rank)
            branch = desc.branches[b]
            i_local = branch.local_index(rank)
            merge = desc.merge[i_local]
            if layout.sp == 1:
                def kv_gather(k, v, layer):
                    return k, v
            else:
                kv_gather = self._gather_fn(comm, branch, rank)
            txt = txt_c if b == 0 else txt_u
            v_mine = dit.forward_sp_tokens(
                self.dit, x_shard[None], t, txt[None], self.cfg,
                pos_offset=off, n_total=n_total, kv_gather=kv_gather)[0]
            # the one guidance-merge exchange: branch peers sharing this
            # token slice swap velocity shards; merge-group rank order is
            # branch order, so parts[0]=cond, parts[1]=uncond everywhere
            both = comm.all_gather(merge, rank, _host(v_mine)[None], axis=0)
            v_c, v_u = self._tensor(both[0]), self._tensor(both[1])
        merged = v_u + g * (v_c - v_u)
        new_x = schedule.flow_step(x_shard, merged, sigma_now, sigma_next)
        if ph is not None:
            ph.end()
        out = _host(new_x)
        if ph is not None:
            ph.end(out.nbytes)
        out_art.data[rank]["latent"] = out
        out_art.data[rank]["sigma"] = np.float32(sigma_next)
        if ph is not None:
            ph.end()

    # ------------------------------------------------------------------
    def _decode(self, task, layout, graph, ph=None):
        lat_art = graph.artifacts[task.inputs[0]]
        out_art = graph.artifacts[task.outputs[0]]
        leader = layout.ranks[0]
        # the latent may be sharded over this task's layout; assemble each
        # global range ONCE, in offset order — under a CFG shape branch
        # peers hold identical copies of the same range (DESIGN.md §14)
        if lat_art.layout is not None and lat_art.layout.degree > 1:
            lview = field_view(lat_art.fields["latent"], lat_art.layout)
            by_off = {}
            for r in lat_art.layout.ranks:
                off, _ = lview.slices[r]
                if off not in by_off:
                    by_off[off] = lat_art.data[r]["latent"]
            tokens = np.concatenate(
                [by_off[o] for o in sorted(by_off)], axis=0)
        else:
            tokens = lat_art.data[leader]["latent"]           # (N, pd) full
        f, h, w, c = task.meta.get("latent_shape") or \
            self._infer_latent_shape(graph)
        x = self._tensor(tokens)
        if ph is not None:
            ph.end(np.asarray(tokens).nbytes)
        lat = dit.unpatchify(x[None], (1, f, h, w, c),
                             self.cfg.dit.patch_size)
        pixels = vae.decode(self.vae, lat, self.cfg)[0]
        if ph is not None:
            ph.end()
        out = _host(pixels)
        if ph is not None:
            ph.end(out.nbytes)
        out_art.data[leader]["pixels"] = out
        if ph is not None:
            ph.end()

    def _infer_latent_shape(self, graph):
        req = graph.request
        f = max(1, (req.frames + 3) // 4) if req.frames > 1 else 1
        return (f, req.height // 8, req.width // 8, self.cfg.dit.in_channels)
