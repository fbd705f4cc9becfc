"""Sequence-parallel attention primitives (beyond-paper optimizations).

Port of ``repro/sharding/sp.py``.  ``flash_decode``: decode attention
against a SEQUENCE-SHARDED KV cache without gathering it.  Gathering the
S-sharded K/V costs O(B·S·KV·hd) bytes a step; here each rank computes
a local partial softmax (m, l, o) over its sequence shard and the ranks
combine with an all-reduce of the max and of the sums, so the collective
payload drops to O(B·H·hd).

JAX runs the body under ``shard_map`` on global arrays.  The port runs
it in each rank's process (``torch.distributed``) on the rank's own
tensors: its S/n shard of the cache and, over the mesh's batch axes, its
part of the batch.  The cache update is local and in place: only the
rank that owns position ``len`` writes the new K/V.  Given ``DTensor``
operands (the dry run's), it runs on each rank's local tensors through
``local_map``, with JAX's ``shard_map`` specs as placements.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding.ctx import per_rank


def flash_decode(q, k_new, v_new, cache_k, cache_v, cache_len, *,
                 mesh: DeviceMesh, axis: str = "model"):
    """This rank's part of a decode step.  q: (B, 1, H, hd) roped;
    k_new/v_new: (B, 1, KV, hd) roped; cache_k/v: (B, S/n, KV, hd), the
    rank's shard of the sequence over ``axis`` (n ranks), written in
    place; cache_len: (B,) int, the position of the new token (row 0's is
    the one written, as in JAX).

    Returns (out (B, 1, H, hd), cache_k, cache_v): the output is the same
    on every rank of ``axis``.
    """
    if isinstance(q, DTensor):
        return _flash_decode_sharded(q, k_new, v_new, cache_k, cache_v,
                                     cache_len, mesh=mesh, axis=axis)
    b, _, h, hd = q.shape
    s_loc, kv = cache_k.shape[1], cache_k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    i = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)

    # the owner writes the new row; every other rank rewrites a row with
    # its own contents (the masked dynamic-update-slice, without a host
    # sync on the position)
    local_pos = cache_len[:1].long() - i * s_loc
    owner = (local_pos >= 0) & (local_pos < s_loc)
    safe = local_pos.clamp(0, s_loc - 1)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        row = torch.where(owner[:, None, None, None], new.to(cache.dtype),
                          cache.index_select(1, safe))
        cache.index_copy_(1, safe, row)

    # grouped-head attention directly against the GQA cache: K/V are
    # never repeated
    bq = q.reshape(b, 1, kv, rep, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", bq.float(),
                          cache_k.float()) * scale
    kpos = i * s_loc + torch.arange(s_loc, device=q.device)
    valid = kpos[None, :] < (cache_len + 1)[:, None]          # (B, s_loc)
    scores = scores.masked_fill(~valid[:, None, None, None], -1e30)
    m_g = scores.amax(dim=-1)                                 # (B,KV,rep,1)
    p = torch.exp(scores - m_g[..., None])
    l_g = p.sum(dim=-1)                                       # (B,KV,rep,1)
    dt = torch.promote_types(q.dtype, cache_v.dtype)
    o_g = torch.einsum("bgrqk,bkgd->bqgrd", p.to(q.dtype).to(dt),
                       cache_v.to(dt))
    m_loc = m_g.reshape(b, h, 1)
    l_loc = l_g.reshape(b, h, 1)
    o_loc = o_g.reshape(b, 1, h, hd)

    # combine across sequence shards (flash-decoding reduction)
    m = m_loc.clone()
    dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_loc - m)
    l = l_loc * corr
    dist.all_reduce(l, dist.ReduceOp.SUM, group=group)
    o = o_loc * corr.transpose(1, 2)[..., None].to(o_loc.dtype)
    dist.all_reduce(o, dist.ReduceOp.SUM, group=group)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None].to(o_loc.dtype)
    return out, cache_k, cache_v


def _flash_decode_sharded(q, k_new, v_new, cache_k, cache_v, cache_len, *,
                          mesh: DeviceMesh, axis: str):
    """:func:`flash_decode` on ``DTensor`` operands: JAX's ``shard_map``
    specs as placements (the batch over the mesh's batch axes where it
    divides, the cache's sequence over ``axis``, the rest replicated),
    the body on each rank's local tensors."""
    names = mesh.mesh_dim_names
    batch = [n in ("pod", "data") for n in names]
    n_batch = 1
    for n, b in zip(names, batch):
        n_batch *= mesh.size(names.index(n)) if b else 1
    split = q.shape[0] % n_batch == 0
    act = tuple(Shard(0) if b and split else Replicate() for b in batch)
    seq = tuple(Shard(1) if n == axis else pl for n, pl in zip(names, act))

    def body(*local):
        return flash_decode(*local, mesh=mesh, axis=axis)
    return per_rank(body, (act, seq, seq), (act, act, act, seq, seq, act),
                    mesh)(q, k_new, v_new, cache_k, cache_v, cache_len)
