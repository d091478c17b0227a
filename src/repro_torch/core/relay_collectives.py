"""In-mesh relay collectives: the paper's routing insight over a process group.

The campaign's key trick was *relay routing*: read the slow source once, then
forward replica→replica over fast links, with the hops overlapping
(LLNL→ALCF concurrent with ALCF→OLCF).  Across the ranks of a process group
the same pattern is a **pipelined chain broadcast**: chunk k moves hop i→i+1
while chunk k−1 moves hop i+1→i+2.  For P ranks and n chunks the wall-clock
is ``bytes/BW * (1 + (P-2)/n)`` vs ``(P-1) * bytes/BW`` for a naive source
fan-out over the same links.

A port of the JAX package's ``core/relay_collectives.py``.  Its functions
run inside ``shard_map`` with ``jax.lax.ppermute`` over a named mesh axis;
here each ``*_inner`` function runs on every rank of ``group`` (a
``torch.distributed`` process group, the world by default) with the rank's
own slice ``x``, and moves it with point-to-point ``isend``/``irecv``.  The
results are the reference's slice for slice: a rank that the reference
leaves at zeros (a relay rank before ``src`` in the chain) is zeros here
too.  At group size 1 every function returns ``x``, as the reference does.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def _ranks(group: Group):
    """(this rank's index in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def _peer(group: Group, r: int) -> int:
    """The global rank of ``group``'s rank ``r``."""
    return r if group is None else dist.get_global_rank(group, r)


def _exchange(ops: List[dist.P2POp]) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def relay_broadcast_inner(x: torch.Tensor, group: Group = None, src: int = 0,
                          n_chunks: int = 4) -> torch.Tensor:
    """Broadcast ``src``'s ``x`` down the chain of ``group``'s ranks
    src → src+1 → ... in ``min(n_chunks, x.shape[0])`` chunks of axis 0,
    pipelined: at time step s, hop j (rank src+j → src+j+1) carries chunk
    s − j.  Ranks after ``src`` return ``src``'s ``x``; ``src`` returns its
    own; ranks before it return zeros, as the reference's chain leaves
    them."""
    idx, size = _ranks(group)
    if size == 1:
        return x
    lead = x.shape[0]
    n_chunks = min(n_chunks, lead) or 1
    assert lead % n_chunks == 0, (lead, n_chunks)
    x = x.contiguous()
    out = x.clone() if idx == src else torch.zeros_like(x)
    chunks = list(torch.chunk(out, n_chunks, dim=0))
    j = idx - src                                 # distance down the chain
    if j < 0:
        return out
    hops = size - 1 - src
    for s in range(n_chunks + hops - 1):
        ops = []
        k_send, k_recv = s - j, s - (j - 1)
        if idx + 1 < size and 0 <= k_send < n_chunks:
            ops.append(dist.P2POp(dist.isend, chunks[k_send],
                                  _peer(group, idx + 1), group))
        if j >= 1 and 0 <= k_recv < n_chunks:
            ops.append(dist.P2POp(dist.irecv, chunks[k_recv],
                                  _peer(group, idx - 1), group))
        _exchange(ops)
    return out


def relay_broadcast(x: torch.Tensor, mesh, axis: str = "pod", src: int = 0,
                    n_chunks: int = 4) -> torch.Tensor:
    """Relay along the mesh dimension ``axis`` (its sub-group of ranks).
    ``x`` is a DTensor sharded on axis 0 over ``axis`` (each slice a rank's
    block; the result keeps the placements) or this rank's plain slice."""
    from torch.distributed.tensor import DTensor
    group = mesh.get_group(axis)
    if isinstance(x, DTensor):
        local = relay_broadcast_inner(x.to_local(), group, src, n_chunks)
        return DTensor.from_local(local, mesh, x.placements,
                                  shape=x.shape, stride=x.stride())
    return relay_broadcast_inner(x, group, src, n_chunks)


def naive_broadcast_inner(x: torch.Tensor, group: Group = None,
                          src: int = 0) -> torch.Tensor:
    """Source fans out to every destination directly (the 2×58-day plan the
    paper rejected): P−1 full-size sends, one after another, all leaving
    ``src``'s single egress link.  Every rank returns ``src``'s ``x``."""
    idx, size = _ranks(group)
    if size == 1:
        return x
    y = x.contiguous().clone() if idx == src else torch.zeros_like(x)
    for d in range(size):
        if d == src:
            continue
        if idx == src:
            dist.send(y, _peer(group, d), group)
        elif idx == d:
            dist.recv(y, _peer(group, src), group)
    return y


def ring_all_gather_inner(x: torch.Tensor, group: Group = None
                          ) -> torch.Tensor:
    """Bandwidth-optimal ring all-gather (the building block for
    overlap-friendly FSDP prefetch; each step moves 1/P of the result):
    P−1 steps, each sending the last piece received to rank i+1 and
    receiving from rank i−1.  Returns the ranks' slices concatenated on
    axis 0 in rank order."""
    idx, size = _ranks(group)
    if size == 1:
        return x
    nxt, prv = _peer(group, (idx + 1) % size), _peer(group, (idx - 1) % size)
    cur = x.contiguous()
    pieces = [cur]
    for _ in range(size - 1):
        got = torch.empty_like(cur)
        _exchange([dist.P2POp(dist.isend, cur, nxt, group),
                   dist.P2POp(dist.irecv, got, prv, group)])
        pieces.append(got)
        cur = got
    # piece j is rank (idx - j) mod P's slice: roll into canonical order
    canonical = [pieces[(idx - r) % size] for r in range(size)]
    return torch.cat(canonical, dim=0)


def estimate_relay_time(total_bytes: float, link_bw: float, p: int,
                        n_chunks: int) -> float:
    """Analytic pipeline model (per-link serialization)."""
    if p <= 1:
        return 0.0
    chunk = total_bytes / n_chunks
    return (n_chunks + p - 2) * chunk / link_bw


def estimate_naive_time(total_bytes: float, link_bw: float, p: int) -> float:
    """Naive fan-out: all P-1 copies leave the source's single egress link."""
    if p <= 1:
        return 0.0
    return (p - 1) * total_bytes / link_bw
