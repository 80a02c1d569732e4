"""Multi-device layer: the sharded coset LDE and Merkle tree over
`torch.distributed`.

Port of `plonky3_tpu/parallel/`, whose functions run SPMD over a JAX mesh
with GSPMD placing the collectives. Here each rank is one process with an
explicit process group; a matrix is row-sharded, each rank holding one
contiguous block of its rows, and every collective is written out
below. NCCL runs them on CUDA tensors. Gloo runs them on CPU tensors only,
so a CUDA tensor under gloo (two ranks on one card, where NCCL refuses a
second rank) is staged through the host and copied back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def world_rank(group=None):
    return dist.get_world_size(group), dist.get_rank(group)


def _staged(t, group):
    """(tensor to hand the backend, device to return to)."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return t.cpu(), t.device
    return t, None


def all_gather_rows(local, group=None):
    """Every rank's (m, ...) block, concatenated in rank order."""
    world, _ = world_rank(group)
    send, back = _staged(local.contiguous(), group)
    out = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(out, send, group=group)
    full = torch.cat(out)
    return full if back is None else full.to(back)


def all_to_all_rows(blocks, recv_rows, group=None):
    """blocks[q] (a (k_q, ...) tensor) goes to rank q; returns the blocks
    received, from rank p at index p, with recv_rows[p] rows each. One
    batch of point-to-point sends and receives on either backend, empty
    blocks skipped (both ends know the counts)."""
    world, rank = world_rank(group)
    rest = tuple(blocks[0].shape[1:])
    dtype = blocks[0].dtype
    staged = [_staged(b.contiguous(), group) for b in blocks]
    back = staged[0][1]
    dev = staged[0][0].device
    recv = [torch.empty((r,) + rest, dtype=dtype, device=dev)
            for r in recv_rows]
    recv[rank] = staged[rank][0]
    peer = (lambda q: q) if group is None else (
        lambda q: dist.get_global_rank(group, q))
    ops = [dist.P2POp(dist.isend, staged[q][0], peer(q), group)
           for q in range(world) if q != rank and blocks[q].shape[0]]
    ops += [dist.P2POp(dist.irecv, recv[p], peer(p), group)
            for p in range(world) if p != rank and recv_rows[p]]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv if back is None else [r.to(back) for r in recv]


def route_rows(local, dst_of, m_src: int, m_dst: int, group=None):
    """Move rows between two row-sharded layouts of one global array.

    Rank p holds the global source rows [p·m_src, (p+1)·m_src) as `local`;
    `dst_of(src)` maps a numpy array of source positions to their
    destination positions (a one-to-one map into [0, world·m_dst)). Returns
    this rank's destination block [rank·m_dst, (rank+1)·m_dst), rows that
    no source maps to left zero. Every rank evaluates `dst_of` over every
    source block, so the counts and places need no exchange of their own:
    one all_to_all moves the rows."""
    world, rank = world_rank(group)
    dev = local.device
    sends, counts, places = [], [], []
    for p in range(world):
        dst = np.asarray(dst_of(np.arange(p * m_src, (p + 1) * m_src,
                                          dtype=np.int64)))
        owner = dst // m_dst
        if p == rank:
            for q in range(world):
                idx = np.nonzero(owner == q)[0]
                sends.append(local.index_select(
                    0, torch.from_numpy(idx).to(dev)))
        mine = owner == rank
        counts.append(int(mine.sum()))
        places.append(dst[mine] - rank * m_dst)
    got = all_to_all_rows(sends, counts, group)
    out = torch.zeros((m_dst,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=dev)
    idx = torch.from_numpy(np.concatenate(places)).to(dev)
    out.index_copy_(0, idx, torch.cat(got))
    return out
