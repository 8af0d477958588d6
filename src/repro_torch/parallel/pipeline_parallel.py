"""Pipeline parallelism (counterpart of
``repro.parallel.pipeline_parallel``; an optional extra, off the main
paths).

GPipe over a mesh axis: the rank at stage s holds layer slice s and hands
its activation to stage s + 1 every tick (``batch_isend_irecv`` around
the ring, the reference's ``ppermute``).  M microbatches finish in
M + S - 1 ticks; bubble fraction = (S - 1) / (S + M - 1).  At one stage
the hop is the identity (no send to self).  Forward only (microbatched
inference or eval), as the reference's.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as tdist

from repro_torch.models.transformer import tree_map


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)


def _ring_hop(y: torch.Tensor, stage: int, n_stages: int,
              group) -> torch.Tensor:
    """y from every stage to the next (the last to the first)."""
    if n_stages == 1:
        return y
    recv = torch.empty_like(y)
    peer = (lambda i: tdist.get_global_rank(group, i % n_stages))
    ops = [tdist.P2POp(tdist.isend, y.contiguous(), peer(stage + 1), group),
           tdist.P2POp(tdist.irecv, recv, peer(stage - 1), group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return recv


def pipeline_forward(block_fn: Callable, stage_params, x: torch.Tensor,
                     mesh, axis: str = "stage") -> torch.Tensor:
    """Run x through the S stages of ``mesh``'s ``axis`` (a DeviceMesh)
    with microbatching; every rank of the axis calls this.

    block_fn(stage_param_slice, mb) -> mb : one stage's computation.
    stage_params: nested dicts whose leaves have a leading stage axis of
    S; the rank reads its own row.  x: (M, mb, features...) microbatches,
    alike on every rank (stage 0 injects them in order).  Returns
    (M, mb, features...) outputs on every rank: the last stage's, summed
    over the axis (the reference's ``psum``).
    """
    group = mesh.get_group(axis)
    n_stages = tdist.get_world_size(group)
    stage = mesh.get_local_rank(axis)
    m_total = x.shape[0]
    p = tree_map(lambda a: a[stage], stage_params)
    carry = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(m_total + n_stages - 1):
        inject = x[min(t, m_total - 1)] if stage == 0 else carry
        y = block_fn(p, inject)
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and done >= 0:
            outputs[done] = y
        carry = _ring_hop(y, stage, n_stages, group)
    tdist.all_reduce(outputs, group=group)
    return outputs
