"""Vocab-sharded cross-entropy (counterpart of
``repro.parallel.sharded_ce``).

Each model rank computes the logits of its rows of the vocab table,
(B_loc, S, V / |model|) in float32, never the whole (B, S, V):

  * logsumexp runs locally against a stop-gradient global max
    (``all_reduce(MAX)`` over the model group); the partition functions
    are summed over it;
  * the target logit is picked by the rank whose rows hold the target id,
    and summed over the model group (exactly one rank contributes);
  * the mean is over the GLOBAL batch: the local per-token sum is summed
    over the data group and divided by the global token count.

Every rank reads its vocab rows from the full table (replicated, as every
dense weight is: ``parallel/sharding.py``).  The collectives are written
so that the backward is ``jax.grad``'s (``sharding.reduce_from_group``,
``copy_to_group``): the hidden states' and the table's gradients are
summed over the model group, so every model rank holds the same ones —
not ``|model|`` times them, as ``torch.distributed.nn``'s all-reduce
would give a loss that every model rank computes alike.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from repro_torch.models.moe import DistCtx
from repro_torch.parallel import sharding as shd


def _local_loss(table, hidden, targets, my: int, group) -> torch.Tensor:
    """Per-rank body.  table: (V_loc, D), this rank's rows; hidden:
    (B_loc, S, D) -> per-token loss (B_loc, S), alike on every model
    rank."""
    v_loc = table.shape[0]
    logits = torch.einsum("bsd,vd->bsv", hidden.to(torch.float32),
                          table.to(torch.float32))         # (B,S,V_loc)
    gmax = logits.detach().amax(-1)
    tdist.all_reduce(gmax, op=tdist.ReduceOp.MAX, group=group)
    sumexp = torch.exp(logits - gmax[..., None]).sum(-1)
    lse = torch.log(shd.reduce_from_group(sumexp, group)) + gmax
    local_ids = targets.long() - my * v_loc
    in_range = (local_ids >= 0) & (local_ids < v_loc)
    picked = torch.gather(logits, -1,
                          local_ids.clamp(0, v_loc - 1)[..., None])[..., 0]
    tgt = shd.reduce_from_group(torch.where(in_range, picked, 0.0), group)
    return lse - tgt


def global_mean(local: torch.Tensor, dist: DistCtx) -> torch.Tensor:
    """The mean over the global batch of per-token values split over the
    data axes (an even split)."""
    n = shd.axes_size(dist.mesh, dist.data_axes)
    total = local.sum()
    if n > 1:
        total = shd.reduce_from_group(
            total, shd.axes_group(dist.mesh, dist.data_axes))
    return total / (local.numel() * n)


def sharded_xent(head_table: torch.Tensor, hidden: torch.Tensor,
                 targets: torch.Tensor, dist: DistCtx) -> torch.Tensor:
    """Mean next-token CE with vocab-sharded logits, a 0-d float32 tensor
    alike on every rank.

    head_table: (V, D), the full table; hidden: (B_loc, S, D) and targets
    (B_loc, S): this rank's batch rows.  Requires V % |model| == 0
    (``supports``)."""
    mesh = dist.mesh
    group = shd.axes_group(mesh, (dist.model_axis,))
    my = mesh.get_local_rank(dist.model_axis)
    table = shd.local_shard(shd.copy_to_group(head_table, group),
                            (dist.model_axis, None), mesh)
    per_token = _local_loss(table, shd.copy_to_group(hidden, group),
                            targets, my, group)
    return global_mean(per_token, dist)


def supports(vocab: int, dist: DistCtx) -> bool:
    return dist.mesh is not None and vocab % dist.model_shards == 0
