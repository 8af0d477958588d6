"""Logical-axis sharding and the port's execution convention across ranks
(counterpart of ``repro.parallel.sharding``).

Every parameter in the zoo carries a tuple of *logical* axis names
(``models/layers.py``, ``param_specs``).  ``RULES`` maps logical -> mesh
axes; a mesh axis is used at most once per param (first logical
occurrence wins — MoE expert tensors (EXPERT, EMBED, MLP) shard EXPERT
over 'model' and leave MLP replicated).  A *pspec* is a plain tuple with
one entry per dimension: None (replicated), a mesh-axis name, or a tuple
of two or more names (the dimension split over their product, the first
name major, as in JAX); ``pspec`` normalises entries as JAX's
``PartitionSpec`` does.  ``param_shardings``, ``cache_shardings`` and
``zero1_shardings`` give the reference's plan, entry for entry, for any
mesh that has axis names and sizes: a ``torch.distributed`` DeviceMesh
(``launch/mesh.make_local_mesh``) or an abstract one
(``launch/mesh.make_production_mesh``, what ``launch/dryrun.py`` reads).

How ranks execute.  The reference's ``shard_map`` bodies become code
that every rank runs on its local shards, with explicit
``torch.distributed`` collectives over the process groups of the
DeviceMesh's axes (``axes_group``):

  * activations and batches are split over the data axes (each rank
    holds its rows; a batch that does not divide stays whole) and are
    replicated over 'model';
  * dense weights are replicated over 'model': GSPMD's implicit tensor
    parallelism of whatever ``param_shardings`` shards outside the
    ``shard_map`` bodies is NOT executed (ROADMAP D10); the dry run still
    reports the reference's plan;
  * expert tensors hold their local slice of experts
    (``models/moe.py``'s expert-parallel branch);
  * the sharded cross-entropy reads its rows of the vocab table
    (``parallel/sharded_ce.py``) and the flash-decode its slots of the KV
    cache (``models/attention.flash_decode_gqa``), from full replicated
    tensors;
  * ``local_shard`` cuts a full tensor to the piece a pspec gives a mesh
    coordinate.

Gradients: a collective whose output every rank of the group holds alike
is ``reduce_from_group`` (all-reduce forward, identity backward: the
reference's ``psum`` under ``jax.grad``); a replicated tensor entering
per-shard work is ``copy_to_group`` (identity forward, all-reduce
backward), so that its gradient sums the shards' parts.  After a backward
each rank holds its data shard's part of the reference's gradient
(alike over 'model'); the sum over the data group is ``jax.grad``'s.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

# logical axis -> preferred mesh axis (tuples = shard over several axes;
# trailing members are dropped if the dim doesn't divide their product)
RULES: Dict[Optional[str], object] = {
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    # FSDP for the MoE giants: experts shard over model*data persistently.
    "expert": ("model", "data"),
    "ssm_inner": "model",
    "stack": None,
    None: None,
}

# Full FSDP for the MoE giants (deepseek v2/v3); other archs keep pure TP.
FSDP_RULES: Dict[Optional[str], object] = {
    **RULES,
    "mlp": ("model", "data"),
    "heads": ("model", "data"),
    "kv_heads": ("model", "data"),
    "vocab": ("model", "data"),
}

PSpec = Tuple[object, ...]


def pspec(*entries) -> PSpec:
    """A pspec as the reference's ``PartitionSpec`` holds it: a one-name
    tuple entry becomes the name, an empty one None."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (None if e == () else e) for e in entries)


# ---------------------------------------------------------------------------
# Meshes: axis names and sizes, groups and coordinates
# ---------------------------------------------------------------------------
def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or an abstract mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def axes_group(mesh, axes: Sequence[str]):
    """The process group over ``axes``: one axis's group, or every rank of
    the mesh when ``axes`` name all of its axes."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(axes) == set(mesh.mesh_dim_names) and \
            mesh.size() == tdist.get_world_size():
        return tdist.group.WORLD
    raise NotImplementedError(f"no process group over {axes} of a mesh "
                              f"{axis_sizes(mesh)}")


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        tdist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group``; the backward passes the cotangent
    through (every rank holds the same output, as the reference's
    ``psum``)."""
    return _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the cotangent over ``group`` (a
    replicated tensor that each rank uses for its own shard of work)."""
    return _CopyToGroup.apply(x, group)


# ---------------------------------------------------------------------------
# Specs -> pspecs (the reference's plan)
# ---------------------------------------------------------------------------
def spec_to_pspec(axes: Tuple, rules: Optional[dict] = None) -> PSpec:
    rules = rules or RULES
    used = set()
    out = []
    for a in axes:
        mesh_axis = rules.get(a)
        if isinstance(mesh_axis, tuple):
            fresh = tuple(m for m in mesh_axis if m not in used)
            used.update(fresh)
            out.append(fresh if fresh else None)
            continue
        if mesh_axis in used:
            mesh_axis = None
        if mesh_axis is not None:
            used.add(mesh_axis)
        out.append(mesh_axis)
    return pspec(*out)


def _divisible(shape: Tuple[int, ...], spec: PSpec, mesh) -> PSpec:
    """Drop sharding on dims the mesh doesn't divide evenly (the odd
    vocab sizes, whisper 51865 and mamba2 50280, stay replicated)."""
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) -
                                                       len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        if isinstance(ax, tuple):
            # keep the longest prefix whose product divides the dim
            kept = []
            prod = 1
            for m in ax:
                if dim % (prod * sizes[m]) == 0:
                    kept.append(m)
                    prod *= sizes[m]
                else:
                    break
            fixed.append(tuple(kept) if kept else None)
            continue
        size = sizes[ax] if isinstance(ax, str) else 1
        fixed.append(ax if dim % size == 0 else None)
    return pspec(*fixed)


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def _tree_map(fn, tree, *rest):
    """Leafwise over nested dicts; a spec tuple is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def param_shardings(spec_tree, mesh, shape_tree=None,
                    rules: Optional[dict] = None):
    """Spec tree (tuples of logical axes) -> tree of pspecs.
    ``shape_tree`` (params, e.g. on the ``meta`` device) enables the
    divisibility fixup."""
    if shape_tree is None:
        return _tree_map(lambda axes: spec_to_pspec(axes, rules), spec_tree)
    return _tree_map(
        lambda axes, t: _divisible(tuple(t.shape), spec_to_pspec(axes, rules),
                                   mesh), spec_tree, shape_tree)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def batch_pspec(mesh, example) -> PSpec:
    """Token batches: (B, S, ...) with B over the data axes."""
    return pspec(data_axes(mesh), *([None] * (example.dim() - 1)))


def batch_sharding(mesh, ndim: int = 2) -> PSpec:
    return pspec(data_axes(mesh), *([None] * (ndim - 1)))


def cache_shardings(cache_tree, mesh, global_batch: int):
    """Decode-state pspecs, the reference's rule: B over the data axes when
    divisible, else the slots (SP); slots of a long KV cache over 'model'
    (the flash-decode layout, ``attention.decode_axes``), head-like dims
    over 'model' when they divide."""
    daxes = data_axes(mesh)
    dsize = axes_size(mesh, daxes)
    msize = axis_sizes(mesh).get("model", 1)

    def leaf(t):
        shape = tuple(t.shape)
        spec = [None] * len(shape)
        batched = shape[0] % dsize == 0
        if batched:
            spec[0] = daxes
        elif len(shape) >= 2 and shape[1] >= 1024 and \
                shape[1] % (dsize * msize) == 0:
            spec[1] = daxes + ("model",)         # B=1: slots over ALL axes
        elif len(shape) >= 2 and shape[1] % dsize == 0:
            spec[1] = daxes                      # sequence-sharded cache
        if len(shape) == 4:
            if shape[1] >= 1024:                 # (B, slots, KVH, HD)
                if batched and shape[1] % msize == 0:
                    spec[1] = "model"
                elif not batched and shape[1] % (dsize * msize) == 0:
                    spec[1] = daxes + ("model",)
                elif shape[2] % msize == 0 and shape[2] >= msize:
                    spec[2] = "model"
                elif shape[3] % msize == 0:
                    spec[3] = "model"
            else:                                # (B, H, P, S) ssm state
                if spec[1] is None and shape[1] % msize == 0:
                    spec[1] = "model"
        elif len(shape) == 3:
            if shape[1] >= 1024 and shape[1] % msize == 0 and \
                    spec[1] is None:
                spec[1] = "model"                # MLA compressed cache slots
            elif shape[2] % msize == 0 and shape[2] >= 512:
                spec[2] = "model"                # conv state channels
        elif len(shape) == 2 and shape[1] >= 1024 and \
                shape[1] % msize == 0 and spec[1] is None:
            spec[1] = "model"                    # cache 'pos' metadata
        return pspec(*spec)

    return _tree_map(leaf, cache_tree)


def zero1_shardings(spec_tree, mesh, shape_tree,
                    rules: Optional[dict] = None):
    """ZeRO-1 optimizer-moment pspecs: the params' pspec plus the data
    axes it left unused on the largest still-unsharded divisible dim."""
    daxes = data_axes(mesh)
    sizes = axis_sizes(mesh)

    def leaf(axes, t):
        shape = tuple(t.shape)
        base = _divisible(shape, spec_to_pspec(axes, rules), mesh)
        base = base + (None,) * (len(shape) - len(base))
        used = set()
        for ax in base:
            used.update(ax if isinstance(ax, tuple) else (ax,))
        avail = tuple(a for a in daxes if a not in used)
        if not avail:
            return pspec(*base)
        asize = 1
        for a in avail:
            asize *= sizes[a]
        best, best_dim = None, 0
        for i, (dim, ax) in enumerate(zip(shape, base)):
            if ax is None and dim % asize == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is not None:
            base = base[:best] + (avail,) + base[best + 1:]
        return pspec(*base)

    return _tree_map(leaf, spec_tree, shape_tree)


def replicated(mesh) -> PSpec:
    return ()


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------
def local_shard(t: torch.Tensor, spec: PSpec, mesh,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The piece of the full tensor ``t`` that ``spec`` gives the rank at
    ``coords`` ({axis: index}; default this rank's on a DeviceMesh).  A
    dimension over several axes is split over their product, the first
    axis major.  Every sharded dimension must divide."""
    sizes = axis_sizes(mesh)
    if coords is None:
        coords = {a: mesh.get_local_rank(a) for a in sizes}
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide over {axes} ({n})")
        step = t.shape[dim] // n
        t = t.narrow(dim, idx * step, step)
    return t
