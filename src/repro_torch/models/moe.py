"""Mixture-of-Experts FFN, single device (counterpart of
``repro.models.moe``).

DeepSeek-style: ``num_shared_experts`` always-on shared experts (one MLP
of width ``num_shared_experts * d_ff_expert``, through ``layers.mlp`` and
so through a ``PhotonicCtx``) plus ``num_experts`` routed experts with
top-k routing under a fixed per-expert capacity.  The routed experts'
three products are plain batched matmuls, exact under a photonic ctx, as
in the reference (no Pallas kernel computes them there).

``DistCtx`` says how an apply is distributed (``LOCAL``: one process).
With one model shard every (token, expert) slot is selected and the slot
capacity ``round8(int(1.25 t k))`` is at least ``t k``, so the
reference's ``argsort(~sel)`` is the identity and slot ``i`` belongs to
token ``i // k``: that route (``route`` + ``dispatch_combine``) is the
one-shard body.  What decides the result is kept exactly:

  * routing (``route``): the router's product in x's dtype, then float32;
    softmax, ``top_k`` (descending, as ``jax.lax.top_k``), renormalised;
  * the per-expert capacity ``cap_e = round8(int(1.25 t k) // E)`` (192
    at deepseek-v2's prefill of 4000 tokens, 8 in its 4-token decode
    step) and the drop rule: a slot's position is the running count of
    its expert over the slots in order (token-major, then rank), and a
    slot at position ``cap_e`` or beyond is dropped;
  * the combine: each token's k slot outputs added in rank order in x's
    dtype, as the reference's scatter-add adds them one at a time.  It is
    a fixed-order sum, not ``index_add_``, whose float atomics would make
    a CUDA-graph replay differ from an eager step.

Nothing synchronises the host (no ``.item()``, masks or ``nonzero``; the
one-hot is a comparison), so a decode step with MoE layers captures in a
CUDA graph.  ``route`` and ``dispatch_combine`` are split so that a test
can feed the reference's routing: routing is discontinuous, and a one-ulp
difference in the router's input can swap an expert.

Expert parallelism (the reference's ``shard_map`` branch, a mesh whose
'model' axis has n > 1 ranks): every model rank holds the activations of
its data shard and its slice of E / n experts (``parallel/sharding.py``),
runs ``_routed_local(..., n, my_shard)`` — the reference's per-shard body
to the letter: the full routing, the (token, expert) slots its experts
own, at most ``cap = min(round8(int(t k cf) // n), t k)`` of them in
``argsort(~sel, stable)`` order, a per-expert capacity
``round8(int(cap cf) // (E / n))`` — and the partial outputs are summed
over the model group (``all_reduce``).  Its dispatch and combine are
written without atomics (each token's slots added in rank order), so a
rank's part does not depend on the order threads run in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class DistCtx:
    """How a model apply is distributed (mesh None = one process).
    ``mesh``: a ``torch.distributed`` DeviceMesh
    (``launch/mesh.make_local_mesh``)."""
    mesh: Optional[object] = None
    data_axes: tuple = ("data",)           # ("pod","data") when multi-pod
    model_axis: str = "model"

    @property
    def model_shards(self) -> int:
        if self.mesh is None:
            return 1
        return shd.axis_sizes(self.mesh)[self.model_axis]


LOCAL = DistCtx()


def make_moe(maker: L.ParamMaker, name: str, d_model: int,
             cfg: MoEConfig) -> dict:
    e, f = cfg.num_experts, cfg.d_ff_expert
    p = {
        "router": maker.param(f"{name}.router", (d_model, e),
                              (L.EMBED, L.EXPERT), scale=d_model ** -0.5),
        "gate": maker.param(f"{name}.gate", (e, d_model, f),
                            (L.EXPERT, L.EMBED, L.MLP)),
        "up": maker.param(f"{name}.up", (e, d_model, f),
                          (L.EXPERT, L.EMBED, L.MLP)),
        "down": maker.param(f"{name}.down", (e, f, d_model),
                            (L.EXPERT, L.MLP, L.EMBED)),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.make_mlp(maker, f"{name}.shared", d_model,
                                 cfg.num_shared_experts * f)
    return p


def _round8(x: int) -> int:
    return max(8, ((x + 7) // 8) * 8)


def expert_capacity(t: int, cfg: MoEConfig) -> int:
    """Slots an expert takes for ``t`` tokens: the reference's ``cap_e``
    with one shard (its slot capacity is then ``t k``)."""
    k = cfg.experts_per_token
    cap = min(_round8(int(t * k * cfg.capacity_factor)), t * k)
    return _round8(int(cap * cfg.capacity_factor) // max(cfg.num_experts, 1))


def router_probs(router_w: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """(T, E) float32 softmax of the router's logits; the product in x's
    dtype (the reference casts the router through float32 to it)."""
    logits = (xf @ router_w.to(xf.dtype)).to(torch.float32)
    return torch.softmax(logits, dim=-1)


def route(router_w: torch.Tensor, xf: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xf (T, D) -> (top_p (T, k) float32 renormalised, top_e (T, k) int64),
    each row in descending order of probability."""
    top_p, top_e = torch.topk(router_probs(router_w, xf),
                              cfg.experts_per_token, dim=-1, sorted=True)
    return top_p / top_p.sum(-1, keepdim=True), top_e


def slot_positions(top_e: torch.Tensor, cfg: MoEConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(pos (T k,), keep (T k,), cap_e): each slot's position in its
    expert (the running count over the slots in order, from 0), whether it
    is within the capacity, and the capacity."""
    e = cfg.num_experts
    eid = top_e.reshape(-1)
    cap_e = expert_capacity(top_e.shape[0], cfg)
    # The one-hot laid out (E, T k): the running count is then a scan
    # along contiguous rows; over the outer axis of a (T k, E) layout the
    # card's scan is many times slower.
    grp = (torch.arange(e, device=eid.device)[:, None] == eid[None, :]) \
        .to(torch.int32)                                    # (E, T k)
    pos = torch.gather(torch.cumsum(grp, dim=1, dtype=torch.int32), 0,
                       eid[None, :])[0] - 1
    return pos, pos < cap_e, cap_e


def dispatch_combine(gate_w, up_w, down_w, x: torch.Tensor,
                     top_p: torch.Tensor, top_e: torch.Tensor,
                     cfg: MoEConfig) -> torch.Tensor:
    """The routed experts for a given routing: x (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_token, cfg.num_experts
    xf = x.reshape(t, d)
    eid = top_e.reshape(t * k)
    pos, keep, cap_e = slot_positions(top_e, cfg)
    pos = torch.clamp(pos, 0, cap_e - 1)
    # Dispatch: kept slots hold distinct (expert, position) rows; dropped
    # ones are copied to a spare last row, which is discarded.
    dest = torch.where(keep, eid * cap_e + pos, e * cap_e)
    disp = xf.new_zeros((e * cap_e + 1, d))
    disp.index_copy_(0, dest, xf[:, None].expand(t, k, d).reshape(-1, d))
    disp = disp[:-1].reshape(e, cap_e, d)
    h = L.silu(torch.bmm(disp, gate_w)) * torch.bmm(disp, up_w)
    out_e = torch.bmm(h, down_w).reshape(e * cap_e, d)      # (E Ce, D)
    w_slots = (top_p.reshape(t * k) * keep).to(x.dtype)
    y = (out_e[eid * cap_e + pos] * w_slots[:, None]).reshape(t, k, d)
    acc = y[:, 0]
    for j in range(1, k):           # rank order, rounded in x's dtype
        acc = acc + y[:, j]
    return acc.reshape(b, s, d)


def _routed_local(router_w, gate_w, up_w, down_w, x: torch.Tensor,
                  cfg: MoEConfig, n_shards: int = 1,
                  my_shard: int = 0) -> torch.Tensor:
    """Routed-expert compute for ONE model shard: x (B, S, D) -> this
    shard's partial output (zeros for tokens routed elsewhere).
    gate/up/down: the shard's (E / n_shards, ...) slice of experts."""
    top_p, top_e = route(router_w, x.reshape(-1, x.shape[-1]), cfg)
    if n_shards == 1:
        return dispatch_combine(gate_w, up_w, down_w, x, top_p, top_e, cfg)
    b, s, d = x.shape
    t, k = b * s, cfg.experts_per_token
    e_loc = cfg.num_experts // n_shards
    xf = x.reshape(t, d)

    # --- the (token, expert) slots this shard owns, selected first ---
    eid = top_e.reshape(t * k)
    wgt = top_p.reshape(t * k)
    sel = (eid // e_loc) == my_shard
    cap = min(_round8(int(t * k * cfg.capacity_factor) // n_shards), t * k)
    slots = torch.argsort((~sel).to(torch.int8), stable=True)[:cap]
    valid = sel[slots]
    e_local = torch.where(valid, eid[slots] - my_shard * e_loc, 0)
    w_slots = torch.where(valid, wgt[slots], 0.0)

    # --- group by local expert under a per-expert capacity ---
    cap_e = _round8(int(cap * cfg.capacity_factor) // max(e_loc, 1))
    grp = (e_local[:, None] == torch.arange(e_loc, device=x.device)) & \
        valid[:, None]                                      # (cap, E_loc)
    pos = torch.gather(torch.cumsum(grp.to(torch.int32), dim=0), 1,
                       e_local[:, None])[:, 0] - 1
    keep = valid & (pos >= 0) & (pos < cap_e)
    pos = torch.clamp(pos, 0, cap_e - 1)
    # Kept slots hold distinct (expert, position) rows; the others go to a
    # spare last row, which is discarded.
    dest = torch.where(keep, e_local * cap_e + pos, e_loc * cap_e)
    disp = xf.new_zeros((e_loc * cap_e + 1, d))
    disp.index_copy_(0, dest, xf[slots // k])
    disp = disp[:-1].reshape(e_loc, cap_e, d)
    h = L.silu(torch.bmm(disp, gate_w)) * torch.bmm(disp, up_w)
    out_e = torch.bmm(h, down_w).reshape(e_loc * cap_e, d)
    y_slots = out_e[e_local * cap_e + pos] * \
        (w_slots * keep)[:, None].to(x.dtype)
    # --- combine: each token's slots in rank order (slots are distinct) ---
    y = xf.new_zeros((t * k, d)).index_copy_(0, slots, y_slots)
    y = y.reshape(t, k, d)
    acc = xf.new_zeros((t, d))
    for j in range(k):
        acc = acc + y[:, j]
    return acc.reshape(b, s, d)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            ctx: L.PhotonicCtx = L.EXACT_CTX, name: str = "moe",
            dist: DistCtx = LOCAL) -> torch.Tensor:
    """Shared experts + routed experts.  See the module docstring; with
    ``dist.model_shards > 1`` ``params``' expert tensors are this rank's
    slice and the routed part is summed over the model group."""
    n_shards = dist.model_shards
    if n_shards == 1:
        routed = _routed_local(params["router"], params["gate"],
                               params["up"], params["down"], x, cfg)
    else:
        group = shd.axes_group(dist.mesh, (dist.model_axis,))
        my = dist.mesh.get_local_rank(dist.model_axis)
        part = _routed_local(shd.copy_to_group(params["router"], group),
                             params["gate"], params["up"], params["down"],
                             shd.copy_to_group(x, group), cfg, n_shards, my)
        routed = shd.reduce_from_group(part, group)
    if "shared" not in params:
        return routed
    return L.mlp(params["shared"], x, ctx, f"{name}.shared") + routed


def load_balance_loss(params: dict, x: torch.Tensor,
                      cfg: MoEConfig) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (mean fraction * prob)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax((xf @ params["router"].to(xf.dtype))
                          .to(torch.float32), -1)
    top_e = torch.argmax(probs, dim=-1)
    frac = (top_e[:, None] == torch.arange(cfg.num_experts,
                                           device=x.device)) \
        .to(torch.float32).mean(0)
    imp = probs.mean(0)
    return cfg.num_experts * torch.sum(frac * imp)
