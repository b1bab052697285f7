"""Mixture-of-Experts FFN with capacity-based dispatch (the port of the
JAX package's ``models/moe.py``).

Routing is token-choice top-k with per-expert capacity
``C = max(4, ceil(T * k * capacity_factor / E))`` over the T tokens of
the call; assignments past an expert's capacity are dropped (GShard
semantics), in the arrival order of the token-major flattened [T·k]
assignments.  ``capacity_factor >= E / k`` makes dispatch lossless, and
then ``moe_ffn`` equals the dense oracle ``ref_dense_moe``.

The JAX package has no Pallas kernel here: the router, the dispatch and
the expert products (``ecd,edf->ecf``) are plain ``jnp``, and so they
are plain torch in the port, float32 with TF32 off on the card.  One
card is one rank, so the JAX ``shard_hint``s have no counterpart.

Every shape is fixed by T (the slot tables are [E+1, C], the gathers
go through ``slot_of`` [T, k]), and nothing reads a routing result on
the host: no ``.item()``, no ``nonzero``, no boolean-mask indexing.  So
the decode step that calls ``moe_ffn`` over its B tokens stays one CUDA
graph.  The writes into the slot tables are ``scatter_`` over distinct
(expert, position) slots; the dropped assignments all land on row E,
which is discarded.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import MoESpec
from .layers import activate
from .params import ParamDef


def moe_defs(d_model: int, m: MoESpec) -> dict:
    e, f = m.n_experts, m.d_ff_expert
    d = {
        "router": ParamDef((d_model, e), ("embed", None)),
        "w_in": ParamDef((e, d_model, f), ("experts", "embed", "ff")),
        "w_gate": ParamDef((e, d_model, f), ("experts", "embed", "ff")),
        "w_out": ParamDef((e, f, d_model), ("experts", "ff", "embed")),
    }
    if m.n_shared:
        d["shared_in"] = ParamDef((d_model, m.n_shared * f), ("embed", "ff"))
        d["shared_gate"] = ParamDef((d_model, m.n_shared * f),
                                    ("embed", "ff"))
        d["shared_out"] = ParamDef((m.n_shared * f, d_model),
                                   ("ff", "embed"))
    return d


def capacity(n_tokens: int, m: MoESpec) -> int:
    c = math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, int(c))


def route(router_w, x, m: MoESpec):
    """Returns (weights [T,k], expert ids [T,k], aux loss).  The router
    runs in float32; the top k are the first k of a stable descending
    sort, so a tie goes to the lower expert index as ``lax.top_k``
    breaks it.  aux is the Switch balance term over every routed id
    (dropped ones included) plus the router z-loss."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                    # [T,E]
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = srt[:, :m.top_k], order[:, :m.top_k]            # [T,k]
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    T = x.shape[0]
    me = torch.mean(probs, dim=0)                            # [E]
    ce = torch.zeros(m.n_experts, dtype=torch.float32, device=x.device)
    ce = ce.scatter_add_(0, ids.reshape(-1),
                         torch.ones(ids.numel(), device=x.device))
    ce = ce / (T * m.top_k)
    aux = m.n_experts * torch.sum(me * ce) * m.aux_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_zloss
    return w, ids, aux + z


def dispatch_indices(ids, w, m: MoESpec, cap: int):
    """GShard position-in-expert.  ids / w: [T, k].  Returns the token
    index table [E, C], the combine weights [E, C], the validity [E, C]
    and the inverse map ``slot_of`` [T, k] into the flattened [E·C]
    slots (a dropped assignment points at slot E·C, a zero row on the
    combine side).  Unfilled slots hold token 0, weight 0, invalid."""
    T, k = ids.shape
    E = m.n_experts
    dev = ids.device
    flat_ids = ids.reshape(-1)                               # [T*k]
    onehot = (flat_ids[:, None]
              == torch.arange(E, device=dev)[None, :]).long()  # [T*k, E]
    pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
    keep = pos < cap
    tok_of = torch.arange(T, device=dev).repeat_interleave(k)
    # (expert, position) of each kept assignment, every drop on row E
    flat = (torch.where(keep, flat_ids, E) * cap
            + torch.where(keep, pos, 0))
    n = (E + 1) * cap
    tok = torch.zeros(n, dtype=torch.long, device=dev).scatter_(0, flat,
                                                                tok_of)
    cw = torch.zeros(n, dtype=w.dtype, device=dev).scatter_(
        0, flat, w.reshape(-1))
    val = torch.zeros(n, dtype=torch.bool, device=dev).scatter_(0, flat,
                                                                keep)
    slot_of = torch.where(keep, flat_ids * cap + pos,
                          torch.full_like(pos, E * cap)).reshape(T, k)
    return (tok.view(E + 1, cap)[:E], cw.view(E + 1, cap)[:E],
            val.view(E + 1, cap)[:E], slot_of)


def _shared(p, x, activation: str):
    hs = x @ p["shared_in"]
    hs = activate(x @ p["shared_gate"], activation) * hs
    return hs @ p["shared_out"]


def moe_ffn(p, x, m: MoESpec, activation: str = "silu"):
    """x: [T, d] (flattened tokens).  Returns (out [T, d], aux)."""
    T, d = x.shape
    w, ids, aux = route(p["router"], x, m)
    cap = capacity(T, m)
    tok, cw, val, slot_of = dispatch_indices(ids, w.to(x.dtype), m, cap)
    xe = torch.where(val[..., None], x[tok], 0)               # [E, C, d]
    h = torch.einsum("ecd,edf->ecf", xe, p["w_in"])
    g = torch.einsum("ecd,edf->ecf", xe, p["w_gate"])
    h = activate(g, activation) * h
    ye = torch.einsum("ecf,efd->ecd", h, p["w_out"])          # [E, C, d]
    ye = ye * torch.where(val, cw, 0)[..., None].to(ye.dtype)
    # each token gathers its k slots; slot E·C is the zero row
    ye_flat = torch.cat([ye.reshape(-1, d), ye.new_zeros(1, d)], dim=0)
    out = torch.sum(ye_flat[slot_of], dim=1)                  # [T, d]
    if m.n_shared:
        out = out + _shared(p, x, activation)
    return out, aux


def ref_dense_moe(p, x, m: MoESpec, activation: str = "silu"):
    """Oracle: every expert on every token, combined with the router
    weights.  O(T·E·d·f) — tests only."""
    w, ids, _ = route(p["router"], x, m)
    h = torch.einsum("td,edf->tef", x, p["w_in"])
    g = torch.einsum("td,edf->tef", x, p["w_gate"])
    y = torch.einsum("tef,efd->ted", activate(g, activation) * h,
                     p["w_out"])
    combine = torch.zeros(x.shape[0], m.n_experts, dtype=y.dtype,
                          device=x.device)
    combine = combine.scatter_add(1, ids, w.to(y.dtype))
    out = torch.einsum("te,ted->td", combine, y)
    if m.n_shared:
        out = out + _shared(p, x, activation)
    return out
