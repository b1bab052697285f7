"""Model assembly (the port of the JAX package's
``models/transformer.py``): config -> param defs -> forward, the
training loss, the decode cache, the fused prefill and the single-token
decode step.

Layers are grouped into homogeneous *segments* with stacked parameters
(``[L, ...]`` leaves, as in the JAX package, so weights carry across
leaf by leaf); where the JAX package scans a segment with ``lax.scan``,
the port loops over the stacked layer axis in Python.

  dense (qwen3, nemotron; minicpm3 with MLA attention) : [("dense", L)]
  deepseek-v2 (MLA)                                  : [("dense", 1), ("moe", 59)]
  dbrx                                               : [("moe", 40)]
  rwkv6                                              : [("rwkv", L)]
  zamba2                                             : [("hybrid", 9 units)]

A hybrid unit is ``hybrid_attn_every`` mamba2 blocks (stacked
``[units, sub, ...]`` under ``seg_0``) followed by the one SHARED dense
block, whose parameters sit under the top-level ``shared_attn`` key
(after ``seg_0`` in sorted key order, as in the reference's flattened
gradient) and are applied after every unit: their gradient sums over
the units.  A dense or moe layer's attention is
GQA or MLA by ``cfg.attention.kind``; MLA's decode cache holds the
latent ``c`` [B,T,R] and the rope key ``kr`` [B,T,Dr] where GQA's
holds ``k`` / ``v``.  A moe layer's FFN is ``moe.moe_ffn`` over the
layer's flattened tokens (B·S in the forward and the prefill, B in a
decode step: its capacity follows that count), and the layers' router
losses sum into the ``aux`` that ``loss_fn`` adds to the cross-entropy.

The decode cache is a nested dict of tensors.  ``prefill_cache`` and
``decode_step`` write every entry IN PLACE where the JAX package returns
new buffers, and return the same dict: the buffers never move, so a CUDA
graph of the decode step (``serving/scheduler.py``) reads and writes
the same addresses on every replay.  The rwkv token-shift carries
(``tm_x``, ``cm_x``) are float32 buffers whatever the cache dtype: the
JAX decode scan returns them in their computed dtype (float32), so they
can be written in place without a rounding, and the prefill rounds them
through the cache dtype first, as the JAX prefill stores them.  The
mamba2 convolution state (``conv``) is such a carry too: the reference's
decode concatenates the cached state with the float32 input, so its
decode cache holds it in float32 whatever the cache dtype.

The vision / audio frontends are stubs, as in the reference: a caller
passes precomputed prefix embeddings [B, P, D] (``prefix_embed``), cast
to the embedding's dtype and put before the token embeddings; the loss
reads the logits from position P on (the prefix is context only).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import layers as L
from . import mamba2 as M2
from . import moe as MOE
from . import rwkv6 as R6
from .params import ParamDef, tree_map_defs


class Segment(NamedTuple):
    kind: str      # dense | moe | rwkv | hybrid
    n: int         # number of stacked layers (units for hybrid)


def segments(cfg: ModelConfig):
    if cfg.arch_type == "ssm" and cfg.rwkv is not None:
        return [Segment("rwkv", cfg.n_layers)]
    if cfg.hybrid_attn_every:
        if cfg.n_layers % cfg.hybrid_attn_every:
            raise ValueError(
                f"{cfg.name}: n_layers={cfg.n_layers} is not a multiple of "
                f"hybrid_attn_every={cfg.hybrid_attn_every}")
        return [Segment("hybrid", cfg.n_layers // cfg.hybrid_attn_every)]
    if cfg.is_moe:
        segs = []
        if cfg.n_dense_layers:
            segs.append(Segment("dense", cfg.n_dense_layers))
        segs.append(Segment("moe", cfg.n_layers - cfg.n_dense_layers))
        return segs
    return [Segment("dense", cfg.n_layers)]


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig):
    a = cfg.attention
    return (L.mla_defs(cfg.d_model, a) if a.kind == "mla"
            else L.gqa_defs(cfg.d_model, a))


def _block_defs(cfg: ModelConfig, kind: str) -> dict:
    D = cfg.d_model
    norm = lambda: ParamDef((D,), (None,), init="ones")  # noqa: E731
    if kind == "dense":
        gated = cfg.activation != "relu2"
        return {"ln1": norm(), "attn": _attn_defs(cfg),
                "ln2": norm(), "mlp": L.mlp_defs(D, cfg.d_ff, gated)}
    if kind == "moe":
        return {"ln1": norm(), "attn": _attn_defs(cfg), "ln2": norm(),
                "moe": MOE.moe_defs(D, cfg.moe)}
    if kind == "rwkv":
        return {"ln1": norm(), "tm": R6.rwkv6_defs(D, cfg.d_ff, cfg.rwkv),
                "ln2": norm()}
    if kind == "mamba":
        return {"ln": norm(), "m": M2.mamba2_defs(D, cfg.ssm)}
    raise ValueError(kind)


def _stack(defs, n: int, axis_name="layers"):
    return tree_map_defs(
        lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.init,
                           d.scale), defs)


def param_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    defs: dict = {
        "embed": ParamDef((cfg.vocab, D), ("vocab", "embed"), init="normal"),
        "final_norm": ParamDef((D,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, cfg.vocab), ("embed", "vocab"))
    for i, seg in enumerate(segments(cfg)):
        if seg.kind == "hybrid":
            unit = _stack(_block_defs(cfg, "mamba"), cfg.hybrid_attn_every,
                          "sub")
            defs[f"seg_{i}"] = _stack(unit, seg.n, "units")
            defs["shared_attn"] = _block_defs(cfg, "dense")
        else:
            defs[f"seg_{i}"] = _stack(_block_defs(cfg, seg.kind), seg.n)
    return defs


def _layers(p_stack, n: int) -> list:
    """Every layer's parameters, views of the stack by one ``unbind`` per
    leaf: in a backward the layers' gradients are stacked once, where
    ``n`` indexings would each add a zero-filled copy of the whole
    stack."""
    if isinstance(p_stack, dict):
        per = {k: _layers(v, n) for k, v in p_stack.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(torch.unbind(p_stack))


def _stack_entries(ents: list):
    """Per-layer dicts of tensors -> one dict of [L, ...] stacks."""
    if isinstance(ents[0], dict):
        return {k: _stack_entries([e[k] for e in ents]) for k in ents[0]}
    return torch.stack(ents)


# ---------------------------------------------------------------------------
# block bodies (full-sequence form)
# ---------------------------------------------------------------------------

def _attention(cfg, p, x, positions):
    if cfg.attention.kind == "mla":
        return L.mla_attention(p, cfg.attention, x, positions)
    return L.gqa_attention(p, cfg.attention, x, positions)


def _kv_entry(cfg, kv):
    """Full-sequence attention cache pieces, keyed like
    ``_attn_cache_defs``."""
    if cfg.attention.kind == "mla":
        return {"c": kv[0], "kr": kv[1]}
    return {"k": kv[0], "v": kv[1]}


def _dense_block(cfg, p, x, positions):
    h, kv = _attention(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.rms_eps),
                       positions)
    x = x + h
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.rms_eps),
                  cfg.activation)
    return x, None, _kv_entry(cfg, kv)


def _moe_block(cfg, p, x, positions):
    h, kv = _attention(cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.rms_eps),
                       positions)
    x = x + h
    B, S, D = x.shape
    flat = L.rms_norm(x, p["ln2"], cfg.rms_eps).reshape(B * S, D)
    out, aux = MOE.moe_ffn(p["moe"], flat, cfg.moe, cfg.activation)
    return x + out.reshape(B, S, D), aux, _kv_entry(cfg, kv)


def _rwkv_block(cfg, p, x):
    h, (tm_x, wkv) = R6.rwkv6_timemix(p["tm"], cfg.rwkv,
                                      L.rms_norm(x, p["ln1"], cfg.rms_eps))
    x = x + h
    h, cm_x = R6.rwkv6_channelmix(p["tm"],
                                  L.rms_norm(x, p["ln2"], cfg.rms_eps))
    return x + h, None, {"wkv": wkv, "tm_x": tm_x, "cm_x": cm_x}


def _mamba_block(cfg, p, x):
    h, (conv, ssm) = M2.mamba2_forward(p["m"], cfg.ssm,
                                       L.rms_norm(x, p["ln"], cfg.rms_eps))
    return x + h, {"conv": conv, "ssm": ssm}


def _hybrid_unit(cfg, p_u, shared, x, positions, collect):
    """One hybrid unit: its ``hybrid_attn_every`` mamba2 blocks, then the
    shared dense block.  Cache entries (with ``collect``): the mamba
    states stacked on a leading sub axis, and the shared block's K/V."""
    ents = []
    for p_m in _layers(p_u, cfg.hybrid_attn_every):
        x, ent = _mamba_block(cfg, p_m, x)
        if collect:
            ents.append(ent)
    x, _, a_ent = _dense_block(cfg, shared, x, positions)
    return x, None, ({"mamba": _stack_entries(ents), "attn": a_ent}
                     if collect else None)


def _block(cfg, kind: str, p_l, x, positions, shared=None, collect=True):
    """(x, aux or None, cache entries) of one layer (of one unit for
    hybrid, with the shared block's parameters ``shared``): aux is the
    moe layer's router loss, None for the other kinds."""
    if kind == "dense":
        return _dense_block(cfg, p_l, x, positions)
    if kind == "moe":
        return _moe_block(cfg, p_l, x, positions)
    if kind == "rwkv":
        return _rwkv_block(cfg, p_l, x)
    if kind == "hybrid":
        return _hybrid_unit(cfg, p_l, shared, x, positions, collect)
    raise ValueError(kind)


def _train_block(cfg, kind: str, p_l, x, positions, shared, remat):
    """(x, aux or None) of one layer (unit) in training: with ``remat``
    only its input is kept for the backward, which runs it again
    (``torch.utils.checkpoint``, non-reentrant: the JAX package's
    ``jax.checkpoint`` of the scan body).  ``p_l`` comes in already
    hooked, so a recompute never runs a hook again."""
    if remat:
        return checkpoint(
            lambda x: _block(cfg, kind, p_l, x, positions, shared,
                             False)[:2], x, use_reentrant=False)
    return _block(cfg, kind, p_l, x, positions, shared, False)[:2]


def _run_segment(cfg, seg: Segment, p_stack, x, positions,
                 collect_cache=False, remat=False, shared=None,
                 param_hook=None):
    """Run a stacked segment over x, layer by layer (unit by unit for
    hybrid, ``shared`` the shared block's parameters).  Returns (x, the
    sum of the layers' aux losses (None but for moe), cache entries):
    with ``collect_cache`` (the fused prefill) each layer's
    full-sequence cache pieces stacked on a leading layer axis, in the
    ``cache_defs`` layout; else None.  ``remat`` (training) keeps only
    each layer's (unit's) input for the backward (:func:`_train_block`).
    ``param_hook(p_layer, layer_idx)`` is applied to each layer slice
    (unit slice for hybrid) before the layer runs, outside the
    checkpoint: the blocked scope's barrier."""
    ents, aux = [], None
    for idx, p_l in enumerate(_layers(p_stack, seg.n)):
        if param_hook is not None:
            p_l = param_hook(p_l, idx)
        if remat:
            x, a = _train_block(cfg, seg.kind, p_l, x, positions, shared,
                                True)
        else:
            x, a, ent = _block(cfg, seg.kind, p_l, x, positions, shared,
                               collect_cache)
            if collect_cache:
                ents.append(ent)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux, (_stack_entries(ents) if collect_cache else None)


# ---------------------------------------------------------------------------
# public forward
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params, tokens, prefix_embed=None):
    """Token embeddings [B,S,D], after the prefix embeddings [B,P,D]
    (cast to the embedding's dtype) when given."""
    x = params["embed"][tokens]
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
    return x


def _head(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _top(params) -> dict:
    """The top-level bucket: every key not under ``seg_`` (embed,
    final_norm, lm_head, shared_attn)."""
    return {k: v for k, v in params.items() if not k.startswith("seg_")}


def forward(cfg: ModelConfig, params, tokens, prefix_embed=None,
            remat: bool = False, seg_hooks=None, top_hook=None):
    """tokens [B,S_tok] (+ optional prefix [B,P,D]) -> (logits
    [B,P+S_tok,V], aux): aux the float32 sum of the moe layers' router
    losses (0 without moe layers).  ``remat``: recompute each layer in
    the backward instead of keeping its activations.

    Blocked-aggregation hooks, as in the reference:
    ``seg_hooks["seg_i"](p_layer, layer_idx)`` is applied to each layer
    slice of segment i (each unit slice of a hybrid segment), and
    ``top_hook`` once to the top-level bucket (:func:`_top`)."""
    if top_hook is not None:
        params = {**params, **top_hook(_top(params))}
    x = embed_inputs(cfg, params, tokens, prefix_embed)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, seg in enumerate(segments(cfg)):
        x, a, _ = _run_segment(cfg, seg, params[f"seg_{i}"], x, positions,
                               remat=remat, shared=params.get("shared_attn"),
                               param_hook=(seg_hooks or {}).get(f"seg_{i}"))
        if a is not None:
            aux = aux + a
    return _head(cfg, params, x), aux


def _ce_loss(logits, batch, aux):
    """The loss tail of one worker: next-token cross-entropy of
    ``logits`` against ``batch`` plus ``aux`` (:func:`loss_fn`)."""
    tokens = batch["tokens"]
    pfx = logits.shape[1] - tokens.shape[1]
    pred = logits[:, pfx:-1]
    tgt = tokens[:, 1:].long()
    logp = torch.log_softmax(pred.float(), dim=-1)
    ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].to(ll.dtype)
        ce = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        ce = -torch.mean(ll)
    return ce + aux, {"ce": ce, "aux": aux}


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = False,
            seg_hooks=None, top_hook=None):
    """Next-token cross-entropy of one worker's batch (``{"tokens":
    [B,S]}``, optionally ``"prefix_embed"`` [B,P,D] and ``"loss_mask"``
    [B,S]): the logits at position P+t predict token t+1 (the prefix is
    context only), the log-softmax in float32.  Returns (ce + aux,
    {"ce", "aux"}); aux is the moe layers' router loss (0 for the other
    families).  ``seg_hooks`` / ``top_hook`` as in :func:`forward`."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("prefix_embed"), remat, seg_hooks,
                          top_hook)
    return _ce_loss(logits, batch, aux)


def loss_fn_workers(cfg: ModelConfig, params, batches, remat: bool = False,
                    seg_hooks=None, top_hook=None):
    """:func:`loss_fn` of several workers at once, run LAYER-MAJOR: every
    worker passes layer l before any worker enters layer l+1.  Torch's
    autograd engine runs the ready node of the highest sequence number
    first, so the backward of this graph takes the layers in lockstep
    across the workers, top layer first; a worker-major graph would run
    one worker's whole backward before the next's.

    ``batches``: one batch dict per worker.  The hooks hand each worker
    its own view of a bucket: ``seg_hooks["seg_i"](p_layer, layer_idx)``
    returns one layer slice (unit slice for hybrid) per worker, and
    ``top_hook(sub)`` one dict per worker for ``sub``, the part of the
    top-level bucket a use site reads: ``embed`` at the embedding
    lookup, ``shared_attn`` at each hybrid unit, ``final_norm`` and the
    head's matrix at the head.  Without hooks every worker reads the
    parameters themselves.  Returns (losses, metric dicts), one each a
    worker."""
    n = len(batches)
    same = lambda p: [p] * n  # noqa: E731
    top = top_hook or same
    emb = top({"embed": params["embed"]})
    xs = [embed_inputs(cfg, emb[w], b["tokens"], b.get("prefix_embed"))
          for w, b in enumerate(batches)]
    positions = torch.arange(xs[0].shape[1], device=xs[0].device)
    auxs = [torch.zeros((), dtype=torch.float32, device=xs[0].device)
            for _ in range(n)]
    for i, seg in enumerate(segments(cfg)):
        hook = (seg_hooks or {}).get(f"seg_{i}")
        for idx, p_l in enumerate(_layers(params[f"seg_{i}"], seg.n)):
            views = same(p_l) if hook is None else hook(p_l, idx)
            shared = (top({"shared_attn": params["shared_attn"]})
                      if seg.kind == "hybrid" else same({}))
            for w in range(n):
                xs[w], a = _train_block(cfg, seg.kind, views[w], xs[w],
                                        positions,
                                        shared[w].get("shared_attn"), remat)
                if a is not None:
                    auxs[w] = auxs[w] + a
    head = top({k: params[k] for k in
                ("final_norm", "embed" if cfg.tie_embeddings else "lm_head")})
    out = [_ce_loss(_head(cfg, head[w], xs[w]), b, auxs[w])
           for w, b in enumerate(batches)]
    return [o[0] for o in out], [o[1] for o in out]


# ---------------------------------------------------------------------------
# decode path (single new token against the cache / state)
# ---------------------------------------------------------------------------

def _attn_cache_defs(cfg: ModelConfig, batch: int, seq_len: int):
    a = cfg.attention
    T = min(a.window, seq_len) if a.window else seq_len
    if a.kind == "mla":
        return {"c": ((batch, T, a.kv_lora_rank), ("batch", "seq", None)),
                "kr": ((batch, T, a.qk_rope_dim), ("batch", "seq", None))}
    return {"k": ((batch, T, a.n_kv_heads, a.head_dim),
                  ("batch", "seq", "kv", "hd")),
            "v": ((batch, T, a.n_kv_heads, a.head_dim),
                  ("batch", "seq", "kv", "hd"))}


def _mamba_cache_defs(cfg: ModelConfig, batch: int):
    di, H = M2.dims(cfg.d_model, cfg.ssm)
    N, W = cfg.ssm.state_dim, cfg.ssm.conv_width
    Pd = di // H
    return {"conv": ((batch, W - 1, di + 2 * N), ("batch", None, "inner")),
            "ssm": ((batch, H, N, Pd), ("batch", "heads", None, None))}


def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Shapes + logical axes of the decode cache, mirroring the param
    stacking."""
    out: dict = {}
    for i, seg in enumerate(segments(cfg)):
        if seg.kind in ("dense", "moe"):
            out[f"seg_{i}"] = {
                k: ((seg.n,) + s, ("layers",) + ax)
                for k, (s, ax) in _attn_cache_defs(cfg, batch,
                                                   seq_len).items()}
        elif seg.kind == "rwkv":
            D = cfg.d_model
            H, K = D // cfg.rwkv.head_dim, cfg.rwkv.head_dim
            out[f"seg_{i}"] = {
                "wkv": ((seg.n, batch, H, K, K),
                        ("layers", "batch", "heads", None, None)),
                "tm_x": ((seg.n, batch, 1, D),
                         ("layers", "batch", None, None)),
                "cm_x": ((seg.n, batch, 1, D),
                         ("layers", "batch", None, None)),
            }
        elif seg.kind == "hybrid":
            sub = {k: ((seg.n, cfg.hybrid_attn_every) + s,
                       ("units", "sub") + ax)
                   for k, (s, ax) in _mamba_cache_defs(cfg, batch).items()}
            attn = {k: ((seg.n,) + s, ("units",) + ax)
                    for k, (s, ax) in _attn_cache_defs(cfg, batch,
                                                       seq_len).items()}
            out[f"seg_{i}"] = {"mamba": sub, "attn": attn}
    return out


# carries the reference's decode returns in float32 whatever the cache
# dtype: rwkv's token shifts and mamba2's convolution state
_CARRIES = ("tm_x", "cm_x", "conv")


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    def zeros(defs, name=None):
        if isinstance(defs, dict):
            return {k: zeros(v, k) for k, v in defs.items()}
        dt = torch.float32 if name in _CARRIES else dtype
        return torch.zeros(defs[0], dtype=dt, device=device)
    return zeros(cache_defs(cfg, batch, seq_len))


def _attn_decode(cfg, p, x, cache, pos):
    """One layer's decode attention; writes ``cache`` (its K/V, or MLA's
    latent and rope key) in place."""
    a = cfg.attention
    if a.kind == "mla":
        return L.mla_decode(p, a, x, cache["c"], cache["kr"], pos)[0]
    return L.gqa_decode(p, a, x, cache["k"], cache["v"], pos)[0]


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """token [B,1] int64; pos a scalar absolute position or a per-slot
    ``[B]`` device vector (the recurrent families ignore it; a device
    vector is used as it is, with no host copy).  Returns (logits
    [B,1,V], cache) — every entry written in place: the attention K/V
    (MLA: the latent and the rope key), the rwkv and mamba2 states cast
    to the cache's dtype and the float32 carries (rwkv's token shifts,
    mamba2's convolution state), as the JAX scan returns them."""
    x = embed_inputs(cfg, params, token)
    pos = L._decode_pos(pos, x.shape[0], x.device)
    for i, seg in enumerate(segments(cfg)):
        p_stack, c_stack = params[f"seg_{i}"], cache[f"seg_{i}"]
        if seg.kind in ("dense", "moe"):
            for p_l, c_l in zip(_layers(p_stack, seg.n),
                                _layers(c_stack, seg.n)):
                h = _attn_decode(cfg, p_l["attn"],
                                 L.rms_norm(x, p_l["ln1"], cfg.rms_eps),
                                 c_l, pos)
                x = x + h
                hin = L.rms_norm(x, p_l["ln2"], cfg.rms_eps)
                if seg.kind == "moe":
                    B = x.shape[0]
                    out, _ = MOE.moe_ffn(p_l["moe"], hin.reshape(B, -1),
                                         cfg.moe, cfg.activation)
                    x = x + out.reshape(B, 1, -1)
                else:
                    x = x + L.mlp(p_l["mlp"], hin, cfg.activation)
        elif seg.kind == "rwkv":
            for p_l, c_l in zip(_layers(p_stack, seg.n),
                                _layers(c_stack, seg.n)):
                h, (tm_x, wkv) = R6.rwkv6_timemix(
                    p_l["tm"], cfg.rwkv,
                    L.rms_norm(x, p_l["ln1"], cfg.rms_eps),
                    last_x=c_l["tm_x"], state=c_l["wkv"].float())
                x = x + h
                h, cm_x = R6.rwkv6_channelmix(
                    p_l["tm"], L.rms_norm(x, p_l["ln2"], cfg.rms_eps),
                    last_x=c_l["cm_x"])
                x = x + h
                c_l["wkv"].copy_(wkv)
                c_l["tm_x"].copy_(tm_x)
                c_l["cm_x"].copy_(cm_x)
        elif seg.kind == "hybrid":
            shared = params["shared_attn"]
            for p_u, c_u in zip(_layers(p_stack, seg.n),
                                _layers(c_stack, seg.n)):
                for p_m, c_m in zip(
                        _layers(p_u, cfg.hybrid_attn_every),
                        _layers(c_u["mamba"], cfg.hybrid_attn_every)):
                    h, (conv, ssm) = M2.mamba2_decode(
                        p_m["m"], cfg.ssm,
                        L.rms_norm(x, p_m["ln"], cfg.rms_eps),
                        c_m["conv"], c_m["ssm"].float())
                    x = x + h
                    c_m["conv"].copy_(conv)
                    c_m["ssm"].copy_(ssm)
                h = _attn_decode(cfg, shared["attn"],
                                 L.rms_norm(x, shared["ln1"], cfg.rms_eps),
                                 c_u["attn"], pos)
                x = x + h
                x = x + L.mlp(shared["mlp"],
                              L.rms_norm(x, shared["ln2"], cfg.rms_eps),
                              cfg.activation)
        else:
            raise ValueError(seg.kind)
    return _head(cfg, params, x), cache


# ---------------------------------------------------------------------------
# fused prefill: one forward writes the whole prompt into the cache
# ---------------------------------------------------------------------------

def _seq_write(buf, ent, window: int):
    """Write full-sequence attention entries into a decode cache buffer
    in place.  buf: [L, B, T, ...]; ent: [L, B, S, ...].  Non-windowed
    buffers take positions 0..S-1; windowed ring buffers keep the last
    min(S, T) positions at slot = pos % T, where ``gqa_decode`` would
    have left them after S sequential steps."""
    T, S = buf.shape[2], ent.shape[2]
    if not window and S > T:
        raise ValueError(f"prompt length {S} exceeds cache length {T}")
    keep = min(S, T)
    slots = torch.arange(S - keep, S, device=buf.device) % T
    buf[:, :, slots] = ent[:, :, S - keep:].to(buf.dtype)
    return buf


def _write_entries(cfg, seg: Segment, bufs, ent):
    if seg.kind in ("dense", "moe"):
        return {k: _seq_write(bufs[k], ent[k], cfg.attention.window)
                for k in bufs}
    if seg.kind == "rwkv":
        dtype = bufs["wkv"].dtype            # the cache dtype
        for k in bufs:
            bufs[k].copy_(ent[k].to(dtype))
        return bufs
    if seg.kind == "hybrid":
        dtype = bufs["mamba"]["ssm"].dtype   # the cache dtype
        for k, b in bufs["mamba"].items():
            b.copy_(ent["mamba"][k].to(dtype))
        for k, b in bufs["attn"].items():
            _seq_write(b, ent["attn"][k], cfg.attention.window)
        return bufs
    raise ValueError(seg.kind)


def prefill_cache(cfg: ModelConfig, params, tokens, cache,
                  prefix_embed=None):
    """Fused prefill: one forward over the prompt (after the prefix
    embeddings [B,P,D], when given) computes the full-sequence logits
    AND writes the whole prompt's K/V (or the final rwkv / mamba2
    states) into the decode cache.

    tokens: [B,S] with B matching the cache batch.  Returns (logits
    [B,P+S,V], cache) positioned so ``decode_step`` continues at
    pos = P + S.
    """
    x = embed_inputs(cfg, params, tokens, prefix_embed)
    positions = torch.arange(x.shape[1], device=x.device)
    for i, seg in enumerate(segments(cfg)):
        x, _, ent = _run_segment(cfg, seg, params[f"seg_{i}"], x,
                                 positions, collect_cache=True,
                                 shared=params.get("shared_attn"))
        cache[f"seg_{i}"] = _write_entries(cfg, seg, cache[f"seg_{i}"], ent)
    return _head(cfg, params, x), cache
