"""The port's optimizers and train configs against the JAX package:

* ``sgd``, ``momentum``, ``adamw`` and ``clip_by_global_norm`` (in
  place) of
  ``repro_torch.optim`` against ``repro.optim`` on the same numpy
  parameters and aggregates, over three steps, with and without
  clipping and weight decay: within 1e-6 of each leaf's largest
  magnitude (XLA sums the global norm in another order and may contract
  ``p - lr·g`` into a fused multiply-add; ``b1 ** t`` is another pow);
* the port's in-place update equals the reference's out-of-place
  formulas, transcribed in torch, bit for bit, and returns the tensors
  it was given;
* ``RecoveryConfig`` and ``TrainConfig`` have the JAX dataclasses'
  fields and defaults, field by field, and ``RecoveryConfig`` refuses
  what the JAX one refuses.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.optim import optimizers as joptim
from repro_torch import optim as toptim
from repro_torch.configs import base as tbase

SHAPES = [(7, 5), (33,), (3, 4, 6)]
TOL = 1e-6


def _leaves(rng, scale=1.0):
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in SHAPES]


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err


CASES = {
    "sgd": dict(optimizer="sgd", lr=0.1, grad_clip=0.0),
    "sgd_clip": dict(optimizer="sgd", lr=0.1, grad_clip=1.0),
    "momentum": dict(optimizer="momentum", lr=0.05, momentum=0.9,
                     grad_clip=0.0),
    "momentum_clip": dict(optimizer="momentum", lr=0.05, grad_clip=2.0),
    "adamw": dict(optimizer="adamw", lr=3e-3, weight_decay=0.0,
                  grad_clip=0.0),
    "adamw_wd_clip": dict(optimizer="adamw", lr=3e-3, weight_decay=0.01,
                          grad_clip=1.0),
}


@pytest.mark.parametrize("case", CASES)
def test_update_matches_jax(case):
    kw = CASES[case]
    jopt = joptim.get_optimizer(jbase.TrainConfig(model=None, **kw))
    topt = toptim.get_optimizer(tbase.TrainConfig(model=None, **kw))
    rng = np.random.default_rng(3)
    p0 = _leaves(rng)
    jp = {f"l{i}": jnp.asarray(p) for i, p in enumerate(p0)}
    tp = [torch.from_numpy(p.copy()) for p in p0]
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _leaves(rng, scale=3.0 if "clip" in case else 0.5)
        jp, js = jopt.update({f"l{i}": jnp.asarray(x) for i, x in
                              enumerate(g)}, js, jp, jnp.int32(step))
        given = tp
        tp, ts = topt.update([torch.from_numpy(x.copy()) for x in g], ts,
                             tp, step)
        assert all(a is b for a, b in zip(tp, given))      # in place
        for i, t in enumerate(tp):
            _close(t.numpy(), jp[f"l{i}"])
        if kw["optimizer"] == "momentum":
            for i, t in enumerate(ts):
                _close(t.numpy(), js[f"l{i}"])
        if kw["optimizer"] == "adamw":
            for k in ("m", "v"):
                for i, t in enumerate(ts[k]):
                    _close(t.numpy(), js[k][f"l{i}"])


def _out_of_place(kw, grads, state, params, step):
    """The reference's update (``repro/optim/optimizers.py``) in torch,
    out of place, operation by operation."""
    clip = kw["grad_clip"]
    if clip > 0:
        n = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        # the reference's scale: min(1, max_norm / max(n, 1e-9))
        scale = torch.clamp(clip / torch.clamp(n, min=1e-9), max=1.0)
        grads = [g * scale for g in grads]
    lr = kw["lr"]
    if kw["optimizer"] == "sgd":
        return [p - lr * g for p, g in zip(params, grads)], state
    if kw["optimizer"] == "momentum":
        beta = kw.get("momentum", 0.9)
        new_m = [beta * v + g for v, g in zip(state, grads)]
        return [p - lr * v for p, v in zip(params, new_m)], new_m
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, kw["weight_decay"]
    t = torch.tensor(float(step), dtype=torch.float32) + 1.0
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)
    ps, ms, vs = [], [], []
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        ps.append(p - lr * (u + wd * p))
        ms.append(m)
        vs.append(v)
    return ps, {"m": ms, "v": vs}


@pytest.mark.parametrize("case", CASES)
def test_in_place_update_equals_out_of_place(case):
    kw = CASES[case]
    topt = toptim.get_optimizer(tbase.TrainConfig(model=None, **kw))
    rng = np.random.default_rng(5)
    p0 = _leaves(rng)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    ts = topt.init(tp)
    op, os_ = [torch.from_numpy(p.copy()) for p in p0], topt.init(tp)
    for step in range(3):
        g = _leaves(rng, scale=3.0 if "clip" in case else 0.5)
        tp, ts = topt.update([torch.from_numpy(x.copy()) for x in g], ts, tp,
                             step)
        op, os_ = _out_of_place(kw, [torch.from_numpy(x) for x in g], os_,
                                op, step)
        for a, b in zip(tp, op):
            assert torch.equal(a, b), case


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(9)
    g = _leaves(rng, scale=2.0)
    for max_norm in (0.0, -1.0, 0.5, 1e3):
        want = joptim.clip_by_global_norm(
            {f"l{i}": jnp.asarray(x) for i, x in enumerate(g)}, max_norm)
        given = [torch.from_numpy(x.copy()) for x in g]
        got = toptim.clip_by_global_norm(given, max_norm)
        assert got is given                          # scaled in place
        for i, t in enumerate(got):
            _close(t.numpy(), want[f"l{i}"])
        if max_norm <= 0:                            # a no-op
            for a, b in zip(got, g):
                assert np.array_equal(a.numpy(), b)


def test_get_optimizer_refuses_unknown():
    with pytest.raises(ValueError):
        toptim.get_optimizer(tbase.TrainConfig(model=None, optimizer="lamb"))


@pytest.mark.parametrize("name", ["RecoveryConfig", "TrainConfig"])
def test_train_configs_have_the_jax_fields(name):
    def fields(cls):
        out = []
        for f in dataclasses.fields(cls):
            d = f.default
            if f.default_factory is not dataclasses.MISSING:
                d = dataclasses.asdict(f.default_factory())
            out.append((f.name, d))
        return out
    assert fields(getattr(tbase, name)) == fields(getattr(jbase, name))


@pytest.mark.parametrize("kw", [
    {"spike_mult": 1.0}, {"ema_decay": 0.0}, {"ema_decay": 1.0},
    {"evict_after": 0}, {"readmit_after": 0}, {"rollback_after": 0},
    {"backoff_base": 0}, {"keep_ckpts": 0}, {"max_rollbacks": -1}])
def test_recovery_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as je:
        jbase.RecoveryConfig(**kw)
    with pytest.raises(ValueError) as te:
        tbase.RecoveryConfig(**kw)
    assert str(te.value) == str(je.value)
