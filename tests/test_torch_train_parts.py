"""The parts of the port's train step that hold memory to G, and its
launcher (CPU, the plain versions):

* ``threat.apply_dense_``, the in-place attack, against the copying
  form the port had before it (transcribed here as
  ``_apply_dense_copying``) for every gradient attack, fixed and
  elastic, prefix and random membership: the same bits.  Gaussian noise
  is now drawn row by row into G; on the CPU that is the one-call draw's
  bits where d is a multiple of 16 (torch fills normals 16 at a time),
  which the bit test uses; at a ragged d the rows are held to the
  attack's distribution instead.  Knowledge rules over column blocks of
  a few columns give the whole-G bits too;
* ``engine.aggregate_local``'s elastic round over column blocks: one
  block (d at or below it) gives the bits of the whole-G round the port
  had before (transcribed here), several blocks the same selection and,
  within 1e-5 of the largest magnitude, the same aggregate (column rules
  exactly: they work per column); score partials whose float sum would
  round past 2^24 total exactly;
  ``inplace`` zeroes the inactive rows of G itself, else G is left as it
  was;
* ``build_train_step`` refuses what it cannot run (the global scope's
  a2a layout names ROADMAP A.4; the blocked scope, A.4's first half,
  builds and resolves "auto" to "a2a" as the reference does) and a fixed
  step refuses ``active``;
* ``launch.train.main`` on the CPU: fixed, ``--quorum`` / ``--straggle``
  and ``--supervise`` with ``--ckpt-dir`` (a checkpoint the port's
  ``ckpt.restore`` reads back, telemetry rows, history.json).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import (ByzantineConfig, RecoveryConfig,
                                 TrainConfig, get_config)
from repro_torch.core import engine, threat
from repro_torch.launch import train
from repro_torch.models import params as PM
from repro_torch.models import transformer as TF
from repro_torch.serving import telemetry
from repro_torch.training import build_train_step

GRADIENT_ATTACKS = [a for a in threat.registered()
                    if threat.get_spec(a).scope == "gradient"]
AGG_TOL = 1e-5


def _apply_dense_copying(G, generator, cfg, active=None):
    """The port's apply_dense before the in-place form: a zeroed copy of
    G, the corrupted rows written into it, then ``where``."""
    if not threat.is_gradient_attack(cfg):
        return G
    spec = threat.get_spec(cfg.attack)
    m = G.shape[0]
    if active is None:
        n_byz = threat.n_byzantine(cfg, m)
        if n_byz == 0:
            return G
        mask = threat.membership_mask(cfg, m, generator, device=G.device)
        n_honest = m - n_byz
    else:
        active = torch.as_tensor(active).to(G.device)
        na = (active > 0).sum()
        mask = threat.membership_mask(cfg, m, generator, active=active)
        n_honest = na - threat.n_byzantine(cfg, m, na)
    know = threat._dense_knowledge(G, mask, spec.knows, n_honest, active)
    if spec.shared_row:
        evil = spec.corrupt(G[0], know, generator, cfg)[None]
    else:
        evil = torch.zeros_like(G, dtype=torch.float32)
        evil[mask] = spec.corrupt(G[mask], know, generator, cfg)
    return torch.where(mask[:, None], evil.to(G.dtype), G)


def _G(m, d, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (m, d)).astype(np.float32))


ACTIVE = np.float32([1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0])


@pytest.mark.parametrize("attack", GRADIENT_ATTACKS)
@pytest.mark.parametrize("membership", ["prefix", "random"])
@pytest.mark.parametrize("elastic", [False, True])
def test_in_place_attack_equals_the_copying_one(attack, membership, elastic,
                                                monkeypatch):
    cfg = ByzantineConfig(attack=attack, alpha=0.25, membership=membership,
                          byz_seed=3)
    G = _G(12, 4096 + 16 * 7)                       # d % 16 == 0
    act = torch.from_numpy(ACTIVE) if elastic else None
    want = _apply_dense_copying(G, torch.Generator().manual_seed(5), cfg, act)
    got = G.clone()
    back = threat.apply_dense_(got, torch.Generator().manual_seed(5), cfg, act)
    assert back is got
    assert torch.equal(got, want)
    copy = threat.apply_dense(G, torch.Generator().manual_seed(5), cfg, act)
    assert torch.equal(copy, want) and copy is not G
    if threat.get_spec(attack).knows:
        monkeypatch.setattr(threat, "KNOWLEDGE_BLOCK", 96)
        small = G.clone()
        threat.apply_dense_(small, torch.Generator().manual_seed(5), cfg, act)
        assert torch.equal(small, want)


def test_gaussian_rows_at_a_ragged_width():
    """At d % 16 != 0 the row-by-row draws are other bits than one draw
    over all byzantine rows; they are still N(0, std²), the honest rows
    untouched, and the copying apply_dense equals the in-place one."""
    cfg = ByzantineConfig(attack="gaussian", alpha=0.25)
    G = _G(12, 30001)
    got = threat.apply_dense_(G.clone(), torch.Generator().manual_seed(1),
                              cfg)
    assert torch.equal(threat.apply_dense(G, torch.Generator().manual_seed(1),
                                          cfg), got)
    assert torch.equal(got[3:], G[3:])
    noise = got[:3].double() / cfg.gaussian_std
    assert abs(float(noise.mean())) < 0.02
    assert abs(float(noise.std()) - 1.0) < 0.02
    assert not torch.equal(got[0], got[1])


def test_no_attack_leaves_G_alone():
    G = _G(8, 100)
    for cfg in (ByzantineConfig(), ByzantineConfig(attack="scale"),
                ByzantineConfig(attack="label_flip", alpha=0.25),
                ByzantineConfig(attack="stall", alpha=0.25)):
        assert threat.apply_dense_(G, None, cfg) is G
        assert threat.apply_dense(G, None, cfg) is G


RULES = engine.registered()


def _aggregate_masked_whole(G, cfg, vf):
    """The port's elastic round before column blocks: masked statistics
    of the whole G, the select rule, then the combine on a zeroed copy."""
    spec = engine.get_spec(cfg.aggregator)
    m = G.shape[0]
    if spec.column is not None:
        return spec.column(G, cfg, m, valid=vf), vf > 0
    stats = dict(engine.leaf_stats(G, spec.stats, m, valid=vf))
    stats["valid"] = vf
    w, st, _ = engine.resolve_select(spec, stats, cfg, m, G.device)
    return (engine._combine_rows(torch.where(vf[:, None] > 0, G, 0.0), w),
            st.selected)


@pytest.mark.parametrize("rule", RULES)
def test_one_block_is_the_whole_G_round(rule, monkeypatch):
    cfg = ByzantineConfig(aggregator=rule, alpha=0.25)
    G = _G(12, 1000, seed=2)
    G[4, 7] = float("nan")                           # an inactive NaN
    vf = torch.from_numpy(np.float32([1] * 4 + [0] + [1] * 7))
    want, wsel = _aggregate_masked_whole(G, cfg, vf)
    for block in (engine.ELASTIC_BLOCK, 1000):       # d below, d at a block
        monkeypatch.setattr(engine, "ELASTIC_BLOCK", block)
        got, gst = engine.aggregate_local(G, cfg, return_state=True, valid=vf)
        assert torch.equal(got, want)
        assert torch.equal(gst.selected, wsel)
    assert torch.isnan(G[4, 7])                      # not in place


@pytest.mark.parametrize("rule", RULES)
def test_blocked_round_agrees_over_several_blocks(rule, monkeypatch):
    cfg = ByzantineConfig(aggregator=rule, alpha=0.25)
    G = _G(12, 5003, seed=4)
    G[:3] *= -3.0                                    # byzantine-looking rows
    vf = torch.from_numpy(ACTIVE)
    want, wst = engine.aggregate_local(G, cfg, return_state=True, valid=vf)
    monkeypatch.setattr(engine, "ELASTIC_BLOCK", 1024)
    got, gst = engine.aggregate_local(G, cfg, return_state=True, valid=vf)
    assert torch.equal(gst.selected, wst.selected)
    if engine.get_spec(rule).column is not None:
        assert torch.equal(got, want)
    else:
        err = float((got - want).abs().max())
        assert err <= AGG_TOL * float(want.abs().max()), err
    if hasattr(wst, "scores"):
        assert torch.equal(gst.scores, wst.scores)
        torch.testing.assert_close(gst.l1, wst.l1, rtol=AGG_TOL, atol=0)
        # score partials as large as a block of 2^22 columns gives: their
        # float sum would round past 2^24, the round's total is exact
        lift = float((1 << 22) - 1)
        real = engine.leaf_stats
        monkeypatch.setattr(engine, "leaf_stats", lambda *a, **k: {
            n: v + lift * vf if n == "scores" else v
            for n, v in real(*a, **k).items()})
        _, big = engine.aggregate_local(G, cfg, return_state=True, valid=vf)
        exact = (wst.scores.double() + 5 * lift * vf.double()).float()
        rounded = wst.scores.clone()
        for _b in range(5):
            rounded = rounded + lift * vf
        assert not torch.equal(rounded, exact)       # float32 sums round
        assert torch.equal(big.scores, exact)
    inplace = G.clone()
    got2 = engine.aggregate_local(inplace, cfg, valid=vf, inplace=True)
    assert torch.equal(got2, got)
    off = torch.from_numpy(ACTIVE == 0)
    assert torch.equal(inplace[off], torch.zeros_like(inplace[off]))
    assert torch.equal(inplace[~off], G[~off])


def _tcfg(**kw):
    return TrainConfig(model=get_config("qwen3-0.6b").reduced(), **kw)


@pytest.mark.parametrize("kw", [{"agg_scope": "blocked"},
                                {"agg_scope": "global", "agg_layout": "a2a"}])
def test_unported_strategies_name_their_slice(kw):
    if kw["agg_scope"] == "blocked":
        # ported: the first half of A.4
        b = build_train_step(_tcfg(**kw), 4, "cpu")
        assert (b.scope, b.layout) == ("blocked", "a2a")
        return
    with pytest.raises(ValueError, match="A.4"):
        build_train_step(_tcfg(**kw), 4, "cpu")


def test_step_validates_its_worker_set():
    with pytest.raises(ValueError, match="elastic"):
        build_train_step(_tcfg(recovery=RecoveryConfig(guard=True)), 4, "cpu")
    with pytest.raises(ValueError, match="max_m"):
        build_train_step(_tcfg(byzantine=ByzantineConfig(max_m=6)), 4, "cpu")
    with pytest.raises(ValueError, match="quorum"):
        build_train_step(_tcfg(byzantine=ByzantineConfig(quorum=6)), 4, "cpu")
    b = build_train_step(_tcfg(optimizer="sgd"), 4, "cpu")
    cfg = get_config("qwen3-0.6b").reduced()
    params = PM.init_params(TF.param_defs(cfg), torch.Generator())
    toks = np.zeros((4, 1, 8), np.int32)
    with pytest.raises(ValueError, match="non-elastic"):
        b.step_fn(params, (), {"tokens": toks}, 0, None, np.ones(4))


def test_train_main_fixed(capsys):
    hist = train.main(["--reduced", "--device", "cpu", "--workers", "4",
                       "--steps", "2", "--seq", "16", "--batch-per-worker",
                       "1", "--attack", "sign_flip", "--alpha", "0.25"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["n_active"] == 4 for h in hist)
    assert "scope=global" in capsys.readouterr().out


def test_train_main_quorum_and_straggle():
    hist = train.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                       "--workers", "5", "--steps", "2", "--seq", "16",
                       "--batch-per-worker", "1", "--quorum", "4",
                       "--straggle", "exp:0.5", "--aggregator", "median",
                       "--optimizer", "sgd"])
    assert all(h["n_active"] == 4 and h["n_selected"] == 4 for h in hist)


def test_train_main_supervised_with_checkpoints(tmp_path, capsys):
    d = str(tmp_path / "ck")
    hist = train.main(["--reduced", "--device", "cpu", "--workers", "4",
                       "--steps", "3", "--seq", "16", "--batch-per-worker",
                       "1", "--supervise", "--ckpt-dir", d,
                       "--ckpt-every", "2"])
    assert all(h["step_ok"] == 1.0 for h in hist)
    assert "supervisor: holds=0" in capsys.readouterr().out
    assert ckpt.steps(d) == [2, 3] and ckpt.last_good_step(d) == 3
    like = PM.init_params(TF.param_defs(get_config("qwen3-0.6b").reduced()),
                          torch.Generator())
    tree, step = ckpt.restore(d, like)
    assert step == 3 and sorted(tree) == sorted(like)
    assert [r["step"] for r in telemetry.read_rows(d)] == [0, 1, 2]
    saved = json.loads((tmp_path / "ck" / "history.json").read_text())
    assert [h["step"] for h in saved] == [0, 1, 2]


def test_train_main_refuses_unknown_names():
    with pytest.raises(SystemExit):
        train.main(["--reduced", "--device", "cpu", "--aggregator", "nope"])
    with pytest.raises(SystemExit):
        train.main(["--reduced", "--device", "cpu", "--straggle", "zipf"])
