"""The port's recovery supervisor (``repro_torch.faults.supervisor``)
against the JAX package's, both driven by the same scripted fake step
(the guarded step's contract, as ``tests/test_faults.py`` drives the JAX
one): eviction and probation re-admission, quorum shrink and hold,
rollback to ``last_good`` with backoff and its budget, a corrupt
``last_good`` skipped for an older anchor, a torn save quarantined.
Each scenario must give the same ``events``, ``summary()``, returned
params and metrics in both packages; checkpoints are each package's own
(the same on-disk format).
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import ByzantineConfig as JByz
from repro.configs import RecoveryConfig as JRec
from repro.faults import Supervisor as JSupervisor
from repro.faults import SupervisorError as JSupervisorError
from repro.faults import feasible_round as j_feasible_round
from repro.faults import get_spec as j_get_spec
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import ByzantineConfig as TByz
from repro_torch.configs import RecoveryConfig as TRec
from repro_torch.faults import Supervisor as TSupervisor
from repro_torch.faults import SupervisorError as TSupervisorError
from repro_torch.faults import feasible_round as t_feasible_round
from repro_torch.faults import get_spec as t_get_spec

M = 8


class FakeStep:
    """The guarded step's contract: held when an active worker is
    faulted (worker_ok 0 for it), else params + 1."""

    def __init__(self):
        self.calls = 0

    def __call__(self, params, opt_state, batch, step, key, act, flt, ema):
        self.calls += 1
        act, flt = np.asarray(act), np.asarray(flt)
        bad = (flt > 0) & (act > 0)
        ok = not bad.any()
        met = {"loss": 1.0 if ok else float("nan"), "ce": 1.0,
               "gnorm": 1.0 if ok else float("nan"),
               "n_selected": act.sum(), "n_selected_min": act.sum(),
               "n_active": act.sum(),
               "worker_ok": 1.0 - bad.astype(np.float32),
               "step_ok": float(ok), "grad_finite": float(ok),
               "loss_spike": 0.0}
        return (params if not ok else params + 1), opt_state, met


def _tree(x):
    return {"w": np.full((4, 3), x, np.float32), "b": np.arange(3.0)}


PACKAGES = {
    "jax": (JSupervisor, JSupervisorError, JByz, JRec, jckpt, j_get_spec),
    "torch": (TSupervisor, TSupervisorError, TByz, TRec, tckpt, t_get_spec),
}


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.numpy()
    return np.asarray(tree)


def _same(a, b):
    a, b = _host(a), _host(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


def _evict_readmit(pkg, tmp):
    Sup, _, Byz, Rec, _, _ = pkg
    sup = Sup(FakeStep(), Byz(alpha=0.25, max_m=M, quorum=6),
              Rec(guard=True, evict_after=1, readmit_after=3), M)
    flt = np.zeros(M, np.float32)
    flt[5] = 1
    out, p = [], 0.0
    for step, f in ((0, flt), (1, flt), (2, None), (4, None), (5, flt)):
        p, _, met = sup.run_step(p, (), None, step, None, faults=f)
        out.append((p, met))
    return sup, out


def _quorum(pkg, tmp):
    Sup, _, Byz, Rec, _, _ = pkg
    sup = Sup(FakeStep(), Byz(alpha=0.5, max_m=M, quorum=7),
              Rec(guard=True), M)
    out, p = [], 0.0
    for step, n_on in ((0, 5), (1, 2), (2, 8), (3, 7)):
        act = np.zeros(M, np.float32)
        act[:n_on] = 1
        p, _, met = sup.run_step(p, (), None, step, None, sched_active=act)
        out.append((p, met))
    return sup, out


def _rollback(pkg, tmp):
    Sup, Err, Byz, Rec, ck, _ = pkg
    rcfg = Rec(guard=True, evict_after=99, rollback_after=2, max_rollbacks=2,
               backoff_base=2, keep_ckpts=4)
    sup = Sup(FakeStep(), Byz(alpha=0.25, max_m=M, quorum=6), rcfg, M,
              ckpt_dir=tmp, like=_tree(0))
    sup.checkpoint(_tree(7), 1)
    flt = np.zeros(M, np.float32)
    flt[3] = 1
    out, p = [], _tree(0)
    with pytest.raises(Err, match="budget"):
        for step in range(20):
            p, _, met = sup.run_step(p, (), None, step, None, faults=flt)
            out.append((p, met))
    return sup, out


def _corrupt_last_good(pkg, tmp):
    Sup, _, Byz, Rec, ck, get_spec = pkg
    sup = Sup(FakeStep(), Byz(alpha=0.25, max_m=M, quorum=6),
              Rec(guard=True, evict_after=99, rollback_after=1, keep_ckpts=4),
              M, ckpt_dir=tmp, like=_tree(0))
    sup.checkpoint(_tree(5), 1)
    sup.checkpoint(_tree(6), 2)
    get_spec("corrupt_ckpt").inject(tmp, 2, np.random.default_rng(0))
    flt = np.zeros(M, np.float32)
    flt[3] = 1
    p, _, met = sup.run_step(_tree(0), (), None, 0, None, faults=flt)
    return sup, [(p, met)]


def _torn_save(pkg, tmp):
    Sup, _, Byz, Rec, ck, get_spec = pkg
    sup = Sup(FakeStep(), Byz(alpha=0.25, max_m=M, quorum=6),
              Rec(guard=True), M, ckpt_dir=tmp, like=_tree(0))
    assert sup.checkpoint(_tree(1), 1)
    ck.save(tmp, _tree(2), step=2)
    get_spec("torn_ckpt").inject(tmp, 2, np.random.default_rng(0))
    try:
        ck.mark_good(tmp, 2, like=_tree(0))
    except Exception:
        pass
    return sup, [(ck.last_good_step(tmp), {})]


SCENARIOS = {"evict_readmit": _evict_readmit, "quorum": _quorum,
             "rollback": _rollback, "corrupt_last_good": _corrupt_last_good,
             "torn_save": _torn_save}


@pytest.mark.parametrize("name", SCENARIOS)
def test_supervisor_matches_jax(name, tmp_path):
    runs = {}
    for pkg_name, pkg in PACKAGES.items():
        d = tmp_path / pkg_name
        d.mkdir()
        runs[pkg_name] = SCENARIOS[name](pkg, str(d))
    (js, jout), (ts, tout) = runs["jax"], runs["torch"]
    assert ts.summary() == js.summary()
    assert ts.log == js.log
    np.testing.assert_array_equal(ts.evicted, js.evicted)
    assert len(tout) == len(jout)
    for (tp, tm), (jp, jm) in zip(tout, jout):
        _same(tp, jp)
        assert sorted(tm) == sorted(jm)
        for k in tm:
            if isinstance(jm[k], str):
                assert tm[k] == jm[k]
            else:
                np.testing.assert_array_equal(np.float64(tm[k]),
                                              np.float64(jm[k]))


def test_feasible_round_matches_jax():
    for n in range(0, 30):
        for alpha in (0.0, 0.1, 0.25, 1 / 3, 0.49, 0.5):
            assert t_feasible_round(n, alpha) == j_feasible_round(n, alpha)


def test_supervisor_requires_elastic():
    with pytest.raises(ValueError, match="elastic"):
        TSupervisor(FakeStep(), TByz(), TRec(), M)


def test_rollback_restores_onto_the_params_device(tmp_path):
    """A rollback returns tensors of the template's leaves on the device
    of the live params (the CPU here), with the checkpoint's values."""
    d = str(tmp_path)
    like = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    sup = TSupervisor(FakeStep(), TByz(alpha=0.25, max_m=M, quorum=6),
                      TRec(guard=True, evict_after=99, rollback_after=1), M,
                      ckpt_dir=d, like=like)
    assert sup.checkpoint({k: torch.from_numpy(v) for k, v in
                           _tree(4).items()}, 1)
    flt = np.zeros(M, np.float32)
    flt[0] = 1
    p, _, met = sup.run_step(like, (), None, 0, None, faults=flt)
    assert met["held"] == "nonfinite" and sup.rollbacks == 1
    assert all(torch.is_tensor(v) and v.device.type == "cpu"
               for v in p.values())
    _same(p, _tree(4))
