"""The port's fault registry (``repro_torch.faults``, its own copy of the
JAX package's ``faults/spec.py``) against the JAX package's: the same
registry (names, scopes, ``permanent``), the same Trigger schedules and
ChaosPlan masks, edges, onsets and records for the same seeds, exactly;
and the ``ckpt`` faults on the port's checkpoints, which ``restore``
then refuses with one of the swapper's ``RESTORE_ERRORS``.
"""
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro_torch import faults
from repro_torch.checkpoint import ckpt
from repro_torch.serving import RESTORE_ERRORS

TRIGGERS = [dict(at=3, duration=2), dict(at=1, every=3),
            dict(at=4, prob=0.5), dict(prob=0.1, duration=3),
            dict(at=0, every=5, duration=2), dict(at=70)]


def test_registry_equals_the_jax_registry():
    assert faults.registered() == jfaults.registered()
    assert faults.SCOPES == jfaults.SCOPES
    for name in faults.registered():
        got, want = faults.get_spec(name), jfaults.get_spec(name)
        assert (got.scope, got.permanent, got.doc) == (want.scope,
                                                       want.permanent,
                                                       want.doc)
        assert got.inject.__name__ == want.inject.__name__
    with pytest.raises(KeyError, match="registered"):
        faults.get_spec("nope")
    with pytest.raises(ValueError, match="scope"):
        faults.FaultSpec("x", "disk", lambda: None)
    with pytest.raises(ValueError, match="permanent"):
        faults.FaultSpec("x", "grad", lambda: None, permanent=True)


@pytest.mark.parametrize("kw", TRIGGERS)
@pytest.mark.parametrize("seed", [0, 7])
def test_trigger_schedule_equals_jax(kw, seed):
    got = faults.Trigger(**kw).schedule(64, np.random.default_rng(seed))
    want = jfaults.Trigger(**kw).schedule(64, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    for bad in (dict(duration=0), dict(prob=1.5), dict(at=-1)):
        with pytest.raises(ValueError):
            faults.Trigger(**bad)


def _events(mod):
    return [
        mod.FaultEvent("host_crash", mod.Trigger(at=2), workers=(6,)),
        mod.FaultEvent("flap", mod.Trigger(at=3, duration=2), n=2),
        mod.FaultEvent("nan_burst", mod.Trigger(prob=0.2), n=3),
        mod.FaultEvent("torn_ckpt", mod.Trigger(at=4, every=5)),
        mod.FaultEvent("slot_stall", mod.Trigger(prob=0.15, duration=2)),
        mod.FaultEvent("stale_swap", mod.Trigger(at=9)),
    ]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_chaos_plan_equals_jax(seed):
    m, n = 8, 24
    got = faults.ChaosPlan(_events(faults), m=m, n_steps=n, seed=seed)
    want = jfaults.ChaosPlan(_events(jfaults), m=m, n_steps=n, seed=seed)
    assert ([ev.workers for ev in got.events]
            == [ev.workers for ev in want.events])
    for step in range(n):
        np.testing.assert_array_equal(got.worker_mask(step),
                                      want.worker_mask(step))
        np.testing.assert_array_equal(got.grad_faults(step),
                                      want.grad_faults(step))
        assert ([(ev.fault, spec.name) for ev, spec in got.fired(step)]
                == [(ev.fault, spec.name) for ev, spec in want.fired(step)])
    assert ([(ev.fault, at) for ev, at in got.onsets()]
            == [(ev.fault, at) for ev, at in want.onsets()])
    assert got.describe() == want.describe()


@pytest.mark.parametrize("fault", ["torn_ckpt", "corrupt_ckpt"])
def test_ckpt_faults_make_the_port_restore_raise(fault, tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(0)
    tree = {"seg_0": {"w": torch.from_numpy(
        rng.normal(size=(2, 16, 8)).astype("f4"))},
        "embed": torch.from_numpy(rng.normal(size=(32, 8)).astype("f4"))}
    ckpt.save(d, tree, step=1)
    ckpt.save(d, tree, step=2)
    detail = faults.get_spec(fault).inject(d, 2, np.random.default_rng(0))
    assert "step_00000002.npz" in detail
    assert ckpt.latest_step(d) == 2            # complete by the manifest
    with pytest.raises(RESTORE_ERRORS):
        ckpt.restore(d, like=tree, step=2)
    got, step = ckpt.restore(d, like=tree, step=1)
    assert step == 1 and torch.equal(got["embed"], tree["embed"])
