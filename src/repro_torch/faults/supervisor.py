"""Self-healing supervisor of the elastic train loop.

Port of the JAX package's ``faults/supervisor.py`` over the port's
``checkpoint/ckpt.py``.  Detection is in the guarded train step
(``training/step.py`` with ``recovery.guard``): a non-finite gnorm/loss
or a loss spike against the supervisor's EMA holds the update, and a
per-worker finiteness vector rides out as the ``worker_ok`` metric.
Everything here is host-side policy over those signals:

* quorum collapse — ``n_active < quorum`` after faults/evictions: run
  the round anyway iff the shrunk set still holds the honest-majority
  bound ``n_active > 2·floor(alpha·n_active)``, else hold the step
  entirely;
* eviction / re-admission — workers with ``worker_ok == 0`` on a held
  step collect strikes and are evicted from the validity mask; evicted
  workers are re-admitted on probation after ``readmit_after`` steps;
* bounded rollback — ``rollback_after`` consecutive held steps restore
  the last_good checkpoint (advanced only after restore-validation) with
  exponential backoff between attempts and a hard ``max_rollbacks``
  retry budget (exceeding it raises :class:`SupervisorError`).

The supervisor never reads the fault schedule: it sees only the step
metrics, so detection latency and eviction targeting are honest.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..checkpoint import ckpt
from ..configs.base import ByzantineConfig, RecoveryConfig


class SupervisorError(RuntimeError):
    """Recovery budget exhausted — the run cannot self-heal."""


def feasible_round(n_active: int, alpha: float) -> bool:
    """Can a shrunk round of ``n_active`` workers still be aggregated
    soundly?  The adversary holds floor(alpha·n_active) of them, so the
    round needs the honest-majority bound ByzantineConfig enforces for
    the configured quorum."""
    return n_active >= 1 and n_active > 2 * math.floor(alpha * n_active)


_HELD_METRICS = ("loss", "ce", "gnorm", "n_selected", "n_selected_min")


def _to_host(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
    return np.asarray(v)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


class Supervisor:
    """Drives one guarded elastic step (``training/step.py``,
    ``recovery.guard=True``): ``run_step`` wraps each ``step_fn`` call
    with the recovery policy above; ``checkpoint`` saves with keep-last-k
    retention and advances ``last_good`` only after restore-validation
    passes.

    ``like`` is a template of the parameter tree: only its structure,
    shapes and dtypes are kept (the step updates the live params in
    place), and a rollback restores onto the device of its leaves."""

    def __init__(self, step_fn, bcfg: ByzantineConfig,
                 rcfg: RecoveryConfig, m: int,
                 ckpt_dir: Optional[str] = None, like=None):
        if not bcfg.elastic:
            raise ValueError("Supervisor requires an elastic config "
                             "(ByzantineConfig.quorum/max_m)")
        self.step_fn = step_fn
        self.bcfg, self.rcfg, self.m = bcfg, rcfg, m
        self.ckpt_dir = ckpt_dir
        self.like, self.device = None, None
        if like is not None:
            leaf = _first_leaf(like)
            self.device = (leaf.device if torch.is_tensor(leaf)
                           else torch.device("cpu"))
            self.like = ckpt.empty_like(like, "meta")
        self.evicted = np.zeros(m, bool)
        self.strikes = np.zeros(m, np.int64)
        self.readmit_at = np.full(m, -1, np.int64)
        self.loss_ema: Optional[float] = None
        self.rollbacks = 0
        self.holds = 0
        self.quorum_shrinks = 0
        self.quorum_holds = 0
        self.evictions = 0
        self.readmissions = 0
        self.ckpt_quarantines = 0
        self._consec_bad = 0
        self._cooldown_until = -1
        self.events: list = []      # (step, kind, detail)
        self.log: list = []         # per-step {"step", "ok", "n_active"}

    # -- helpers -------------------------------------------------------
    def _event(self, step: int, kind: str, detail: str = "") -> None:
        self.events.append({"step": int(step), "kind": kind,
                            "detail": detail})

    def _held_metrics(self, n_active: int, reason: str) -> dict:
        met = {k: float("nan") for k in _HELD_METRICS}
        met.update(n_active=float(n_active), step_ok=0.0, grad_finite=1.0,
                   loss_spike=0.0, held=reason)
        return met

    def active_mask(self, step: int, sched_active=None) -> np.ndarray:
        """This round's [m] validity mask: the arrival schedule minus
        evicted workers, with probation re-admission applied first."""
        back = self.evicted & (self.readmit_at >= 0) \
            & (self.readmit_at <= step)
        for w in np.flatnonzero(back):
            self.evicted[w] = False
            self.strikes[w] = 0
            self.readmit_at[w] = -1
            self.readmissions += 1
            self._event(step, "readmit", f"worker {w}")
        act = (np.ones(self.m, np.float32) if sched_active is None
               else _to_host(sched_active).astype(np.float32).copy())
        act[self.evicted] = 0.0
        return act

    # -- the supervised step -------------------------------------------
    def run_step(self, params, opt_state, batch, step: int, key,
                 sched_active=None, faults=None):
        """One supervised round.  Returns (params, opt_state, metrics)
        where metrics are host floats (plus ``held`` on skipped
        rounds).  ``faults`` is the [m] grad-fault mask a chaos harness
        injects; the supervisor forwards it blindly — detection runs on
        the step's own metrics."""
        rcfg = self.rcfg
        act = self.active_mask(step, sched_active)
        n_active = int(act.sum())
        quorum = self.bcfg.quorum or self.m

        if n_active < quorum:
            if not feasible_round(n_active, self.bcfg.alpha):
                self.quorum_holds += 1
                self._event(step, "quorum_hold",
                            f"n_active={n_active} < quorum={quorum} and "
                            f"the honest-majority bound fails — holding")
                met = self._held_metrics(n_active, "quorum")
                self.log.append({"step": step, "ok": False,
                                 "n_active": n_active})
                return params, opt_state, met
            self.quorum_shrinks += 1
            self._event(step, "quorum_shrink",
                        f"running {n_active} < quorum={quorum} "
                        f"(bound holds at alpha={self.bcfg.alpha})")

        flt = (np.zeros(self.m, np.float32) if faults is None
               else _to_host(faults).astype(np.float32))
        ema = np.float32(-1.0 if self.loss_ema is None else self.loss_ema)
        new_params, new_opt, met = self.step_fn(
            params, opt_state, batch, step, key, act, flt, ema)
        met = {k: _to_host(v) for k, v in met.items()}
        worker_ok = met.pop("worker_ok", np.ones(self.m, np.float32))
        ok = bool(met["step_ok"] > 0)
        met = {k: float(v) for k, v in met.items()}
        self.log.append({"step": step, "ok": ok, "n_active": n_active})

        if ok:
            self._consec_bad = 0
            d = rcfg.ema_decay
            loss = met["loss"]
            self.loss_ema = (loss if self.loss_ema is None
                             else d * self.loss_ema + (1 - d) * loss)
            return new_params, new_opt, met

        # held in the step: new_params are params, untouched
        self.holds += 1
        self._consec_bad += 1
        reason = ("spike" if met.get("loss_spike") else "nonfinite")
        self._event(step, "hold", f"step held ({reason}): "
                    f"gnorm={met['gnorm']} loss={met['loss']}")
        bad = np.flatnonzero((np.asarray(worker_ok) == 0) & (act > 0))
        for w in bad:
            self.strikes[w] += 1
            if not self.evicted[w] and self.strikes[w] >= rcfg.evict_after:
                self.evicted[w] = True
                self.readmit_at[w] = step + rcfg.readmit_after
                self.evictions += 1
                self._event(step, "evict",
                            f"worker {w} (worker_ok=0, "
                            f"strike {int(self.strikes[w])})")
        if (self._consec_bad >= rcfg.rollback_after
                and self.ckpt_dir is not None
                and step >= self._cooldown_until):
            new_params = self._rollback(step, new_params)
        met["held"] = reason
        return new_params, new_opt, met

    def _rollback(self, step: int, params):
        """Restore the newest restorable checkpoint, last_good first.
        Exponential backoff between attempts; a hard retry budget."""
        candidates = []
        lg = ckpt.last_good_step(self.ckpt_dir)
        if lg is not None:
            candidates.append(lg)
        candidates += [s for s in reversed(ckpt.steps(self.ckpt_dir))
                       if s != lg]
        for cand in candidates:
            try:
                tree, got = ckpt.restore(self.ckpt_dir, self.like,
                                         step=cand, device=self.device)
            except Exception as e:            # quarantine and try older
                self._event(step, "rollback_skip",
                            f"step {cand} unrestorable: "
                            f"{type(e).__name__}")
                continue
            self.rollbacks += 1
            if self.rollbacks > self.rcfg.max_rollbacks:
                raise SupervisorError(
                    f"rollback budget exhausted ({self.rcfg.max_rollbacks})"
                    f" — still unhealthy at step {step}")
            self._cooldown_until = step + (self.rcfg.backoff_base
                                           * 2 ** (self.rollbacks - 1))
            self._consec_bad = 0
            self.loss_ema = None              # re-learn the baseline
            self._event(step, "rollback",
                        f"restored step {got} (rollback "
                        f"{self.rollbacks}/{self.rcfg.max_rollbacks}, "
                        f"cooldown until {self._cooldown_until})")
            return tree
        self._event(step, "rollback_failed", "no restorable checkpoint")
        return params

    # -- checkpointing with a validated last_good pointer --------------
    def checkpoint(self, params, step: int) -> bool:
        """keep-last-k save; ``last_good`` advances only if the written
        checkpoint passes restore-validation (torn/corrupt saves are
        quarantined, never pointed at)."""
        assert self.ckpt_dir is not None
        ckpt.save(self.ckpt_dir, params, step=step,
                  keep=self.rcfg.keep_ckpts)
        try:
            ckpt.mark_good(self.ckpt_dir, step, like=self.like)
        except Exception as e:
            self.ckpt_quarantines += 1
            self._event(step, "ckpt_quarantine",
                        f"step {step} failed validation: "
                        f"{type(e).__name__}")
            return False
        return True

    def summary(self) -> dict:
        return {"holds": self.holds, "rollbacks": self.rollbacks,
                "evictions": self.evictions,
                "readmissions": self.readmissions,
                "quorum_shrinks": self.quorum_shrinks,
                "quorum_holds": self.quorum_holds,
                "ckpt_quarantines": self.ckpt_quarantines,
                "events": self.events}
