"""FaultSpec registry (the port's own copy of the JAX package's
``faults/spec.py``, pure numpy, whole): declarative infrastructure
faults, mirroring the AggregatorSpec / AttackSpec idiom.

Byzantine attacks model an *adversary*; faults model *mundane
breakage* — crashed hosts, NaN bursts on honest workers, torn
checkpoints, frozen swap sources, wedged serve slots.  In the port the
``ckpt`` faults act on :mod:`repro_torch.checkpoint.ckpt` checkpoints
(the same on-disk format) and the ``serve`` faults on
:class:`repro_torch.serving.ServeLoop`; the ``worker`` and ``grad``
faults feed the guarded train step (``training/step.py``) that the
supervisor (``faults/supervisor.py``) drives.

Registry contract (DESIGN.md §Faults)
-------------------------------------
A :class:`FaultSpec` declares:

* ``scope`` — where the fault lands:

    ``worker``  the round's [m] active mask (host crash, flapping):
                ``inject(mask, targets) -> mask'`` is a pure rule over
                the arrival mask, applied every step the fault is
                active.  ``permanent=True`` (host crash) makes the
                trigger latch: once fired, active forever.
    ``grad``    the in-step NaN-burst mask ([m] f32 consumed by the
                guarded train step — the JAX package's training/step.py
                multiplies the
                targeted workers' loss by NaN inside the differentiated
                function, so the whole gradient of an HONEST worker
                goes non-finite, distinct from any attack):
                ``inject(fault, targets) -> fault'``.
    ``ckpt``    on-disk checkpoint state: ``inject(ckpt_dir, step, rng)
                -> str`` mutilates step ``step``'s files (truncated
                npz, manifest–npz disagreement) and returns a
                description.  Applied once per trigger firing.
    ``serve``   the serve loop: ``inject(ctx, rng) -> str`` where
                ``ctx`` is the harness's serve context (``.loop`` —
                a ServeLoop; ``.freeze(ticks)`` — the checkpoint
                publisher).  Applied once per firing.

* ``trigger`` schedules are data, not code: a :class:`Trigger` turns
  (at, every, prob, duration) into a seeded boolean activity vector,
  so a chaos run is reproducible from ``(events, seed)`` alone.

The recovery side lives in the HotSwapper quarantine + scheduler
requeue (serving/) and, for training, in the supervisor
(``faults/supervisor.py``).  Adding a fault is one :func:`register` call —
it is then available to :class:`ChaosPlan` schedules and the tests.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Tuple

import numpy as np

SCOPES = ("worker", "grad", "ckpt", "serve")


@dataclass(frozen=True)
class Trigger:
    """When a fault fires.  ``prob`` > 0 draws per-step Bernoulli
    firings (from step ``at`` on); otherwise the fault fires at ``at``
    and then every ``every`` steps (``every=0`` = once).  Each firing
    stays active for ``duration`` steps."""

    at: int = 0
    every: int = 0
    prob: float = 0.0
    duration: int = 1

    def __post_init__(self):
        if self.at < 0 or self.every < 0:
            raise ValueError(f"at/every must be >= 0, got at={self.at} "
                             f"every={self.every}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")

    def schedule(self, n_steps: int, rng) -> np.ndarray:
        """[n_steps] bool activity vector (seeded via ``rng``)."""
        active = np.zeros(n_steps, bool)
        if self.prob > 0:
            fires = np.flatnonzero(rng.random(n_steps) < self.prob)
            fires = fires[fires >= self.at]
        elif self.every > 0:
            fires = np.arange(self.at, n_steps, self.every)
        else:
            fires = np.array([self.at]) if self.at < n_steps else np.array([], int)
        for f in fires:
            active[f:f + self.duration] = True
        return active


@dataclass(frozen=True)
class FaultSpec:
    name: str
    scope: str
    inject: Callable
    permanent: bool = False       # worker scope: once fired, never rejoins
    doc: str = ""

    def __post_init__(self):
        if self.scope not in SCOPES:
            raise ValueError(f"fault {self.name!r}: scope must be one of "
                             f"{SCOPES}, got {self.scope!r}")
        if self.permanent and self.scope != "worker":
            raise ValueError(f"fault {self.name!r}: permanent is only "
                             f"meaningful for worker scope")


_REGISTRY: dict = {}


def register(spec: FaultSpec) -> FaultSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> FaultSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown fault {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def registered() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# shipped faults
# ---------------------------------------------------------------------------

def _drop_targets(mask: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """worker scope: targeted workers vanish from the round."""
    return mask * (1.0 - targets)


def _nan_targets(fault: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """grad scope: targeted workers' losses go NaN inside the step."""
    return np.maximum(fault, targets)


def _truncate_npz(ckpt_dir: str, step: int, rng) -> str:
    """Torn write: the npz loses its tail (manifest stays — the crash
    happened after the manifest rename, e.g. media corruption)."""
    npz = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    raw = open(npz, "rb").read()
    with open(npz, "wb") as f:
        f.write(raw[:max(1, len(raw) // 2)])
    return f"truncated {os.path.basename(npz)} to {len(raw) // 2}B"


def _drop_manifest_key(ckpt_dir: str, step: int, rng) -> str:
    """Manifest–npz disagreement: one array silently missing from the
    npz (e.g. a partial rewrite by a buggy uploader)."""
    npz = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(npz) as data:
        arrays = {k: data[k] for k in data.files}
    victim = sorted(arrays)[int(rng.integers(len(arrays)))]
    del arrays[victim]
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
    return f"dropped key {victim!r} from {os.path.basename(npz)}"


def _freeze_swap(ctx, rng) -> str:
    """Swap source frozen: the publisher stops shipping new checkpoints
    for the firing's duration (set by the harness via ctx)."""
    ticks = getattr(ctx, "stale_ticks", 8)
    ctx.freeze(ticks)
    return f"froze checkpoint publishing for {ticks} ticks"


def _stall_slot(ctx, rng) -> str:
    """One busy decode slot stops making progress (wedged device /
    lost worker) until the stall expires or the request is requeued."""
    loop = ctx.loop
    busy = [s for s in range(loop.max_batch)
            if loop._req_of_slot[s] is not None]
    if not busy:
        return "no busy slot to stall"
    slot = busy[int(rng.integers(len(busy)))]
    ticks = getattr(ctx, "stall_ticks", 16)
    loop.inject_stall(slot, ticks)
    return f"stalled slot {slot} for {ticks} ticks"


register(FaultSpec("host_crash", "worker", _drop_targets, permanent=True,
                   doc="permanent drop from the elastic active mask"))
register(FaultSpec("flap", "worker", _drop_targets,
                   doc="worker drops and rejoins after `duration` steps"))
register(FaultSpec("nan_burst", "grad", _nan_targets,
                   doc="honest workers emit NaN gradients for a burst"))
register(FaultSpec("torn_ckpt", "ckpt", _truncate_npz,
                   doc="checkpoint npz truncated mid-file"))
register(FaultSpec("corrupt_ckpt", "ckpt", _drop_manifest_key,
                   doc="manifest–npz key disagreement"))
register(FaultSpec("stale_swap", "serve", _freeze_swap,
                   doc="hot-swap source frozen: no new checkpoints land"))
register(FaultSpec("slot_stall", "serve", _stall_slot,
                   doc="one serve slot stops making decode progress"))


# ---------------------------------------------------------------------------
# seeded schedules over a worker set
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: a registered spec name, its trigger, and —
    for worker/grad scopes — the targeted workers (explicit ``workers``
    tuple, or ``n`` drawn from the plan's seeded rng)."""

    fault: str
    trigger: Trigger = field(default_factory=Trigger)
    workers: Tuple[int, ...] = ()
    n: int = 1


class ChaosPlan:
    """Precomputed seeded fault schedule: (events, m, n_steps, seed) →
    per-step worker-drop masks, grad-fault masks, and firing edges for
    the one-shot scopes.  Pure data — the same plan drives the faulted
    run and is recorded verbatim into BENCH_faults.json."""

    def __init__(self, events, m: int, n_steps: int, seed: int = 0):
        self.events = list(events)
        self.m, self.n_steps, self.seed = m, n_steps, seed
        self._active = np.zeros((len(self.events), n_steps), bool)
        self._targets = np.zeros((len(self.events), m), np.float32)
        for i, ev in enumerate(self.events):
            spec = get_spec(ev.fault)
            rng = np.random.default_rng((seed, i))
            sched = ev.trigger.schedule(n_steps, rng)
            if spec.permanent and sched.any():
                sched[int(np.argmax(sched)):] = True
            self._active[i] = sched
            if spec.scope in ("worker", "grad"):
                t = np.zeros(m, np.float32)
                if ev.workers:
                    t[list(ev.workers)] = 1.0
                else:
                    t[rng.choice(m, size=min(ev.n, m), replace=False)] = 1.0
                object.__setattr__(ev, "workers",
                                   tuple(int(w) for w in np.flatnonzero(t)))
                self._targets[i] = t

    def _apply(self, scope: str, step: int, init: np.ndarray) -> np.ndarray:
        out = init
        for i, ev in enumerate(self.events):
            spec = get_spec(ev.fault)
            if spec.scope == scope and self._active[i, step]:
                out = spec.inject(out, self._targets[i])
        return out

    def worker_mask(self, step: int) -> np.ndarray:
        """[m] f32 survival mask (1 = unaffected) for this step —
        multiply into the arrival schedule's active mask."""
        return self._apply("worker", step, np.ones(self.m, np.float32))

    def grad_faults(self, step: int) -> np.ndarray:
        """[m] f32 NaN-burst mask for the guarded train step."""
        return self._apply("grad", step, np.zeros(self.m, np.float32))

    def fired(self, step: int):
        """(event, spec) pairs whose trigger EDGES on at this step —
        the one-shot scopes (ckpt, serve) inject on the edge."""
        out = []
        for i, ev in enumerate(self.events):
            if self._active[i, step] and (step == 0
                                          or not self._active[i, step - 1]):
                out.append((ev, get_spec(ev.fault)))
        return out

    def onsets(self):
        """[(event, first step)] for every event that ever fires —
        the MTTR accounting anchors (benchmarks/chaos.py)."""
        out = []
        for i, ev in enumerate(self.events):
            if self._active[i].any():
                out.append((ev, int(np.argmax(self._active[i]))))
        return out

    def describe(self) -> list:
        """JSON-able schedule record for BENCH_faults.json."""
        rows = []
        for (ev, at) in self.onsets():
            spec = get_spec(ev.fault)
            rows.append({"fault": ev.fault, "scope": spec.scope, "at": at,
                         "duration": ev.trigger.duration,
                         "workers": list(ev.workers)})
        return rows
