"""Hot-swap checkpoint watcher (the port of the JAX package's
``serving/swap.py``): double-buffered params, flip between decode steps.

Two parameter slots, allocated once on the serving device, alternate as
active/standby; they are the only full parameter copies the server
holds there.  ``poll()`` (called by the serve loop between decode
steps) walks the complete checkpoints newest-first — a directory
listing, safe against torn writes because the trainer's manifest-last
protocol (checkpoint/ckpt.py) makes half-written checkpoints invisible —
and on a new step restores into the STANDBY slot in place
(``ckpt.restore(out=...)``, which reads and checks every member before
the first copy), synchronizes, then flips the active index.  The decode
step never sees a partially-loaded tree, no request is dropped, and
since each slot's buffers never move, the serve loop's decode graph of
a slot stays valid across every later swap into it: at most two graphs.

Quarantine: a checkpoint that is complete by the manifest protocol can
still fail restore — truncated npz members, manifest–npz key
disagreement, a tree from the wrong model.  ``poll`` catches the failure
(``RESTORE_ERRORS``), records the step in ``quarantined`` (never
retried), keeps serving the live slot, and falls through to the
next-newest candidate.
"""
from __future__ import annotations

import time
import zipfile
import zlib
from typing import Optional

import torch

from ..checkpoint import ckpt

# restore failure modes worth quarantining: key/shape mismatches and
# manifest disagreement (ValueError), unreadable/truncated files
# (OSError/EOFError/BadZipFile/zlib), garbage manifests (JSON errors
# are ValueError subclasses).  Anything else propagates.
RESTORE_ERRORS = (ValueError, KeyError, OSError, EOFError,
                  zipfile.BadZipFile, zlib.error)


class HotSwapper:
    def __init__(self, ckpt_dir: str, like, device="cuda"):
        """``like``: param tree of the target shapes/dtypes (tensors on
        any device, ``meta`` included); the manifest keys are validated
        against it on every restore.  ``device``: where the two slots
        live."""
        self.ckpt_dir = ckpt_dir
        self.device = torch.device(device)
        self._like = like
        self._slots = [ckpt.empty_like(like, self.device) for _ in range(2)]
        self._active = 0
        self.loaded_step: Optional[int] = None
        self.swap_count = 0
        self.swap_stall_s = 0.0
        self.last_stall_s = 0.0
        self.quarantined: dict = {}            # step -> failure reason
        self._last_load_t = time.perf_counter()
        if not self.poll():
            raise FileNotFoundError(
                f"no restorable checkpoint under {ckpt_dir}")

    def params(self):
        return self._slots[self._active]

    def staleness_s(self) -> float:
        """Seconds since params last advanced — the stale-swap-source
        signal the serve loop exports as a gauge."""
        return time.perf_counter() - self._last_load_t

    def poll(self) -> bool:
        """Load the newest restorable checkpoint if one newer than the
        live slot exists.  Returns True when the active params flipped;
        quarantined steps are skipped forever."""
        for step in sorted(ckpt.steps(self.ckpt_dir), reverse=True):
            if self.loaded_step is not None and step <= self.loaded_step:
                break
            if step in self.quarantined:
                continue
            t0 = time.perf_counter()
            standby = 1 - self._active
            try:
                ckpt.restore(self.ckpt_dir, self._like, step=step,
                             out=self._slots[standby])
            except RESTORE_ERRORS as e:
                self.quarantined[step] = f"{type(e).__name__}: {e}"
                continue                       # fall back to next-newest
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._active = standby
            stall = time.perf_counter() - t0
            if self.loaded_step is not None:   # first load isn't a swap
                self.swap_count += 1
                self.swap_stall_s += stall
            self.last_stall_s = stall
            self.loaded_step = step
            self._last_load_t = time.perf_counter()
            return True
        return False
