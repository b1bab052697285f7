"""Robustness telemetry channel (the port of the JAX package's
``serving/telemetry.py``, pure Python, its own copy): train loop →
JSONL → serve /metrics.

Training appends one row per logged step to ``telemetry.jsonl`` beside
its checkpoints (the directory the hot-swap watcher polls), so the
server can show what the aggregation layer saw when the weights it
serves were produced — selection rate vs the ``alpha·m`` bound, active
workers, quorum.

Row schema (append-only — add keys, never rename):
    {"step", "gnorm", "n_selected", "n_selected_min", "n_active",
     "quorum"}

``ServeMetrics`` collects the serving-side counters (per-token latency,
queue depth, swap count/stall) and renders both sides as a
``/metrics``-style text dump, the JAX package's text line for line.
``metrics.gauge(name, value)`` adds a counter.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

TELEMETRY_FILE = "telemetry.jsonl"
TRAIN_KEYS = ("step", "gnorm", "n_selected", "n_selected_min", "n_active",
              "quorum")


def append_row(ckpt_dir: str, row: dict) -> None:
    """Append one training telemetry row (validates the schema keys).
    Each row is flushed and fsynced: a host crash loses at most the
    in-flight row, which ``read_rows`` skips."""
    missing = [k for k in TRAIN_KEYS if k not in row]
    if missing:
        raise ValueError(f"telemetry row missing keys {missing}")
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, TELEMETRY_FILE), "a") as f:
        f.write(json.dumps({k: row[k] for k in row}) + "\n")
        f.flush()
        os.fsync(f.fileno())


def read_rows(ckpt_dir: str) -> list:
    path = os.path.join(ckpt_dir, TELEMETRY_FILE)
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue      # torn tail line from a concurrent writer
    return rows


def latest_row(ckpt_dir: str) -> Optional[dict]:
    rows = read_rows(ckpt_dir)
    return rows[-1] if rows else None


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


class ServeMetrics:
    """Serving-side counters.  Per-token latency is the wall time of the
    decode step that emitted the token (every live slot emits one token
    per step, so step samples are per-token samples)."""

    def __init__(self):
        self.step_lat_s: list = []       # one sample per decode step
        self.tokens = 0
        self.queue_depth = 0
        self.active_slots = 0
        self.completed = 0
        self.swaps = 0
        self.swap_stall_s = 0.0
        self.prefills = 0
        self.requeues = 0         # watchdog-restarted requests
        self._gauges: dict = {}
        self._t0 = time.perf_counter()

    def observe_decode(self, dt_s: float, n_live: int) -> None:
        self.step_lat_s.append(dt_s)
        self.tokens += n_live

    def observe_swap(self, stall_s: float) -> None:
        self.swaps += 1
        self.swap_stall_s += stall_s

    def gauge(self, name: str, value) -> None:
        self._gauges[name] = value

    def snapshot(self, train_row: Optional[dict] = None) -> dict:
        lat = sorted(self.step_lat_s)
        wall = max(time.perf_counter() - self._t0, 1e-9)
        out = {
            "latency_p50_ms": _percentile(lat, 0.50) * 1e3,
            "latency_p99_ms": _percentile(lat, 0.99) * 1e3,
            "tokens_per_s": self.tokens / wall,
            "tokens_total": self.tokens,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "requests_completed": self.completed,
            "requests_requeued": self.requeues,
            "prefills": self.prefills,
            "swaps": self.swaps,
            "swap_stall_ms": self.swap_stall_s * 1e3,
            **self._gauges,
        }
        if train_row:
            out["train"] = {k: train_row[k] for k in TRAIN_KEYS
                            if k in train_row}
        return out

    def render(self, train_row: Optional[dict] = None) -> str:
        """/metrics-style text: one ``name value`` line per counter."""
        snap = self.snapshot(train_row)
        train = snap.pop("train", None)
        lines = [f"repro_serve_{k} {v:.6g}" if isinstance(v, float)
                 else f"repro_serve_{k} {v}" for k, v in snap.items()]
        if train:
            lines += [f"repro_train_{k} {v:.6g}" if isinstance(v, float)
                      else f"repro_train_{k} {v}" for k, v in train.items()]
        return "\n".join(lines) + "\n"
