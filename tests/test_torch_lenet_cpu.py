"""The port's float32 LeNet on the CPU against float64, in fresh
processes that import torch only and keep torch's own thread settings.

A float32 LeNet forward and per-worker gradient matrix G were seen to
drift, in some processes, ~50x further from float64 than in the rest
(2.2e-5 to 3.3e-5 of the largest magnitude, against ~4e-7).  The
per-stage report below caught it at the first float32 ``torch.tanh`` of
a process (6 of 192 processes at ATEN_CPU_CAPABILITY=avx2), so the
port's CPU convolutions and tanh run in float64 and round once
(``models/lenet.py:_conv``, ``_tanh``).  Each process here holds the
logits and every row of G to 1e-5 of its largest float64 magnitude, the
gate of test_torch_lenet.py; the processes run at once, as the suite's
workers do.  Where the drift does not show (at this host's AVX512
capability it did not in 48 processes), the test passes without the
float64 path too.

So that a failure names its cause, each process reports every stage of
the forward (conv1, tanh1, pool1, conv2, tanh2, pool2, fc1, fc2, the
logits) and every leaf of G against float64, its torch thread count,
CPU capability and seconds; a process that ran past its time limit, or
that was killed or failed, is reported as such and apart from one that
drifted.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-5
PROCESSES = 4
TIMEOUT_S = 300

SCRIPT = r"""
import json
import time
t0 = time.perf_counter()
import numpy as np
import torch
import torch.nn.functional as F
from repro_torch.configs.lenet_fmnist import LeNetConfig
from repro_torch.core.simulate import worker_grad_matrix
from repro_torch.data.synthetic import fmnist_like
from repro_torch.models import lenet
from repro_torch.models.params import init_params

p32 = init_params(lenet.lenet_defs(LeNetConfig()),
                  torch.Generator().manual_seed(0))
p64 = {k: v.double() for k, v in p32.items()}
imgs, _ = fmnist_like(16, seed=2)
x = torch.from_numpy(imgs)


def rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


def stages(p, images):
    # lenet.lenet_forward, keeping each stage's output
    out = {}
    h = images.permute(0, 3, 1, 2)
    h = out["conv1"] = lenet._conv(h, p["conv1_w"], p["conv1_b"], padding=2)
    h = out["tanh1"] = lenet._tanh(h)
    h = out["pool1"] = F.avg_pool2d(h, 2)
    h = out["conv2"] = lenet._conv(h, p["conv2_w"], p["conv2_b"])
    h = out["tanh2"] = lenet._tanh(h)
    h = out["pool2"] = F.avg_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = out["fc1"] = h @ p["fc1_w"] + p["fc1_b"]
    h = out["fc2"] = lenet._tanh(h) @ p["fc2_w"] + p["fc2_b"]
    out["logits"] = lenet._tanh(h) @ p["out_w"] + p["out_b"]
    return out


s32, s64 = stages(p32, x), stages(p64, x.double())
out = {"threads": torch.get_num_threads(),
       "cpu_capability": torch.backends.cpu.get_cpu_capability(),
       "forward": rel(lenet.lenet_forward(p32, x),
                      lenet.lenet_forward(p64, x.double())),
       "stages": {k: rel(s32[k], s64[k]) for k in s32}}
rng = np.random.default_rng(0)
wb = {"images": torch.from_numpy(rng.random((4, 2, 28, 28, 1),
                                            dtype=np.float32)),
      "labels": torch.from_numpy(rng.integers(0, 10, (4, 2)).astype(np.int32))}
G = worker_grad_matrix(lenet.lenet_loss, p32, wb)
g64 = torch.func.vmap(torch.func.grad(lenet.lenet_loss), in_dims=(None, 0))(
    p64, {"images": wb["images"].double(), "labels": wb["labels"]})
G64 = torch.cat([g64[k].reshape(4, -1) for k in sorted(g64)], dim=1)
out["G_rows"] = [rel(G[i], G64[i]) for i in range(4)]
leaves, a = {}, 0
for k in sorted(g64):
    n = g64[k][0].numel()
    leaves[k] = rel(G[:, a:a + n], G64[:, a:a + n])
    a += n
out["G_leaves"] = leaves
out["seconds"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def _run_all():
    """Start every process at once; for each, its parsed report or what
    kept it from reporting (time limit, signal, error)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(PROCESSES)]
    results = []
    for proc in procs:
        left = max(TIMEOUT_S - (time.perf_counter() - t0), 1.0)
        try:
            out, err = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            results.append({"cause": "timeout",
                            "seconds": time.perf_counter() - t0})
            continue
        if proc.returncode != 0:
            results.append({"cause": "exit", "returncode": proc.returncode,
                            "stderr": err[-2000:]})
            continue
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def _report(results) -> str:
    lines = [f"{PROCESSES} processes, gate {RTOL} of the largest float64 "
             f"magnitude; load average {os.getloadavg()}"]
    for i, r in enumerate(results):
        if "cause" in r:
            lines.append(f"process {i}: no report ({r})")
            continue
        drift = r["forward"] > RTOL or max(r["G_rows"]) > RTOL
        lines.append(
            f"process {i}: {'DRIFT' if drift else 'ok'}; threads "
            f"{r['threads']}, cpu {r['cpu_capability']}, {r['seconds']:.1f} "
            f"s; logits {r['forward']:.3g}; stages "
            + ", ".join(f"{k} {v:.3g}" for k, v in r["stages"].items())
            + "; G rows " + ", ".join(f"{v:.3g}" for v in r["G_rows"])
            + "; G leaves "
            + ", ".join(f"{k} {v:.3g}" for k, v in r["G_leaves"].items()))
    return "\n".join(lines)


def test_lenet_forward_and_gradients_stay_near_float64_in_every_process():
    results = _run_all()
    msg = _report(results)
    print(msg)
    failed = [r for r in results if "cause" in r]
    assert not failed, "a process did not report (not drift):\n" + msg
    for r in results:
        assert r["forward"] <= RTOL, "drift in the forward:\n" + msg
        assert max(r["G_rows"]) <= RTOL, "drift in G:\n" + msg
