"""The port's float32 LeNet on the CPU against float64, in fresh
processes that import torch only and keep torch's own thread settings.

A float32 LeNet forward and per-worker gradient matrix G were seen to
drift, in some processes, ~50x further from float64 than in the rest
(2.2e-5 to 3.3e-5 of the largest magnitude, against ~4e-7), entering at
the second convolution; the cause was not pinned down.  The port's CPU
convolutions now accumulate in float64 and round once
(``models/lenet.py:_conv``).  Each process here holds the logits and
every row of G to 1e-5 of its largest float64 magnitude, the gate of
test_torch_lenet.py; the processes run at once, as the suite's workers
do.  This guards the result, not the fault: where the drift does not
show (it did not in 60 fresh processes of the float32 convolutions
tried for this test), the test passes without the float64 path too.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-5
PROCESSES = 4

SCRIPT = r"""
import json
import numpy as np
import torch
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


out = {"threads": torch.get_num_threads(),
       "forward": rel(lenet.lenet_forward(p32, x),
                      lenet.lenet_forward(p64, x.double()))}
rng = np.random.default_rng(0)
wb = {"images": torch.from_numpy(rng.random((4, 2, 28, 28, 1),
                                            dtype=np.float32)),
      "labels": torch.from_numpy(rng.integers(0, 10, (4, 2)).astype(np.int32))}
G = worker_grad_matrix(lenet.lenet_loss, p32, wb)
g64 = torch.func.vmap(torch.func.grad(lenet.lenet_loss), in_dims=(None, 0))(
    p64, {"images": wb["images"].double(), "labels": wb["labels"]})
G64 = torch.cat([g64[k].reshape(4, -1) for k in sorted(g64)], dim=1)
out["G_rows"] = [rel(G[i], G64[i]) for i in range(4)]
print(json.dumps(out))
"""


def test_lenet_forward_and_gradients_stay_near_float64_in_every_process():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", SCRIPT], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(PROCESSES)]
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    for r in results:
        assert r["forward"] <= RTOL, results
        assert max(r["G_rows"]) <= RTOL, results
