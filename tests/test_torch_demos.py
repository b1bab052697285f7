"""The port's demo twins (``src/repro_torch/paper/``) against the JAX
package's examples (``examples/train_100m.py``, ``serve_demo.py``,
``byzantine_lenet.py``), on the CPU:

* each twin hands ``launch.train.main`` / ``launch.serve.main`` the argv
  its example hands the JAX launcher, apart from the port's
  ``--workers`` and ``--device`` (both launchers recorded by a
  monkeypatched ``main``, the examples run with their own argparse);
  ``--full`` registers the same qwen3-100m config in both registries;
* ``serve_demo --train-and-serve``, ``train_100m`` (3 steps) and
  ``byzantine_lenet --steps 2`` run through and pass their examples'
  assertions; byzantine_lenet's deterministic rows (the baseline and
  negation, scale, label_flip under every rule) equal JAX's
  ``benchmarks.common.train_lenet`` from the same initial weights
  (JAX's, carried across), gaussian's are finite (its noise comes from
  torch generators: ROADMAP, PRNG).
"""
import dataclasses
import importlib.util
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.serve as jserve
import repro.launch.train as jtrain
import repro_torch.configs as tconfigs
import repro_torch.launch.serve as tserve
import repro_torch.launch.train as ttrain
from repro.configs.lenet_fmnist import LeNetConfig as JLeNetConfig
from repro.models import lenet as jlenet
from repro.models import params as JPM
from repro_torch.models import params as TPM
from repro_torch.models import transformer as TTF
from repro_torch.paper import byzantine_lenet, common, serve_demo, train_100m

REPO = Path(__file__).resolve().parents[1]


class _Recorded(Exception):
    pass


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(calls):
    def main(argv=None):
        calls.append(list(argv))
        raise _Recorded
    return main


def _run_example(monkeypatch, name, args, module, calls):
    monkeypatch.setattr(module, "main", _recorder(calls))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    with pytest.raises(_Recorded):
        _example(name).main()


def _run_twin(monkeypatch, twin, argv, module, calls):
    monkeypatch.setattr(module, "main", _recorder(calls))
    with pytest.raises(_Recorded):
        twin.main(argv)


def _without_port_flags(argv):
    """argv less the port's own --workers N and --device D."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--workers", "--device"):
            skip = True
        else:
            out.append(a)
    return out


@pytest.fixture(autouse=True)
def one_thread():
    """The twins' CPU runs are small: torch's whole thread pool in each of
    the suite's worker processes oversubscribes the cores (a 2 s run took
    100 s in a six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def registries(monkeypatch):
    """Both registries as copies: --full registers qwen3-100m in them."""
    monkeypatch.setattr(jconfigs, "ARCHS", dict(jconfigs.ARCHS))
    monkeypatch.setattr(tconfigs, "ARCHS", dict(tconfigs.ARCHS))


@pytest.fixture
def fixed_tempdirs(monkeypatch, tmp_path):
    """tempfile.mkdtemp names its directory by the prefix alone, under
    tmp_path, so two runs hand their launchers the same paths."""
    def mkdtemp(prefix="tmp", **_):
        path = tmp_path / prefix
        path.mkdir(exist_ok=True)
        return str(path)
    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)


# ---------------------------------------------------------------------------
# the argv each twin hands its launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [[], ["--full"], ["--steps", "7",
                                                   "--attack", "scale",
                                                   "--alpha", "0.1"]])
def test_train_100m_argv_is_the_examples(args, monkeypatch, registries):
    want, got = [], []
    _run_example(monkeypatch, "train_100m", args, jtrain, want)
    _run_twin(monkeypatch, train_100m, args + ["--device", "cpu"], ttrain,
              got)
    assert _without_port_flags(got[0]) == want[0]
    assert got[0][-4:] == ["--workers", "8", "--device", "cpu"]
    if "--full" in args:
        tc, jc = tconfigs.ARCHS["qwen3-100m"], jconfigs.ARCHS["qwen3-100m"]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert TPM.count_params(TTF.param_defs(tc)) == 100_684_032


@pytest.mark.parametrize("args", [["--arch", "minicpm3-4b"],
                                  ["--arch", "nemotron-4-15b", "--full",
                                   "--batch", "2", "--gen", "3"],
                                  ["--arch", "rwkv6-7b", "--seed", "4"]])
def test_serve_demo_argv_is_the_examples(args, monkeypatch):
    want, got = [], []
    _run_example(monkeypatch, "serve_demo", args, jserve, want)
    _run_twin(monkeypatch, serve_demo, args + ["--device", "cpu"], tserve,
              got)
    assert _without_port_flags(got[0]) == want[0]
    assert got[0][-2:] == ["--device", "cpu"]


def test_train_and_serve_trains_with_the_examples_argv(monkeypatch,
                                                       fixed_tempdirs):
    want, got = [], []
    _run_example(monkeypatch, "serve_demo", ["--train-and-serve"], jtrain,
                 want)
    _run_twin(monkeypatch, serve_demo, ["--train-and-serve", "--device",
                                        "cpu", "--workers", "4"], ttrain,
              got)
    assert _without_port_flags(got[0]) == want[0]
    assert got[0][-4:] == ["--workers", "4", "--device", "cpu"]


# ---------------------------------------------------------------------------
# the twins run on the CPU
# ---------------------------------------------------------------------------

def test_serve_demo_train_and_serve_runs_on_cpu(capsys):
    out = serve_demo.main(["--train-and-serve", "--device", "cpu"])
    assert len(out["done"]) == 8
    assert out["swap_count"] >= 1 and out["loaded_step"] == 5
    assert out["decode_graphs"] == 0          # eager on the CPU
    text = capsys.readouterr().out
    assert "train->serve OK: 8/8 requests" in text
    assert "repro_serve_swaps 1" in text


def test_train_100m_runs_on_cpu(tmp_path, capsys):
    hist = train_100m.main(["--steps", "3", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ck")])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert "under gaussian@25% with BrSGD aggregation" in \
        capsys.readouterr().out
    assert (tmp_path / "ck" / "history.json").exists()


def test_byzantine_lenet_matches_the_jax_harness(monkeypatch, capsys):
    """Both start from JAX's LeNet init (PRNGKey(0)); the data, the
    membership (prefix) and every attack but gaussian are deterministic,
    so the final accuracies agree."""
    sys.path.insert(0, str(REPO))
    try:
        from benchmarks.common import train_lenet as j_train_lenet
    finally:
        sys.path.remove(str(REPO))
    jparams = JPM.init_params(jlenet.lenet_defs(JLeNetConfig()),
                              jax.random.PRNGKey(0))
    monkeypatch.setattr(common, "init_params",
                        lambda defs, gen, device: TPM.params_from_jax(
                            jparams, device))
    out = byzantine_lenet.main(["--steps", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "attack-free baseline accuracy" in text
    assert sorted(out["rows"]) == sorted(byzantine_lenet.ATTACKS)
    want = j_train_lenet("mean", "none", 0.0, steps=2)[0]
    assert out["baseline"] == pytest.approx(want, abs=1e-9)
    for attack, row in out["rows"].items():
        assert sorted(row) == sorted(byzantine_lenet.AGGS)
        for agg, acc in row.items():
            if attack == "gaussian":
                assert np.isfinite(acc) and 0.0 <= acc <= 1.0, (agg, acc)
                continue
            want = j_train_lenet(agg, attack, 0.25, steps=2)[0]
            assert (np.isnan(acc) and np.isnan(want)) or \
                acc == pytest.approx(want, abs=1e-9), (attack, agg, acc, want)


def test_twins_default_to_the_card(monkeypatch):
    """Without --device the twins take the card, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        byzantine_lenet.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_demo.main(["--arch", "qwen3-0.6b"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_100m.main(["--steps", "1"])
