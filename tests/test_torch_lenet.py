"""The port's paper loop as a whole against the JAX package: data,
pipeline, LeNet, per-worker gradients and one simulation step at full
LeNet width (m = 4 workers, batch 2), plus the rules of the port.

Tolerances: the data and the pipeline are bit-equal; loss, G and the
stepped parameters agree within 1e-5 of the largest magnitude of each
row or leaf (convolution sums run in another order), and the selection
count is equal.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ByzantineConfig as JCfg
from repro.configs.lenet_fmnist import LeNetConfig as JLeNet
from repro.core import simulate as jsim
from repro.data.pipeline import ImageWorkerPipeline as JPipe
from repro.data.synthetic import fmnist_like as j_fmnist
from repro.models import lenet as jlenet
from repro.models.params import init_params as j_init
from repro_torch.configs.base import ByzantineConfig as TCfg
from repro_torch.configs.lenet_fmnist import LeNetConfig as TLeNet
from repro_torch.core import simulate as tsim
from repro_torch.data.pipeline import ImageWorkerPipeline as TPipe
from repro_torch.data.synthetic import fmnist_like as t_fmnist
from repro_torch.models import lenet as tlenet
from repro_torch.models.params import init_params as t_init
from repro_torch.models.params import params_from_jax

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def jparams():
    return j_init(jlenet.lenet_defs(JLeNet()), jax.random.PRNGKey(0))


def test_config_is_a_copy():
    assert TLeNet() == TLeNet(**JLeNet().__dict__)


def test_fmnist_like_is_bit_equal():
    for seed in (0, 5):
        ti, tl = t_fmnist(64, seed=seed)
        ji, jl = j_fmnist(64, seed=seed)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("attack,alpha", [("none", 0.0),
                                          ("label_flip", 0.5),
                                          ("scale", 0.25)])
def test_pipeline_batches_are_equal(attack, alpha):
    tp = TPipe(4, 16, seed=1, byz=TCfg(attack=attack, alpha=alpha))
    jp = JPipe(4, 16, seed=1, byz=JCfg(attack=attack, alpha=alpha))
    for step in (0, 3):
        tb, jb = tp.batch(step, 2), jp.batch(step, 2)
        for k in ("images", "labels"):
            np.testing.assert_array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(tp.test_labels, jp.test_labels)


def test_params_layout_and_flatten_order(jparams):
    tp = params_from_jax(jparams)
    assert list(tp) == sorted(jparams)
    for k in tp:
        assert tuple(tp[k].shape) == jparams[k].shape
    np.testing.assert_array_equal(tsim.tree_to_vec(tp),
                                  jsim.tree_to_vec(jparams))
    assert tsim.tree_to_vec(tp).numel() == 61706
    back = tsim.vec_to_tree(tsim.tree_to_vec(tp), tp)
    for k in tp:
        assert torch.equal(back[k], tp[k])
    own = t_init(tlenet.lenet_defs(TLeNet()), torch.Generator().manual_seed(0))
    assert list(own) == list(tp)
    for k in own:
        assert own[k].shape == tp[k].shape
        if k.endswith("_b"):
            assert not bool(own[k].any())
    # fan-in scaled normal: conv2 has fan-in 5*5*6 = 150
    assert abs(float(own["conv2_w"].std()) * 150 ** 0.5 - 1.0) < 0.05


def test_lenet_loss_and_accuracy_agree(jparams):
    imgs, labels = j_fmnist(16, seed=2)
    tp = params_from_jax(jparams)
    batch_t = {"images": torch.from_numpy(imgs),
               "labels": torch.from_numpy(labels)}
    close(tlenet.lenet_forward(tp, batch_t["images"]).detach(),
          jlenet.lenet_forward(jparams, jnp.asarray(imgs)))
    close(tlenet.lenet_loss(tp, batch_t).detach(),
          jlenet.lenet_loss(jparams, {"images": jnp.asarray(imgs),
                                      "labels": jnp.asarray(labels)}))
    assert float(tlenet.lenet_accuracy(tp, batch_t["images"],
                                       batch_t["labels"])) == \
        float(jlenet.lenet_accuracy(jparams, jnp.asarray(imgs),
                                    jnp.asarray(labels)))


def _batch(m=4, b=2):
    return JPipe(m, 16, seed=0).batch(0, b)


def test_worker_grad_matrix_matches_column_for_column(jparams):
    nb = _batch()
    got = tsim.worker_grad_matrix(
        tlenet.lenet_loss, params_from_jax(jparams),
        {k: torch.from_numpy(v) for k, v in nb.items()})
    want = jsim.worker_grad_matrix(
        jlenet.lenet_loss, jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    assert got.shape == (4, 61706)
    for i in range(4):
        close(got[i], want[i])


@pytest.mark.parametrize("agg,attack", [("brsgd", "scale"),
                                        ("mean", "sign_flip"),
                                        ("median", "negation"),
                                        ("krum", "ipm")])
def test_sim_step_matches_jax(jparams, agg, attack):
    nb = _batch()
    kw = dict(aggregator=agg, attack=attack, alpha=0.25)
    t_step = tsim.make_sim_step(tlenet.lenet_loss, TCfg(**kw), 0.05,
                                device="cpu")
    j_step = jsim.make_sim_step(jlenet.lenet_loss, JCfg(**kw), 0.05)
    tp, tm = t_step(params_from_jax(jparams), nb, torch.Generator())
    jp, jm = j_step(jparams, {k: jnp.asarray(v) for k, v in nb.items()},
                    jax.random.PRNGKey(0))
    assert float(tm["n_selected"]) == float(jm["n_selected"])
    assert int(tm["selected"].sum()) == int(float(jm["n_selected"]))
    if agg == "brsgd":
        assert not bool(tm["selected"][0])               # byzantine row
    for k in tp:
        close(tp[k], jp[k])
    close(tm["gnorm"], jm["gnorm"], rtol=1e-4)


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} "
                               f"imports {name}")
    assert len(_port_files()) > 15
    assert not bad, bad


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.paper import quickstart, table1
    from repro_torch.paper.common import train_lenet
    calls = [lambda: tsim.make_sim_step(tlenet.lenet_loss, TCfg(), 0.05),
             lambda: train_lenet("brsgd", "none", 0.0, steps=1),
             lambda: table1.main(1),
             quickstart.main]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_quickstart_and_train_lenet_run_on_cpu():
    from repro_torch.paper import quickstart
    from repro_torch.paper.common import train_lenet
    out = quickstart.main(device="cpu")
    assert out["brsgd_err"] < 1.0 < out["naive_err"]
    assert out["selected"] == list(range(5, 20))
    acc, curve = train_lenet("brsgd", "scale", 0.25, steps=3, device="cpu",
                             record_every=2)
    assert [s for s, _ in curve] == [0, 2] and 0.0 <= acc <= 1.0


def test_table1_gate(monkeypatch, capsys):
    from repro_torch.paper import table1
    accs = {"brsgd": 0.8, "median": 0.7, "mean": 0.1, "krum": 0.6}

    def fake(agg, attack, alpha, steps, device):
        return (0.85 if attack == "none" else accs[agg]), []

    monkeypatch.setattr(table1, "train_lenet", fake)
    assert table1.main(2, device="cpu") == 0
    out = capsys.readouterr().out
    assert "# CLAIM brsgd~baseline at all alpha: PASS" in out
    assert "# CLAIM mean collapses (gaussian 25%): PASS" in out
    accs["brsgd"] = 0.5
    assert table1.main(2, device="cpu") == 1
