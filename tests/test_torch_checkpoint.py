"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) against the
JAX package's (``repro.checkpoint.ckpt``) on the same trees: one on-disk
format, so a checkpoint written by either restores in the other bit for
bit (reduced qwen3 and rwkv6 parameter trees with a bfloat16 leaf
added); and the port's write protocol, key validation, retention,
``last_good`` and the in-place restore that a torn npz never reaches.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as j_get_config
from repro.models import params as JPM
from repro.models import transformer as JTF
from repro_torch.checkpoint import ckpt
from repro_torch.faults import get_spec
from repro_torch.models import params as TPM
from repro_torch.serving import RESTORE_ERRORS

ARCHS = ("qwen3-0.6b", "rwkv6-7b")


def _trees(arch):
    """The JAX tree of a reduced config, perturbed so every leaf is
    distinct, with a bfloat16 leaf added, and the port's copy of it."""
    cfg = j_get_config(arch).reduced()
    jp = JPM.init_params(JTF.param_defs(cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)), jp)
    half = rng.normal(size=(3, 5)).astype(np.float32)
    jp["extra"] = {"half": jnp.asarray(half, jnp.bfloat16)}
    tp = TPM.params_from_jax({k: v for k, v in jp.items() if k != "extra"})
    tp["extra"] = {"half": torch.from_numpy(half).to(torch.bfloat16)}
    return jp, tp


def _assert_bitequal(torch_tree, jax_tree):
    jleaves = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    tleaves = ckpt._leaves_with_paths(torch_tree)
    assert ([jax.tree_util.keystr(p) for p, _ in jleaves]
            == ["".join(f"['{k}']" for k in p) for p, _ in tleaves])
    for (_, j), (_, t) in zip(jleaves, tleaves):
        want = np.asarray(j, np.float32)
        assert str(t.dtype).replace("torch.", "") == str(np.asarray(j).dtype)
        got = t.float().numpy()
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax_bitexact(arch, tmp_path):
    jp, tp = _trees(arch)
    d = str(tmp_path)
    ckpt.save(d, tp, step=7)
    got, step = jckpt.restore(d, like=jp)
    assert step == 7
    _assert_bitequal(tp, got)
    with open(os.path.join(d, "step_00000007.json")) as f:
        manifest = json.load(f)
    assert manifest == {"step": 7, "keys": sorted(ckpt._keys(tp)),
                        "extra": {}}


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_port_bitexact(arch, tmp_path):
    jp, tp = _trees(arch)
    d = str(tmp_path)
    jckpt.save(d, jp, step=3, extra={"arch": arch})
    got, step = ckpt.restore(d, like=tp)
    assert step == 3
    _assert_bitequal(got, jp)
    # into an existing tree in place: the same storage, the same bits
    out = ckpt.empty_like(tp, "cpu")
    ptrs = [t.data_ptr() for _, t in ckpt._leaves_with_paths(out)]
    got2, _ = ckpt.restore(d, like=tp, out=out)
    assert got2 is out
    assert ptrs == [t.data_ptr() for _, t in ckpt._leaves_with_paths(out)]
    _assert_bitequal(out, jp)


def test_roundtrip_bitexact(tmp_path):
    d = str(tmp_path)
    tree = {"w": {"a": torch.arange(32, dtype=torch.float32).reshape(4, 8),
                  "b": torch.linspace(-1, 1, 8).to(torch.bfloat16)},
            "s": np.int32(7), "n": np.arange(3.0)}
    ckpt.save(d, tree, step=3)
    got, step = ckpt.restore(d, like=tree)
    assert step == 3
    assert got["w"]["b"].dtype == torch.bfloat16
    assert got["s"].dtype == torch.int32 and int(got["s"]) == 7
    assert got["n"].dtype == torch.float64
    for k in ("a", "b"):
        assert torch.equal(got["w"][k], tree["w"][k])
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_latest_step_and_torn_write(tmp_path):
    """A crash between the .npz and the manifest leaves the step
    invisible; a manifest/npz disagreement fails loudly."""
    d = str(tmp_path)
    tree = {"a": torch.ones(3)}
    ckpt.save(d, tree, step=1)
    ckpt.save(d, tree, step=2)
    assert ckpt.latest_step(d) == 2
    ckpt.save(d, tree, step=3)
    os.remove(os.path.join(d, "step_00000003.json"))
    assert ckpt.latest_step(d) == 2 and ckpt.steps(d) == [1, 2]
    got, step = ckpt.restore(d, like=tree)
    assert step == 2 and torch.equal(got["a"], torch.ones(3))
    ckpt._atomic_write(os.path.join(d, "step_00000004.npz"),
                       lambda tmp: ckpt._savez(tmp, {"a": np.ones(3, "f4")}))
    ckpt._atomic_write(
        os.path.join(d, "step_00000004.json"),
        lambda tmp: ckpt._dump_json(tmp, {"step": 4, "keys": ["a", "ghost"],
                                          "extra": {}}))
    with pytest.raises(ValueError, match="torn write"):
        ckpt.restore(d, like={"a": torch.ones(3), "ghost": torch.ones(2)},
                     step=4)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), like=tree)


def test_restore_validates_manifest_keys(tmp_path):
    """A checkpoint of another model fails with the missing/extra key
    names before any array is read; a shape mismatch names the key."""
    d = str(tmp_path)
    ckpt.save(d, {"w": {"a": torch.ones(2), "old_name": torch.ones(2)}},
              step=1)
    like = {"w": {"a": torch.ones(2), "new_name": torch.ones(2)}}
    with pytest.raises(ValueError) as e:
        ckpt.restore(d, like=like)
    assert "missing=['w/new_name']" in str(e.value)
    assert "extra=['w/old_name']" in str(e.value)
    with pytest.raises(ValueError, match="shape mismatch for w/a"):
        ckpt.restore(d, like={"w": {"a": torch.ones(3),
                                    "old_name": torch.ones(2)}})
    # the same messages as the JAX package's
    jlike = {"w": {"a": np.ones(2, "f4"), "new_name": np.ones(2, "f4")}}
    with pytest.raises(ValueError) as je:
        jckpt.restore(d, like=jlike)
    assert str(je.value) == str(e.value)


def _tree(x):
    return {"w": torch.full((4, 3), float(x)), "b": torch.arange(3.0)}


def test_keep_last_k_spares_last_good(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        ckpt.save(d, _tree(s), step=s, keep=2)
        if s == 2:
            ckpt.mark_good(d, 2)
    assert ckpt.steps(d) == [2, 4, 5]
    assert ckpt.last_good_step(d) == 2
    assert ckpt.prune(d, 1) == [4]
    assert ckpt.steps(d) == [2, 5]


def test_mark_good_refuses_corruption(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, _tree(1), step=1)
    ckpt.mark_good(d, 1, like=_tree(0))
    ckpt.save(d, _tree(2), step=2)
    get_spec("corrupt_ckpt").inject(d, 2, np.random.default_rng(0))
    with pytest.raises(ValueError, match="disagree"):
        ckpt.mark_good(d, 2)
    assert ckpt.last_good_step(d) == 1
    ckpt.save(d, _tree(3), step=3)
    get_spec("torn_ckpt").inject(d, 3, np.random.default_rng(0))
    with pytest.raises(RESTORE_ERRORS):
        ckpt.validate(d, 3)
    with pytest.raises(ValueError, match="does not match"):
        ckpt.validate(d, 1, like={"w": torch.ones(4, 3)})


@pytest.mark.parametrize("fault", ["torn_ckpt", "corrupt_ckpt", "shape"])
def test_restore_out_untouched_when_the_npz_is_bad(fault, tmp_path):
    """restore(out=) reads and checks every member before the first
    copy: a truncated npz, a dropped member, or a last member of the
    wrong shape (found after the others were read) leaves ``out`` as it
    was."""
    d = str(tmp_path)
    rng = np.random.default_rng(0)
    tree = {f"l{i}": torch.from_numpy(rng.normal(size=(64, 64)).astype("f4"))
            for i in range(6)}
    if fault == "shape":
        ckpt.save(d, {**tree, "l5": tree["l5"][:, :63]}, step=1)
    else:
        ckpt.save(d, tree, step=1)
        get_spec(fault).inject(d, 1, np.random.default_rng(0))
    out = {k: torch.full_like(v, -3.0) for k, v in tree.items()}
    with pytest.raises(RESTORE_ERRORS):
        ckpt.restore(d, like=tree, out=out)
    assert all(torch.all(v == -3.0) for v in out.values())
