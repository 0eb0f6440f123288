"""The port's checkpoint package (``repro_torch.ckpt``) against the JAX
package's (``repro.ckpt``): for one tree of arrays both write the same
manifest and byte-identical leaves, each restores the other's steps, and the
integrity checks of tests/test_ckpt.py hold in the port. The fault injector
of checkpoint writes fails the same (step, leaf) pairs in both packages."""
import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.core.faults import FaultInjector as JInjector
from repro.core.faults import FaultPlan as JPlan
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.core.faults import FaultInjector, FaultPlan


def _tree(seed: int = 0) -> dict:
    """Nested dicts over the dtypes an index checkpoint holds, with uint32
    words >= 2**31."""
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(0, 1, (16, 8)).astype(np.float32),
        "b": {"c": np.arange(10, dtype=np.int32),
              "d": rng.normal(0, 1, (3,)).astype(np.float32)},
        "blooms": rng.integers(0, 2 ** 32, 33, dtype=np.int64)
        .astype(np.uint32),
        "codes": rng.integers(0, 256, (7, 4)).astype(np.uint8),
        "offsets": np.arange(5, dtype=np.int64),
        "empty": np.zeros((0, 3), np.float32),
    }


def _target(tree):
    return {k: _target(v) if isinstance(v, dict)
            else tckpt.ArraySpec(v.shape, v.dtype) for k, v in tree.items()}


def _jax_target(tree):
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def _assert_tree_equal(a, b):
    la, lb = tckpt._flatten(a), tckpt._flatten(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def test_flatten_matches_jax_tree_util():
    tree = _tree()
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in tckpt._flatten(tree)] == want


def test_same_manifest_and_leaf_bytes(tmp_path):
    tree = _tree(1)
    jckpt.save(str(tmp_path / "jax"), 3, tree)
    tckpt.save(str(tmp_path / "port"), 3, tree)
    jdir, tdir = tmp_path / "jax" / "step_3", tmp_path / "port" / "step_3"
    jm = json.loads((jdir / "manifest.json").read_text())
    tm = json.loads((tdir / "manifest.json").read_text())
    assert jm == tm
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for leaf in jm["leaves"]:
        assert (jdir / leaf["file"]).read_bytes() == \
            (tdir / leaf["file"]).read_bytes(), leaf["path"]


def test_torch_tensor_leaves_write_like_numpy(tmp_path):
    tree = _tree(2)
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"]),
                   "d": torch.from_numpy(tree["b"]["d"])}}
    sub = {"a": tree["a"], "b": tree["b"]}
    tckpt.save(str(tmp_path / "t"), 1, ttree)
    jckpt.save(str(tmp_path / "j"), 1, sub)
    for name in ("manifest.json", "leaf_00000.npy", "leaf_00002.npy"):
        assert (tmp_path / "t" / "step_1" / name).read_bytes() == \
            (tmp_path / "j" / "step_1" / name).read_bytes()


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_cross_restore(tmp_path, writer):
    """Each package restores the other's step (and its own)."""
    tree = _tree(3)
    (jckpt if writer == "repro" else tckpt).save(str(tmp_path), 5, tree)
    _assert_tree_equal(tckpt.restore(str(tmp_path), 5, _target(tree)), tree)
    # repro's restore puts leaves on a JAX device, which canonicalises
    # dtypes (int64 -> int32 without x64): compare with the same placement
    back = jckpt.restore(str(tmp_path), 5, _jax_target(tree))
    placed = jax.tree_util.tree_map(lambda x: np.asarray(jax.device_put(x)),
                                    tree)
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray, back), placed)


def test_async_save_and_gc(tmp_path):
    tree = _tree(4)
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_last=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, tree)
    mgr.wait()
    assert sorted(tckpt._list_steps(str(tmp_path))) == [3, 4]
    step, back = mgr.restore(_target(tree))
    assert step == 4
    _assert_tree_equal(back, tree)


def test_checksum_detects_corruption(tmp_path):
    tree = _tree(5)
    tckpt.save(str(tmp_path), 1, tree)
    with open(tmp_path / "step_1" / "leaf_00000.npy", "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(tckpt.CheckpointCorruptionError, match="checksum"):
        tckpt.restore(str(tmp_path), 1, _target(tree))


def test_restore_verifies_shape_and_dtype(tmp_path):
    tree = {"a": np.arange(8, dtype=np.int32)}
    tckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(tckpt.CheckpointCorruptionError, match="dtype"):
        tckpt.restore(str(tmp_path), 1,
                      {"a": tckpt.ArraySpec((8,), np.float32)})
    with pytest.raises(tckpt.CheckpointCorruptionError, match="shape"):
        tckpt.restore(str(tmp_path), 1,
                      {"a": tckpt.ArraySpec((9,), np.int32)})
    with pytest.raises(tckpt.CheckpointCorruptionError, match="leaves"):
        tckpt.restore(str(tmp_path), 1, {"a": tree["a"], "b": tree["a"]})


def test_truncated_leaf_detected(tmp_path):
    tree = _tree(6)
    tckpt.save(str(tmp_path), 1, tree)
    leaf = tmp_path / "step_1" / "leaf_00000.npy"
    with open(leaf, "r+b") as f:
        f.truncate(os.path.getsize(leaf) // 2)
    with pytest.raises(tckpt.CheckpointCorruptionError, match="checksum"):
        tckpt.restore(str(tmp_path), 1, _target(tree))
    # without verification the truncated payload is still caught
    with pytest.raises(tckpt.CheckpointCorruptionError, match="unreadable"):
        tckpt.restore(str(tmp_path), 1, _target(tree), verify=False)


def test_md5_manifest_back_compat(tmp_path):
    """Manifests of older writers (md5 digests) still verify and restore."""
    tree = _tree(7)
    tckpt.save(str(tmp_path), 1, tree)
    mf = tmp_path / "step_1" / "manifest.json"
    manifest = json.loads(mf.read_text())
    for meta in manifest["leaves"]:
        del meta["sha256"]
        meta["md5"] = hashlib.md5(
            (tmp_path / "step_1" / meta["file"]).read_bytes()).hexdigest()
    mf.write_text(json.dumps(manifest))
    _assert_tree_equal(tckpt.restore(str(tmp_path), 1, _target(tree)), tree)


def test_quarantine_excluded_from_listing(tmp_path):
    tree = _tree(8)
    tckpt.save(str(tmp_path), 1, tree)
    tckpt.save(str(tmp_path), 2, tree)
    tckpt.quarantine(str(tmp_path), 2)
    assert os.path.isdir(tmp_path / "step_2.quarantined")
    assert tckpt.latest_step(str(tmp_path)) == 1


def _injector(rate=1.0, seed=3):
    return FaultInjector(FaultPlan(seed=seed, ckpt_fail_rate=rate))


def test_crash_mid_save_reaped_and_previous_step_intact(tmp_path):
    tree = _tree(9)
    tckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(IOError, match="injected write fault"):
        tckpt.save(str(tmp_path), 2, tree, injector=_injector())
    assert os.path.isdir(tmp_path / "step_2.tmp")
    assert tckpt.latest_step(str(tmp_path)) == 1          # tmp never listed
    assert tckpt.reap_tmp(str(tmp_path)) == ["step_2.tmp"]
    assert not os.path.exists(tmp_path / "step_2.tmp")
    _assert_tree_equal(tckpt.restore(str(tmp_path), 1, _target(tree)), tree)


def test_async_writer_error_surfaces_from_wait(tmp_path):
    tree = _tree(10)
    mgr = tckpt.CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, tree, injector=_injector())
    with pytest.raises(IOError, match="injected write fault"):
        mgr.wait()
    mgr.save(2, tree)                    # the manager stays usable
    mgr.wait()
    assert mgr.latest() == 2


@pytest.mark.parametrize("seed,rate", [(9, 0.5), (3, 0.2), (2 ** 31 + 1,
                                                            0.7)])
def test_injector_matches_repro(seed, rate):
    """The same (step, leaf) pairs fail in both packages, including steps
    and leaf indexes >= 2**31."""
    pairs = [(s, l) for s in (0, 1, 2, 3, 2 ** 31, 2 ** 32 - 1)
             for l in (0, 1, 5, 17, 2 ** 31 + 7)]
    ji = JInjector(JPlan(seed=seed, ckpt_fail_rate=rate))
    ti = _injector(rate, seed)
    want = [ji.ckpt_write_fails(s, l) for s, l in pairs]
    got = [ti.ckpt_write_fails(s, l) for s, l in pairs]
    assert got == want and any(got) and not all(got)
    assert ti.n_write_faults == ji.n_write_faults


def test_injected_write_faults_hit_the_same_leaf(tmp_path):
    """Saving one tree under one plan, both packages fail on the same
    leaf with the same message."""
    tree = _tree(11)
    msgs = []
    for mod, inj in ((jckpt, JInjector(JPlan(seed=9, ckpt_fail_rate=0.3))),
                     (tckpt, _injector(0.3, 9))):
        with pytest.raises(IOError) as err:
            mod.save(str(tmp_path / mod.__name__), 4, tree, injector=inj)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
