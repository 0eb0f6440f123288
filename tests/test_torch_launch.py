"""The port's mesh and launch tooling (``repro_torch.launch.mesh``,
``shardings``, ``roofline``, ``dryrun``, ``dryrun_ann``,
``roofline_table``, ``serve.sp_attention``, the activation-sharding hooks,
``make_train_step(mesh=, param_specs=)``, ``launch.train --mesh`` and the
sharded checkpoint restore) against the JAX package's on the CPU.

The JAX side's specs come from ``jax.sharding.AbstractMesh``: its rules
need only axis names and sizes, not 256 devices. ``repro.launch.dryrun``
and ``dryrun_ann`` are not imported (they set ``XLA_FLAGS`` on import);
their figures come from ``repro.launch.roofline.model_flops`` and from
parameter shapes."""
import dataclasses
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from repro import ckpt as jckpt
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import smoke_config as jsmoke_config
from repro.data.tokens import lm_batch as jlm_batch
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.launch import shardings as jsh
from repro.models import common as JCOMMON
from repro.models import lm as JLM
from repro.models import moe as JMOE
from repro.serve import sp_attention as JSP
from repro.serve.decode import generate as jgenerate
from repro.train import optim as jopt
from repro.train import train_loop as jtl
from repro_torch import ckpt as tckpt
from repro_torch.configs import SHAPES, get_config, input_specs, list_archs, \
    smoke_config
from repro_torch.launch import dryrun, dryrun_ann, roofline, roofline_table
from repro_torch.launch import shardings as tsh
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import (Mesh, dp_axes, dp_size, make_local_mesh,
                                     make_production_mesh, shard_plan)
from repro_torch.models import attention as TA
from repro_torch.models import common as TCOMMON
from repro_torch.models import convert
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TMOE
from repro_torch.serve import generate
from repro_torch.serve import sp_attention as TSP
from repro_torch.train import optim as topt
from repro_torch.train import train_loop as ttl
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = list_archs()
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def jmesh_of(kind):
    return AbstractMesh(*MESHES[kind])


def tmesh_of(kind):
    return make_production_mesh(multi_pod=kind == "multi", device="meta")


# --- meshes ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_mesh_axes_equal_repro(kind):
    t, j = tmesh_of(kind), jmesh_of(kind)
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == j.shape and t.size == int(np.prod(MESHES[kind][0]))
    assert dp_axes(t) == jmesh.dp_axes(j)
    assert dp_size(t) == jmesh.dp_size(j)
    assert t.distinct_devices == (torch.device("meta"),)


def test_local_mesh_and_shard_plan():
    m = make_local_mesh(2, 4, "cpu")
    assert m.shape == {"data": 2, "model": 4} and dp_axes(m) == ("data",)
    assert dp_size(m) == 2 and m.distinct_devices == (torch.device("cpu"),)
    assert shard_plan(m).n_shards == 8
    assert shard_plan(m, ("model",)).n_shards == 4
    assert shard_plan(tmesh_of("multi")).n_shards == 512


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_refuses_too_few_devices(multi):
    """The JAX package's message, with the port's device count (one CPU)."""
    shape = (2, 16, 16) if multi else (16, 16)
    with pytest.raises(ValueError) as err:
        make_production_mesh(multi_pod=multi, device="cpu")
    assert str(err.value) == (f"Number of devices 1 must be >= the product "
                              f"of mesh_shape {shape}")
    with pytest.raises(ValueError) as jerr:
        jax.make_mesh(shape, MESHES["multi" if multi else "single"][1],
                      devices=jax.devices()[:1])
    assert re.sub(r"devices \d+", "devices 1", str(jerr.value)) == \
        str(err.value)


# --- sharding rules ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jshapes(arch: str, int8: bool):
    cfg = jget_config(arch)
    params = jax.eval_shape(lambda k: JLM.init_lm(cfg, k),
                            jax.random.PRNGKey(0))
    opt = jax.eval_shape(lambda p: jopt.init_opt_state(
        p, jopt.OptConfig(int8_moments=int8)), params)
    return params, opt


@functools.lru_cache(maxsize=None)
def _tshapes(arch: str, int8: bool):
    cfg = get_config(arch)
    model = TLM.init_lm(cfg, 0, "meta")
    opt = topt.init_opt_state(model, topt.OptConfig(int8_moments=int8))
    return (convert.param_shapes(cfg, model),
            topt.OptState(step=opt.step, m=convert.to_repro_tree(cfg, opt.m),
                          v=convert.to_repro_tree(cfg, opt.v)))


def _same_specs(got, want, mesh, jmesh_, got_shapes, want_shapes):
    """Path for path equal specs, and equal per-device bytes."""
    jflat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    tflat = tree_flatten_with_path(got, is_leaf=tsh.is_spec)
    assert [p for p, _ in tflat] == [jax.tree_util.keystr(p)
                                     for p, _ in jflat]
    for (path, t), (_, j) in zip(tflat, jflat):
        assert tuple(t) == tuple(j), path
    assert tsh.sharded_bytes(got_shapes, got, mesh) == \
        jsh.sharded_bytes(want_shapes, want, jmesh_)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["params", "opt_f32", "opt_int8"])
def test_param_and_opt_specs_equal_repro(arch, what):
    """All ten archs at full size on both production meshes, FSDP on and
    off: the port's parameter (and float32 / int8 moment) specs and
    per-device bytes equal ``repro``'s."""
    int8 = what == "opt_int8"
    jp, jo = _jshapes(arch, int8)
    tp, to = _tshapes(arch, int8)
    for kind in MESHES:
        tm, jm = tmesh_of(kind), jmesh_of(kind)
        for fsdp in (False, True):
            tr, jr = tsh.Rules(tm, fsdp), jsh.Rules(jm, fsdp)
            tps, jps = tsh.param_specs(tr, tp), jsh.param_specs(jr, jp)
            if what == "params":
                _same_specs(tps, jps, tm, jm, tp, jp)
            else:
                _same_specs(tsh.opt_specs(tr, to, tp),
                            jsh.opt_specs(jr, jo, jp), tm, jm, to, jo)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_data_specs_equal_repro(arch):
    """decode_32k caches (and long_500k's for the sub-quadratic archs)
    and every shape's inputs, both meshes, FSDP on and off."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    shapes = ["decode_32k"] + (["long_500k"] if tcfg.sub_quadratic else [])
    for shape_name in shapes:
        shape = SHAPES[shape_name]
        b, t = shape.global_batch, shape.seq_len
        jc = jax.eval_shape(lambda: JLM.init_caches(jcfg, b, t))
        tc = convert.caches_to_repro_tree(
            tcfg, TLM.init_caches(tcfg, b, t, device="meta"))
        for kind in MESHES:
            tm, jm = tmesh_of(kind), jmesh_of(kind)
            for fsdp in (False, True):
                tr, jr = tsh.Rules(tm, fsdp), jsh.Rules(jm, fsdp)
                for tseg, jseg in zip(tc, jc, strict=True):
                    _same_specs(tsh.cache_specs(tr, tseg, b),
                                jsh.cache_specs(jr, jseg, b), tm, jm, tseg,
                                jseg)
    for shape_name, shape in SHAPES.items():
        ti = input_specs(tcfg, shape)
        ji = jinput_specs(jcfg, JSHAPES[shape_name])
        for kind in MESHES:
            tm, jm = tmesh_of(kind), jmesh_of(kind)
            tspec = tsh.data_specs(tsh.Rules(tm), ti, shape.global_batch)
            jspec = jsh.data_specs(jsh.Rules(jm), ji, shape.global_batch)
            assert {k: tuple(v) for k, v in tspec.items()} == \
                {k: tuple(v) for k, v in jspec.items()}
            assert tsh.sharded_bytes(ti, tspec, tm) == \
                jsh.sharded_bytes(ji, jspec, jm)


def test_named_sharding_checks_and_places():
    m = make_local_mesh(2, 2, "cpu")
    ok = tsh.NamedSharding(m, tsh.P("data", "model"))
    x = ok.place(np.arange(8, dtype=np.float32).reshape(4, 2))
    assert x.device.type == "cpu" and x.shape == (4, 2)
    with pytest.raises(ValueError, match="does not divide"):
        ok.place(np.zeros((3, 2), np.float32))
    h = ok.place(np.asarray(jnp.full((2, 4), 1.5, jnp.bfloat16)))
    assert h.dtype == torch.bfloat16 and bool((h == 1.5).all())
    far = Mesh(np.array([[torch.device("cpu"), torch.device("meta")]],
                        dtype=object), ("data", "model"))
    with pytest.raises(NotImplementedError, match="distinct devices"):
        tsh.NamedSharding(far, tsh.P(None)).device


# --- activation-sharding hooks -----------------------------------------------

def test_activation_spec_resolves_as_repro():
    """The spec ``constrain_dims`` resolves (and replication where a dim
    does not divide), with and without sequence parallelism; identity on
    values; nothing without a mesh."""
    x = torch.zeros(32, 48, 8)
    assert TCOMMON.activation_spec(x.shape, "dp") is None
    try:
        TCOMMON.set_activation_sharding(tmesh_of("multi"), ("pod", "data"),
                                        seq_axis="model")
        assert TCOMMON.activation_spec(x.shape, "dp", "sp", "mp") == \
            (("pod", "data"), "model", None)
        assert TCOMMON.activation_spec((6, 48), "dp", "all") == \
            (None, None)
        assert TCOMMON.activation_spec((1024, 512), "all", "mp") == \
            (("pod", "data", "model"), "model")
        assert TCOMMON.shard_batch_dim(x) is x
        assert TCOMMON.constrain_dims(x, "mp", "dp", None) is x
    finally:
        TCOMMON.clear_activation_sharding()
    assert TCOMMON._ACT_CTX == {"mesh": None, "dp": None, "sp": None}


def test_f_split_equals_repro_and_split_layer_is_exact(monkeypatch):
    """``_f_split`` over a grid of (E, F, model axis), gated by
    ``REPRO_MOE_FSPLIT`` as in ``repro``; a layer split by the rule (E=4
    experts over a model axis of 16: split 4) equals the unsplit one."""
    grid = [(e, f, mp) for e in (4, 8, 16, 128) for f in (6, 64, 4864)
            for mp in (1, 2, 4, 16)]
    try:
        for env in (None, "1"):
            if env:
                monkeypatch.setenv("REPRO_MOE_FSPLIT", env)
            for e, f, mp in grid:
                JCOMMON.set_activation_sharding(
                    AbstractMesh((1, mp), ("data", "model")), ("data",))
                TCOMMON.set_activation_sharding(
                    make_local_mesh(1, mp, "cpu"), ("data",))
                assert TMOE._f_split(e, f) == JMOE._f_split(e, f), \
                    (env, e, f, mp)
            assert TMOE._f_split(4, 128) == (4 if env else 1)
        cfg = smoke_config("mixtral-8x22b")
        params = TMOE.init_moe(torch.Generator().manual_seed(0), cfg)
        x = torch.randn((2, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
        TCOMMON.set_activation_sharding(make_local_mesh(1, 16, "cpu"),
                                        ("data",))
        split, _ = TMOE.moe_forward(params, x, cfg)
        TCOMMON.clear_activation_sharding()
        whole, _ = TMOE.moe_forward(params, x, cfg)
        torch.testing.assert_close(split, whole, rtol=1e-5, atol=1e-6)
    finally:
        JCOMMON.clear_activation_sharding()
        TCOMMON.clear_activation_sharding()


# --- split-K decode -----------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sp_decode_attention_matches_reference(shards):
    """tests/test_distributed.py's inputs over S shards: the partials and
    the merge against both packages' single-device oracle within 2e-5."""
    b, t, hq, hkv, dh = 2, 64, 8, 4, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, s).astype(np.float32) for s in
               ((b, 1, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh)))
    for p in (40, 0, 63):
        pos = torch.tensor(p, dtype=torch.int32)
        ts = t // shards
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
        got = TSP.sp_decode_attention(
            torch.from_numpy(q), [kt.narrow(1, s * ts, ts)
                                  for s in range(shards)],
            [vt.narrow(1, s * ts, ts) for s in range(shards)], pos, hkv)
        want = JSP.reference_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(p, jnp.int32), n_kv=hkv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            got.numpy(), TSP.reference_decode_attention(
                torch.from_numpy(q), kt, vt, pos, hkv).numpy(),
            rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sp_cache_update_owner_only(shards):
    """tests/test_distributed.py's case: only the owner's slice takes the
    token, written through ``narrow`` views into the one cache."""
    b, t, hkv, dh = 1, 32, 2, 4
    kc, vc = torch.zeros((b, t, hkv, dh)), torch.zeros((b, t, hkv, dh))
    kn, vn = torch.ones((b, 1, hkv, dh)), torch.full((b, 1, hkv, dh), 2.0)
    pos = torch.tensor(13, dtype=torch.int32)
    ts = t // shards
    for s in range(shards):
        TSP.sp_cache_update(kc.narrow(1, s * ts, ts), vc.narrow(1, s * ts, ts),
                            kn, vn, pos, s)
    assert bool((kc[0, 13] == 1.0).all()) and bool((vc[0, 13] == 2.0).all())
    mask = np.ones(t, bool)
    mask[13] = False
    assert bool((kc[0, mask] == 0.0).all()) and bool((vc[0, mask] == 0).all())


def test_sp_decode_lm_generates_repro_tokens():
    """qwen2-1.5b's smoke config with ``sp_decode`` under a local (1, 4)
    mesh: greedy tokens equal ``repro``'s plain generation, each step
    through the split-K core, logits within 1e-4 of the port's plain
    path."""
    jcfg, tcfg = jsmoke_config("qwen2-1.5b"), smoke_config("qwen2-1.5b")
    params = JLM.init_lm(jcfg, jax.random.PRNGKey(3))
    model = convert.lm_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab, (3, 20)).astype(np.int32)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompts), 10,
                                max_t=40))
    sp_cfg = dataclasses.replace(tcfg, sp_decode=True)
    calls = []
    core = TA._sp_decode_core
    try:
        TA._sp_decode_core = lambda *a: calls.append(1) or core(*a)
        TCOMMON.set_activation_sharding(make_local_mesh(1, 4, "cpu"),
                                        ("data",))
        got = generate(model, sp_cfg, prompts, 10, max_t=40)
        _, caches = TLM.lm_prefill(model, sp_cfg,
                                   {"tokens": torch.from_numpy(prompts)}, 40)
        sp_logits, _ = TLM.lm_decode_step(model, caches, sp_cfg,
                                          got[:, :1])
    finally:
        TA._sp_decode_core = core
        TCOMMON.clear_activation_sharding()
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(calls) == tcfg.n_layers * 10
    _, caches = TLM.lm_prefill(model, tcfg,
                               {"tokens": torch.from_numpy(prompts)}, 40)
    plain, _ = TLM.lm_decode_step(model, caches, tcfg, got[:, :1])
    torch.testing.assert_close(sp_logits, plain, **TOL)


def test_sp_decode_falls_back_to_plain():
    """No mesh, a sliding-window ring, or a model axis that does not
    divide the cache: the plain path."""
    cfg = dataclasses.replace(smoke_config("qwen2-1.5b"), sp_decode=True)
    cache = TA.init_kv_cache(cfg, 1, 30, torch.float32, "cpu")
    assert TA._sp_shards(cfg, cache) == 0
    try:
        TCOMMON.set_activation_sharding(make_local_mesh(1, 4, "cpu"),
                                        ("data",))
        assert TA._sp_shards(cfg, cache) == 0                  # 30 % 4
        assert TA._sp_shards(cfg, TA.init_kv_cache(cfg, 1, 32,
                                                   torch.float32)) == 4
        ring = dataclasses.replace(cfg, window=16)
        assert TA._sp_shards(ring, TA.init_kv_cache(ring, 1, 32,
                                                    torch.float32)) == 0
    finally:
        TCOMMON.clear_activation_sharding()


# --- the train step on a mesh --------------------------------------------------

def test_train_step_on_local_mesh_equals_meshless_and_repro():
    """``make_train_step(mesh=make_local_mesh(1, 1), param_specs=…,
    microbatches=2)``: bit for bit the meshless step, and ``repro``'s step
    on its ``make_local_mesh(1, 1)`` with its specs within 1e-4."""
    import copy
    arch = "qwen2-1.5b"
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    ocfg = topt.OptConfig(lr=1e-2, warmup_steps=1)
    jocfg = jopt.OptConfig(**ocfg.__dict__)
    params = JLM.init_lm(jcfg, jax.random.PRNGKey(2))
    model = convert.lm_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    batch = jlm_batch(jcfg, 4, 32, 5)
    mesh = make_local_mesh(1, 1, "cpu")
    spec = tsh.param_specs(tsh.Rules(mesh, fsdp=True),
                           convert.param_shapes(tcfg, model))
    runs = []
    for m, s in ((mesh, spec), (None, None)):
        mod = copy.deepcopy(model)
        step = ttl.make_train_step(tcfg, ocfg, 2, mesh=m, param_specs=s)
        _, opt, metrics = step(mod, topt.init_opt_state(mod, ocfg), batch)
        runs.append((mod, opt, metrics))
    (a, oa, ma), (b, ob, mb) = runs
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(oa.m), tree_leaves(ob.m)))

    jm = jmesh.make_local_mesh(1, 1)
    jspec = jsh.param_specs(jsh.Rules(jm, fsdp=True), jax.eval_shape(
        lambda: params))
    jstep = jax.jit(jtl.make_train_step(jcfg, jocfg, 2, mesh=jm,
                                        param_specs=jspec))
    jp, _, jmet = jstep(params, jopt.init_opt_state(params, jocfg),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    for k in jmet:
        np.testing.assert_allclose(float(ma[k]), float(jmet[k]), **TOL)
    got = convert.lm_to_numpy(a, tcfg)
    for (path, g), (_, w) in zip(tree_flatten_with_path(got),
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=path, **TOL)


def test_train_step_mesh_checks():
    """A mesh over distinct devices raises at construction; a microbatch
    split that does not divide over the DP axes, or a spec that does not
    divide its parameter, at the first step."""
    cfg = smoke_config("qwen2-1.5b")
    ocfg = topt.OptConfig()
    far = Mesh(np.array([[torch.device("cpu"), torch.device("meta")]],
                        dtype=object), ("data", "model"))
    with pytest.raises(NotImplementedError, match="multi-card machine"):
        ttl.make_train_step(cfg, ocfg, mesh=far)
    model = TLM.init_lm(cfg, 0, "cpu")
    batch = jlm_batch(jsmoke_config("qwen2-1.5b"), 2, 16, 0)
    step = ttl.make_train_step(cfg, ocfg, 2,
                               mesh=make_local_mesh(2, 1, "cpu"))
    with pytest.raises(ValueError, match="DP shards"):
        step(model, topt.init_opt_state(model, ocfg), batch)
    mesh = make_local_mesh(1, 3, "cpu")
    tree = convert.param_shapes(cfg, model)
    bad = tsh.param_specs(tsh.Rules(make_local_mesh(1, 4, "cpu")), tree)
    step = ttl.make_train_step(cfg, ocfg, mesh=mesh, param_specs=bad)
    with pytest.raises(ValueError, match="does not divide"):
        step(model, topt.init_opt_state(model, ocfg), batch)


def test_launch_train_meshes(tmp_path):
    """``--mesh local`` trains with FSDP-off specs under ``--smoke`` and
    reports the per-device bytes; ``single`` and ``multi`` raise the
    device-count error."""
    res = tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--mesh", "local", "--ckpt-dir", str(tmp_path)])
    assert res["mesh"] == {"data": 1, "model": 1} and res["fsdp"] is False
    assert res["param_bytes_per_device"] == 4 * res["params"]
    for kind, shape in (("single", "(16, 16)"), ("multi", "(2, 16, 16)")):
        with pytest.raises(ValueError, match=re.escape(
                f"Number of devices 1 must be >= the product of mesh_shape "
                f"{shape}")):
            tlaunch.main(["--smoke", "--device", "cpu", "--mesh", kind,
                          "--ckpt-dir", str(tmp_path)])


# --- checkpoints ----------------------------------------------------------------

def test_elastic_restore_across_mesh(tmp_path):
    """tests/test_ckpt.py's case: an unsharded checkpoint (written by
    ``repro``) restores under a sharding, as tensors on its device; a
    spec that does not divide raises; ``CheckpointManager`` passes it
    on."""
    tree = {"w": jnp.arange(32, dtype=jnp.float32).reshape(8, 4),
            "i": jnp.arange(6, dtype=jnp.int32)}
    jckpt.save(str(tmp_path), 5, tree)
    mesh = make_local_mesh(1, 1, "cpu")
    target = {"w": tckpt.ArraySpec((8, 4), np.float32),
              "i": tckpt.ArraySpec((6,), np.int32)}
    shardings = {"w": tsh.NamedSharding(mesh, tsh.P("data", None)),
                 "i": tsh.NamedSharding(mesh, tsh.P("model"))}
    back = tckpt.restore(str(tmp_path), 5, target, shardings)
    assert isinstance(back["w"], torch.Tensor)
    np.testing.assert_array_equal(back["w"].numpy(), np.asarray(tree["w"]))
    assert back["i"].dtype == torch.int32
    step, again = tckpt.CheckpointManager(str(tmp_path)).restore(
        target, shardings)
    assert step == 5 and torch.equal(again["w"], back["w"])
    bad = dict(shardings, w=tsh.NamedSharding(make_local_mesh(3, 1, "cpu"),
                                              tsh.P("data", None)))
    with pytest.raises(ValueError, match="does not divide"):
        tckpt.restore(str(tmp_path), 5, target, bad)
    plain = tckpt.restore(str(tmp_path), 5, target)
    assert isinstance(plain["w"], np.ndarray)


# --- the roofline and the dry-runs ---------------------------------------------

def test_flop_counter_matches_analytic():
    """qwen2-1.5b's smoke config (full attention at S = 32): the forward
    counts 2 · tokens · (the matmul weights) plus, per layer, 4 · B · S² ·
    Hq · Dh for the scores and the probability-weighted values (the whole
    S × S square: the causal mask saves nothing); a train step with remat
    counts the layers 4× (forward, recompute, two backward products) but
    for each block's last product (``w_down``), which the recompute skips
    (``torch.utils.checkpoint`` stops once backward has what it saves),
    and the head 3×. Within 2%."""
    cfg = smoke_config("qwen2-1.5b")
    b, s = 4, 32
    d, hq, hkv, dh, ff, vocab = (cfg.d_model, cfg.n_heads, cfg.n_kv,
                                 cfg.head_dim, cfg.d_ff, cfg.vocab)
    layer = 2 * b * s * (d * hq * dh + 2 * d * hkv * dh + hq * dh * d
                         + 3 * d * ff) + 4 * b * s * s * hq * dh
    last = 2 * b * s * ff * d
    head = 2 * b * s * d * vocab
    model = TLM.init_lm(cfg, 0, "meta")
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    with torch.no_grad():
        fwd = roofline.count_step(TLM.lm_forward, model, cfg, batch)
    assert abs(fwd["flops"] / (cfg.n_layers * layer + head) - 1) < 0.02
    step = ttl.make_train_step(cfg, topt.OptConfig())
    train = roofline.count_step(step, model, topt.init_opt_state(
        model, topt.OptConfig()), batch)
    assert abs(train["flops"] / (cfg.n_layers * (4 * layer - last)
                                 + 3 * head) - 1) < 0.02
    assert train["saved_bytes"] > 0 and train["bytes"] > fwd["bytes"]


def test_byte_counter_rules():
    """Elementwise: inputs + output; views: nothing; a gather: indices and
    2× its rows; a scatter-like in-place write: its source twice."""
    x, y = torch.zeros(1000), torch.zeros(1000)
    assert roofline.count_step(torch.add, x, y)["bytes"] == 3 * 4000
    assert roofline.count_step(lambda: x.view(10, 100))["bytes"] == 0
    table = torch.zeros((100, 50))
    idx = torch.arange(10)
    assert roofline.count_step(lambda: table[idx])["bytes"] == \
        10 * 8 + 2 * 10 * 50 * 4
    src = torch.ones((10, 50))
    assert roofline.count_step(lambda: table.index_copy_(0, idx, src))[
        "bytes"] == 10 * 8 + 10 * 50 * 4 + 10 * 50 * 4


def test_collective_reckoning_and_links():
    """Split-K's merge against the KV all-gather it replaces, per the
    docstring's formulas (qwen2-1.5b decode_32k, single mesh, FSDP); an
    axis inside a node runs at NVLink's rate, one across nodes at
    InfiniBand's."""
    mesh = tmesh_of("single")
    rules = tsh.Rules(mesh, fsdp=True)
    cfg = dryrun.build_cfg("qwen2-1.5b", "serve")
    shape = SHAPES["decode_32k"]
    b, t = shape.global_batch, shape.seq_len
    ptree = convert.param_shapes(cfg, TLM.init_lm(cfg, 0, "meta"))
    caches = convert.caches_to_repro_tree(
        cfg, TLM.init_caches(cfg, b, t, device="meta"))
    specs = {"params": tsh.param_specs(rules, ptree),
             "caches": [tsh.cache_specs(rules, c, b) for c in caches]}
    shapes = {"params": ptree, "caches": caches}
    step = dict(batch=b, seq=t, act_bytes=2, n_heads=cfg.n_heads,
                head_dim=cfg.head_dim)
    plain = roofline.collective_bytes(rules, specs, shapes, "decode",
                                      dict(step, sp_decode=False))
    split = roofline.collective_bytes(rules, specs, shapes, "decode",
                                      dict(step, sp_decode=True))
    b_loc, n = b // 16, 16
    merge = cfg.n_layers * b_loc * cfg.n_heads * (cfg.head_dim + 2) * 4 \
        * (n - 1) / n
    kv = 2 * cfg.n_layers * b_loc * t * cfg.n_kv * cfg.head_dim * 2 \
        * (n - 1) / n
    assert split["all-reduce"]["model"] - plain["all-reduce"]["model"] == \
        pytest.approx(merge)
    assert plain["all-gather"]["model"] - split["all-gather"].get(
        "model", 0) == pytest.approx(kv)
    assert roofline.link_rate(mesh, "model") == roofline.IB_BYTES_PER_S
    assert roofline.link_rate(make_local_mesh(1, 8, "cpu"), "model") == \
        roofline.NVLINK_BYTES_PER_S
    assert roofline.link_rate(make_local_mesh(2, 8, "cpu"), "data") == \
        roofline.IB_BYTES_PER_S


def _jparams(arch, kind):
    cfg = jget_config(arch)
    if kind == "train":
        if arch in dryrun.BIG_TRAIN:
            cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    else:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16", remat=False)
    shapes = jax.eval_shape(lambda k: JLM.init_lm(cfg, k),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes))
    active = n
    if cfg.moe is not None:                 # repro.launch.dryrun's count
        expert = sum(int(np.prod(l.shape)) for p, l in
                     jax.tree_util.tree_flatten_with_path(shapes)[0]
                     if "moe" in jax.tree_util.keystr(p) and any(
                         w in jax.tree_util.keystr(p)
                         for w in (".w_gate", ".w_up", ".w_down")))
        active = n - expert + expert * cfg.moe.top_k // cfg.moe.n_experts
    return cfg, n, active


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen2-1.5b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
    ("mamba2-2.7b", "prefill_32k"), ("qwen2-1.5b", "long_500k")])
def test_dryrun_cells(tmp_path, arch, shape_name):
    """A dense train, a MoE decode and an SSM prefill cell on ``meta``:
    status ok, ``n_params``, ``n_active_params`` and the model FLOPs equal
    to ``repro``'s; a full-attention long_500k is skipped as ``runnable``
    says. The JSON lands in the output directory."""
    r = dryrun.run_cell(arch, shape_name, "single", str(tmp_path))
    assert json.loads((tmp_path / f"{arch}_{shape_name}_single.json")
                      .read_text())["status"] == r["status"]
    if shape_name == "long_500k":
        assert r["status"] == "skipped"
        return
    assert r["status"] == "ok", r.get("traceback")
    shape = JSHAPES[shape_name]
    jcfg, n, active = _jparams(arch, shape.kind)
    assert (r["n_params"], r["n_active_params"], r["n_chips"]) == \
        (n, active, 256)
    assert r["model_flops_global"] == jroofline.model_flops(
        jcfg, n, active, shape)
    c, t = r["counted"], r["roofline"]
    assert c["flops_per_chip"] > 0 and c["bytes_per_chip"] > 0
    assert r["useful_flops_ratio"] > 0
    assert t["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert r["memory"]["peak_estimate_bytes"] == sum(
        r["memory"][k] for k in ("argument_bytes", "output_bytes",
                                 "temp_bytes"))
    table = roofline_table.roofline_table(roofline_table.load(
        str(tmp_path)))
    assert f"| {arch} | {shape_name} |" in table


def test_linear_count_is_exact_in_depth():
    """Counting at one and two repeats and extrapolating gives the count
    at the config's own depth (smoke jamba: one segment of 8 kinds, 2
    repeats; qwen: 2 repeats)."""
    for arch in ("qwen2-1.5b", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(smoke_config(arch),
                                  segments=tuple((3, p) for _, p in
                                                 smoke_config(arch).segments))
        tokens = torch.empty((2, 16), dtype=torch.int32, device="meta")

        def run(c):
            m = TLM.init_lm(c, 0, "meta")
            with torch.no_grad():
                return roofline.count_step(TLM.lm_forward, m, c,
                                           {"tokens": tokens})
        assert dryrun.linear_count(cfg, run) == run(cfg)


def test_dryrun_ann_tiers_and_hop(tmp_path):
    """The LAION100M tiers from the shapes (76.8 GB of vectors, 440 GB of
    2-hop lists, ... over 256 cards: ~2.20 GB a card; PQ codes 3.2 GB,
    Bloom words 0.4 GB, bucket codes 0.2 GB replicated), one counted hop,
    and the record psum per hop."""
    tiers = dryrun_ann.tier_bytes(256)
    per_card = sum(tiers["sharded"].values())
    assert per_card * 256 == (76_800_000_000 + 38_400_000_000
                              + 440_000_000_000 + 6_400_000_000
                              + 800_000_000)
    assert round(per_card / 1e9, 2) == 2.20
    assert tiers["replicated"] == {"pq_codes": 3_200_000_000,
                                   "blooms": 400_000_000,
                                   "bucket_codes": 200_000_000}
    counts = dryrun_ann.count_hop()
    assert counts["hop"]["bytes"] > 0 and counts["hop"]["ops"] > 0
    r = dryrun_ann.run("multi", str(tmp_path), counts)
    assert r["status"] == "ok" and r["n_shards"] == 512
    assert r["counted"]["collective_bytes"]["all-reduce"] == pytest.approx(
        192 * 64 * dryrun_ann.record_bytes() * 511 / 512)
