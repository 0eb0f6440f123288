"""The port's LM training path (``repro_torch.train``, ``data.tokens``,
``data.pipeline``, ``utils.tree``, ``launch.train``) against the JAX
package's on the CPU: the token stream equal outright, the prefetcher and
watchdog, int8 moments and AdamW, gradients and train steps (one and two
microbatches) on weights carried across by ``lm_from_numpy``, the int8
error-feedback reduction against ``repro``'s under ``jax.vmap``, training
checkpoints restored both ways, and the fault-tolerant launcher."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import list_archs as jlist_archs
from repro.configs import smoke_config as jsmoke_config
from repro.data.tokens import lm_batch as jlm_batch
from repro.models import lm as JLM
from repro.train import grad_compress as jgc
from repro.train import optim as jopt
from repro.train import train_loop as jtl
from repro.utils import tree as jtree
from repro_torch.ckpt import ArraySpec, CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import Prefetcher, StepWatchdog
from repro_torch.data.tokens import lm_batch
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TMOE
from repro_torch.models.common import ModelConfig, MoEConfig
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optim as topt
from repro_torch.train import train_loop as ttl
from repro_torch.utils import tree as ttree

TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_ARCHS = ["qwen2-1.5b", "mamba2-2.7b", "mixtral-8x22b",
               "jamba-v0.1-52b"]


def jparams(jcfg, seed=0):
    return JLM.init_lm(jcfg, jax.random.PRNGKey(seed))


def port_model(tcfg, params):
    return convert.lm_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def leaves_close(got_tree, want_tree, **tol):
    """Two trees in ``repro``'s layout: the same keystr paths, leaves
    within ``tol``."""
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = ttree.tree_flatten_with_path(got_tree)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   err_msg=path, **tol)


# --- data ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "musicgen-medium",
                                  "internvl2-2b"])
def test_lm_batch_equal_outright(arch):
    """The none, audio and vision frontends, over steps and shards."""
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    for step, shard, n_shards in ((0, 0, 1), (3, 1, 2), (17, 0, 4)):
        want = jlm_batch(jcfg, 3, 40, step, shard, n_shards)
        got = lm_batch(tcfg, 3, 40, step, shard, n_shards)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_prefetcher_ordered_and_deterministic():
    cfg = smoke_config("qwen2-1.5b")
    pf = Prefetcher(lambda s: lm_batch(cfg, 2, 16, s), start_step=3,
                    prefetch=2)
    got = []
    for step, batch in pf:
        got.append((step, batch["tokens"].copy()))
        if len(got) == 4:
            break
    pf.stop()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, toks in got:
        np.testing.assert_array_equal(
            toks, jlm_batch(jsmoke_config("qwen2-1.5b"), 2, 16, s)["tokens"])


def test_batches_differ_across_steps_and_shards():
    cfg = smoke_config("qwen2-1.5b")
    a = lm_batch(cfg, 2, 16, step=1, shard=0)
    b = lm_batch(cfg, 2, 16, step=2, shard=0)
    c = lm_batch(cfg, 2, 16, step=1, shard=1, n_shards=2)
    assert not np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_motif_stream_is_learnable_structure():
    cfg = smoke_config("qwen2-1.5b")
    b = lm_batch(cfg, 1, 100, step=0, motif_len=16)
    stream = np.concatenate([b["tokens"][0], b["targets"][0][-1:]])
    assert np.array_equal(stream[:16], stream[16:32])


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=5.0, warmup=3)
    for i in range(5):
        wd.start()
        time.sleep(0.01)
        wd.stop(i)
    wd.start()
    time.sleep(0.2)                    # straggler
    assert wd.stop(5)
    assert len(wd.flagged) == 1


# --- trees -----------------------------------------------------------------

def test_tree_helpers_equal_repro():
    """A training state's paths in ``jax.tree_util``'s order (Q8's
    ``last`` is no leaf) and ``tree_bytes``/``tree_count_params``/
    ``tree_cast``/``tree_zeros_like`` as ``repro.utils.tree``'s."""
    arch = "qwen2-1.5b"
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    params = jparams(jcfg)
    state = {"params": params,
             "opt": jopt.init_opt_state(params, jopt.OptConfig(
                 int8_moments=True))}
    model = port_model(tcfg, params)
    host = ttl.train_state_tree(tcfg, model, topt.init_opt_state(
        model, topt.OptConfig(int8_moments=True)))
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    assert [p for p, _ in ttree.tree_flatten_with_path(host)] == want
    assert ttree.tree_bytes(host) == jtree.tree_bytes(state)
    assert ttree.tree_count_params(host) == jtree.tree_count_params(state)
    assert ttree.tree_count_params(model) == jtree.tree_count_params(params)
    assert ttree.tree_bytes(model) == jtree.tree_bytes(params)
    half = ttree.tree_cast(model, torch.float16)
    assert all(x.dtype == torch.float16 for x in ttree.tree_leaves(half))
    assert all(int(x.count_nonzero()) == 0
               for x in ttree.tree_leaves(ttree.tree_zeros_like(model)))
    rebuilt = ttree.tree_unflatten(host, ttree.tree_leaves(host))
    assert [p for p, _ in ttree.tree_flatten_with_path(rebuilt)] == want


# --- optimizer -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128,), (7, 130), (3, 4, 257), (100,),
                                   ()])
def test_q8_quantize_equal(shape):
    x = np.random.default_rng(len(shape)).normal(0, 2.0, shape) \
        .astype(np.float32)
    want = jopt.q8_quantize(jnp.asarray(x))
    got = topt.q8_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.last == want.last
    np.testing.assert_array_equal(topt.q8_dequantize(got).numpy(),
                                  np.asarray(jopt.q8_dequantize(want)))


def test_lr_schedule_and_global_norm_equal():
    cfg = topt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    jcfg = jopt.OptConfig(**cfg.__dict__)
    for s in range(0, 120, 3):
        np.testing.assert_allclose(
            float(topt.lr_at(torch.tensor(s, dtype=torch.int32), cfg)),
            float(jopt.lr_at(jnp.asarray(s, jnp.int32), jcfg)),
            rtol=1e-6, atol=1e-6)
    tree = _toy_tree(1)
    np.testing.assert_allclose(
        float(topt.global_norm(_torch_tree(tree))),
        float(jopt.global_norm(tree)), rtol=1e-6)


def _toy_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (32, 48)).astype(np.float32),
            "b": rng.normal(0, 0.1, (48,)).astype(np.float32),
            "nested": {"u": rng.normal(0, 1, (17, 5)).astype(np.float32)}}


def _torch_tree(tree):
    return ttree.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_update_equal(int8):
    """Three AdamW steps fed the same numpy gradients: parameters within
    1e-6; float32 moments within rtol 1e-6, atol 1e-8 (XLA fuses the
    moment updates into fused multiply-adds); int8 moments' ``q`` within
    ±1 at rounding ties."""
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         clip_norm=5.0, int8_moments=int8)
    jcfg = jopt.OptConfig(**cfg.__dict__)
    params = _toy_tree(0)
    jp, js = params, jopt.init_opt_state(params, jcfg)
    tp = _torch_tree(params)
    ts = topt.init_opt_state(tp, cfg)
    for step in range(3):
        grads = ttree.tree_map(lambda x: x * (3.0 - step), _toy_tree(step + 5))
        jp, js, jm = jopt.adamw_update(grads, jp, js, jcfg)
        tp, ts, tm = topt.adamw_update(_torch_tree(grads), tp, ts, cfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        leaves_close(tp, jp, rtol=1e-6, atol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        for tmom, jmom in ((ts.m, js.m), (ts.v, js.v)):
            if int8:
                for t, j in zip(topt._moment_leaves(tmom),
                                jax.tree_util.tree_leaves(
                                    jmom, is_leaf=lambda x: isinstance(
                                        x, jopt.Q8))):
                    dq = np.abs(t.q.numpy().astype(int)
                                - np.asarray(j.q).astype(int))
                    assert dq.max() <= 1
                    np.testing.assert_allclose(t.scale.numpy(),
                                               np.asarray(j.scale),
                                               rtol=1e-6, atol=1e-12)
            else:
                leaves_close(tmom, jmom, rtol=1e-6, atol=1e-8)


def _quad_loss(params, x):
    y = torch.tanh(x @ params["w"]) + params["b"]
    z = y[:, :5] @ params["nested"]["u"].T
    return torch.mean(z ** 2)


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_converges(int8):
    """tests/test_optim.py's problem (its jax.random draws, as numpy)."""
    cfg = topt.OptConfig(lr=3e-2, warmup_steps=5, total_steps=200,
                         weight_decay=0.0, int8_moments=int8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = _torch_tree({"w": jax.random.normal(k1, (32, 48)),
                          "b": jnp.zeros((48,)),
                          "nested": {"u": jax.random.normal(k2, (17, 5))}})
    state = topt.init_opt_state(params, cfg)
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (64, 32))))
    leaves = ttree.tree_leaves(params)
    losses = []
    for _ in range(100):
        for p in leaves:
            p.requires_grad_(True)
        loss = _quad_loss(params, x)
        grads = ttree.tree_unflatten(params,
                                     torch.autograd.grad(loss, leaves))
        params, state, _ = topt.adamw_update(grads, params, state, cfg)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])


def test_q8_roundtrip_accuracy_and_leading_shape():
    rng = np.random.default_rng(0)
    for shape in [(128,), (7, 130), (3, 4, 257), (100,)]:
        x = torch.from_numpy(rng.normal(0, 2.0, shape).astype(np.float32))
        back = topt.q8_dequantize(topt.q8_quantize(x))
        assert back.shape == x.shape
        tol = float(x.abs().max()) / 127 * 1.01
        assert float((back - x).abs().max()) <= tol + 1e-6
    q = topt.q8_quantize(torch.ones((5, 6, 200)))
    assert q.q.shape[:2] == (5, 6) and q.q.shape[-1] % topt.QBLOCK == 0
    assert q.scale.shape == (5, 6, q.q.shape[-1] // topt.QBLOCK)


def test_grad_clip():
    cfg = topt.OptConfig(lr=1e-3, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = topt.init_opt_state(params, cfg)
    new_params, state, metrics = topt.adamw_update(
        {"w": torch.full((4,), 100.0)}, params, state, cfg)
    assert float(metrics["grad_norm"]) > 1.0
    assert bool((new_params["w"].abs() < 2 * cfg.lr).all())


def test_lr_schedule_shape():
    cfg = topt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    lrs = [float(topt.lr_at(torch.tensor(s), cfg)) for s in range(0, 100, 5)]
    assert lrs[0] < 0.2
    assert max(lrs) <= 1.0 + 1e-6
    assert lrs[-1] < 0.35
    assert abs(lrs[2] - 1.0) < 0.1


# --- gradients and train steps --------------------------------------------

@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_equal_repro(arch):
    """``lm_loss`` and every gradient leaf against
    ``jax.value_and_grad``, with one and with two microbatches (the
    JAX package's accumulation: the halves' gradients summed in float32,
    then halved)."""
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    params = jparams(jcfg, 1)
    model = port_model(tcfg, params)
    batch = jlm_batch(jcfg, 4, 32, 2)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JLM.lm_loss(p, jcfg, b), has_aux=True))

    def jgrads(b):
        (loss, metrics), g = vg(params, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        return loss, metrics, g

    half = {k: v[:2] for k, v in batch.items()}
    loss, metrics, grads = ttl.loss_and_grads(model, tcfg, half)
    jloss, jmetrics, jg = jgrads(half)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert metrics.keys() == jmetrics.keys()
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL)
    leaves_close(convert.to_repro_tree(
        tcfg, {k: g.numpy() for k, g in grads.items()}), jg, **TOL)

    loss2, metrics2, grads2 = ttl.loss_and_grads(model, tcfg, batch, 2)
    rest = jgrads({k: v[2:] for k, v in batch.items()})
    jg2 = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, jg, rest[2])
    np.testing.assert_allclose(float(loss2), float(jloss + rest[0]) / 2,
                               **TOL)
    assert metrics2 == {}
    leaves_close(convert.to_repro_tree(
        tcfg, {k: g.numpy() for k, g in grads2.items()}), jg2, **TOL)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("int8", [False, True])
def test_train_step_equal_repro(microbatches, int8):
    """One ``make_train_step`` step on qwen2-1.5b: loss, ``grad_norm``,
    ``lr``, the parameters and the moments against the JAX package's
    jitted step."""
    arch = "qwen2-1.5b"
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    ocfg = topt.OptConfig(lr=1e-2, warmup_steps=1, int8_moments=int8)
    jocfg = jopt.OptConfig(**ocfg.__dict__)
    params = jparams(jcfg, 2)
    model = port_model(tcfg, params)
    batch = jlm_batch(jcfg, 4, 32, 5)
    jstep = jax.jit(jtl.make_train_step(jcfg, jocfg, microbatches))
    jp, jo, jm = jstep(params, jopt.init_opt_state(params, jocfg),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    step = ttl.make_train_step(tcfg, ocfg, microbatches)
    model, opt, metrics = step(model, topt.init_opt_state(model, ocfg),
                               batch)
    assert metrics.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **TOL)
    leaves_close(convert.lm_to_numpy(model, tcfg), jp, **TOL)
    state = ttl.train_state_tree(tcfg, model, opt)["opt"]
    assert int(state.step) == int(jo.step) == 1
    if int8:
        for t, j in zip(
                ttree.tree_leaves(state.m, is_leaf=lambda x: isinstance(
                    x, topt.Q8)),
                jax.tree_util.tree_leaves(jo.m, is_leaf=lambda x: isinstance(
                    x, jopt.Q8))):
            assert np.abs(t.q.astype(int) - np.asarray(j.q)).max() <= 1
    else:
        leaves_close(state.m, jo.m, **TOL)
        leaves_close(state.v, jo.v, rtol=1e-4, atol=1e-8)


def test_train_many_equal_repro():
    arch = "mamba2-2.7b"
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    ocfg = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jocfg = jopt.OptConfig(**ocfg.__dict__)
    params = jparams(jcfg, 3)
    model = port_model(tcfg, params)
    batches = [jlm_batch(jcfg, 2, 32, s) for s in range(3)]
    _, _, jhist = jtl.train_many(
        params, jopt.init_opt_state(params, jocfg),
        jtl.make_train_step(jcfg, jocfg),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    _, _, hist = ttl.train_many(model, topt.init_opt_state(model, ocfg),
                                ttl.make_train_step(tcfg, ocfg), batches)
    assert [h.keys() for h in hist] == [h.keys() for h in jhist]
    for h, j in zip(hist, jhist):
        for k in j:
            np.testing.assert_allclose(h[k], j[k], **TOL)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_grad_flows_through_router():
    cfg = ModelConfig(
        name="t", n_layers=1, d_model=32, n_heads=4, n_kv=2, head_dim=8,
        d_ff=48, vocab=64, segments=((1, ("attn_moe",)),),
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=8.0,
                      group_size=64),
        param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator().manual_seed(7)
    p = TMOE.init_moe(gen, cfg).requires_grad_(True)
    x = torch.randn((1, 16, 32), generator=gen)
    out, aux = TMOE.moe_forward(p, x, cfg)
    (torch.sum(out ** 2) + aux["lb_loss"]).backward()
    assert float(p.w_router.grad.abs().sum()) > 0.0
    assert float(p.w_gate.grad.abs().sum()) > 0.0


@pytest.mark.parametrize("arch", jlist_archs())
def test_train_step_no_nans(arch):
    cfg = smoke_config(arch)
    model = TLM.init_lm(cfg, 1, "cpu")
    batch = lm_batch(cfg, 2, 32, 1)
    loss, _, grads = ttl.loss_and_grads(model, cfg, batch)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert 0.5 * np.log(cfg.vocab) < float(loss) < 2.5 * np.log(cfg.vocab)


def test_remat_recomputes_and_keeps_gradients():
    """``cfg.remat`` changes no gradient; without grad recording (the
    serving path) the forward runs as it did."""
    cfg = smoke_config("jamba-v0.1-52b")
    model = TLM.init_lm(cfg, 4, "cpu")
    batch = lm_batch(cfg, 2, 32, 4)
    _, _, on = ttl.loss_and_grads(model, cfg, batch)
    _, _, off = ttl.loss_and_grads(
        model, dataclasses.replace(cfg, remat=False), batch)
    for k in on:
        torch.testing.assert_close(on[k], off[k], rtol=1e-6, atol=1e-7)
    with torch.inference_mode():
        logits, _ = TLM.lm_forward(model, cfg, {
            "tokens": torch.as_tensor(batch["tokens"])})
    assert logits.shape == (2, 32, cfg.vocab)


# --- int8 error-feedback reduction ----------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4])
def test_compressed_psum_grads_equal_repro(shards):
    """S shards' gradients and error states against ``repro``'s function
    under ``jax.vmap(axis_name="data")``, over two steps of feedback."""
    rng = np.random.default_rng(shards)
    mk = [[{"a": rng.normal(0, 1, (7, 300)).astype(np.float32),
            "b": rng.normal(0, 5, (5,)).astype(np.float32),
            "c": {"d": rng.normal(0, 0.1, (2, 3, 129)).astype(np.float32)}}
           for _ in range(shards)] for _ in range(2)]
    fn = jax.jit(jax.vmap(
        lambda g, e: jgc.compressed_psum_grads(g, e, "data"),
        axis_name="data"))
    je = jax.tree_util.tree_map(
        lambda x: jnp.zeros((shards,) + x.shape, jnp.float32), mk[0][0])
    te = [tgc.init_error_feedback(_torch_tree(g)) for g in mk[0]]
    for step_grads in mk:
        jg = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *step_grads)
        jmean, je = fn(jg, je)
        tmean, te = tgc.compressed_psum_grads(
            [_torch_tree(g) for g in step_grads], te)
        for s in range(shards):
            leaves_close(tmean, jax.tree_util.tree_map(lambda x: x[s], jmean),
                         rtol=1e-6, atol=1e-6)
            leaves_close(te[s], jax.tree_util.tree_map(lambda x: x[s], je),
                         rtol=1e-6, atol=1e-6)


# --- checkpoints and the launcher -----------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_training_checkpoint_restores_both_ways(tmp_path, int8):
    """A training state saved by the JAX package restores into the port's
    model and optimizer, and the port's save restores in the JAX
    package, with equal leaves and keystr paths."""
    arch = "mixtral-8x22b"
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    ocfg = topt.OptConfig(int8_moments=int8)
    jocfg = jopt.OptConfig(**ocfg.__dict__)
    params = jparams(jcfg, 4)
    model = port_model(tcfg, params)
    batch = jlm_batch(jcfg, 2, 32, 1)
    jstep = jax.jit(jtl.make_train_step(jcfg, jocfg))
    jp, jo, _ = jstep(params, jopt.init_opt_state(params, jocfg),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    jstate = {"params": jp, "opt": jo}
    JCheckpointManager(str(tmp_path / "j"), async_write=False).save(
        1, jstate)

    fresh = TLM.init_lm(tcfg, 9, "cpu")
    opt = topt.init_opt_state(fresh, ocfg)
    target = ttree.tree_map(lambda x: ArraySpec(x.shape, x.dtype),
                            ttl.train_state_tree(tcfg, fresh, opt))
    step, tree = CheckpointManager(str(tmp_path / "j")).restore(target)
    opt = ttl.load_train_state(tcfg, tree, fresh, opt)
    assert step == 1 and int(opt.step) == 1
    host = ttl.train_state_tree(tcfg, fresh, opt)
    leaves_close(host, jax.tree_util.tree_map(np.asarray, jstate),
                 rtol=0, atol=0)

    CheckpointManager(str(tmp_path / "t"), async_write=False).save(1, host)
    jtarget = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    jstep_n, back = JCheckpointManager(str(tmp_path / "t")).restore(jtarget)
    assert jstep_n == 1
    leaves_close(host, back, rtol=0, atol=0)


def _launch(tmp, *extra):
    return tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--device",
                         "cpu", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp), *extra])


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    """3 steps, then a resumed run to 5; and a 6-step run whose step 5
    fails once ends with the parameters of an uninterrupted run."""
    first = _launch(tmp_path / "a", "--steps", "3", "--ckpt-every", "2")
    assert first["final_step"] == 3 and first["resumed_at"] == 0
    assert len(first["losses"]) == 3
    assert all(np.isfinite(first["losses"]))
    assert first["peak_bytes"] is None and first["device"] == "cpu"
    assert first["step_flops"] == 8 * first["params"] * 64
    second = _launch(tmp_path / "a", "--steps", "5", "--ckpt-every", "2")
    assert second["resumed_at"] == 3 and second["loss_steps"] == [3, 4]
    assert "resumed at step 3" in capsys.readouterr().out

    whole = _launch(tmp_path / "b", "--steps", "6", "--ckpt-every", "2")
    drill = _launch(tmp_path / "c", "--steps", "6", "--ckpt-every", "2",
                    "--fail-at-step", "5")
    assert drill["retries"] == 1 and drill["final_step"] == 6
    assert drill["losses"] == whole["losses"]
    for (n, p), (_, q) in zip(whole["params_module"].named_parameters(),
                              drill["params_module"].named_parameters()):
        assert torch.equal(p, q), n


def test_launch_train_refuses_mesh_and_counts_ops(tmp_path):
    with pytest.raises(ValueError, match="Number of devices 1 must be >= "
                                         "the product of mesh_shape"):
        _launch(tmp_path, "--mesh", "single")
    cfg = smoke_config("qwen2-1.5b")
    deep = dataclasses.replace(cfg, segments=((6, ("attn_mlp",)),),
                               n_layers=6)
    assert tlaunch.count_step_ops(deep, 2, 32) > \
        tlaunch.count_step_ops(cfg, 2, 32) > 100 * cfg.n_layers
