"""The port's LM modules (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's (``repro.models``, ``repro.configs``) on the same
seeded numpy inputs, the JAX weights carried across with
``convert.lm_from_numpy``: float32 at rtol = atol = 1e-4; MoE routing,
dropped assignments and parameter counts exactly."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JMOE
import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.configs import registry as jreg
from repro.configs import smoke_config as jsmoke_config
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import lm as JLM
from repro.models import mlp as JM
from repro.models import ssm as JS
from repro.models.common import ModelConfig as JModelConfig
from repro.models.common import MoEConfig as JMoEConfig
from repro_torch.configs import registry as treg
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import convert
from repro_torch.models import lm as TLM
from repro_torch.models import mlp as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TS
from repro_torch.models.common import ModelConfig as TModelConfig
from repro_torch.models.common import MoEConfig as TMoEConfig

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_ARCHS = ["qwen2-7b", "mamba2-2.7b", "jamba-v0.1-52b", "mixtral-8x22b"]


def close(got, want):
    """A port tensor (or numpy array) against a JAX array."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def tt(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def group(cls, nt):
    """A port parameter group from a JAX ``NamedTuple`` of arrays."""
    return cls(**{f: None if getattr(nt, f) is None else tt(getattr(nt, f))
                  for f in cls.FIELDS})


def both(arch: str):
    """The smoke config of ``arch`` in each package."""
    return jsmoke_config(arch), treg.smoke_config(arch)


def lm_pair(arch: str, seed: int):
    """(JAX config, port config, JAX params, port model on the CPU)."""
    jcfg, tcfg = both(arch)
    params = JLM.init_lm(jcfg, jax.random.PRNGKey(seed))
    model = convert.lm_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, model


def smoke_batch(cfg, b=2, s=32, seed=0) -> dict:
    """tests/test_models_smoke.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frame_embeds": rng.normal(0, 1, (b, s, cfg.d_model))
                .astype(np.float32),
                "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        p = cfg.vision_prefix
        return {"patch_embeds": rng.normal(0, 1, (b, p, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (b, s - p))
                .astype(np.int32),
                "targets": rng.integers(0, cfg.vocab, (b, s - p))
                .astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def same_caches(tcfg, got, want):
    """Port caches against the JAX package's stacked caches."""
    got = convert.caches_to_numpy(tcfg, got)
    for gseg, wseg in zip(got, want, strict=True):
        for gblk, wblk in zip(gseg, wseg, strict=True):
            assert gblk.keys() == wblk.keys()
            for name in gblk:
                for g, w in zip(gblk[name], wblk[name], strict=True):
                    assert g.shape == np.asarray(w).shape
                    if g.dtype.kind == "i":
                        np.testing.assert_array_equal(g, np.asarray(w))
                    else:
                        close(g, w)


# --- configs ---------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_configs_match_repro(arch):
    assert treg.list_archs() == list_archs()
    for jget, tget in ((jget_config, treg.get_config),
                       (jsmoke_config, treg.smoke_config)):
        j, t = jget(arch), tget(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.sub_quadratic, j.layer_kinds) == (t.sub_quadratic,
                                                    t.layer_kinds)
    for name, shape in jreg.SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(treg.SHAPES[name])
        assert jreg.runnable(jget_config(arch), shape) == \
            treg.runnable(treg.get_config(arch), treg.SHAPES[name])


@pytest.mark.parametrize("arch", list_archs())
def test_param_count_and_input_specs_full_config(arch):
    """Full configs, shapes only: the port builds on the meta device."""
    jcfg, tcfg = jget_config(arch), treg.get_config(arch)
    assert TLM.param_count(tcfg) == JLM.param_count(jcfg)
    meta = TLM.init_lm(tcfg, device="meta")
    assert all(p.device.type == "meta" for p in meta.parameters())
    for name, shape in jreg.SHAPES.items():
        want = jreg.input_specs(jcfg, shape)
        got = treg.input_specs(tcfg, treg.SHAPES[name])
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype)


# --- shared ops, MLPs ------------------------------------------------------

def test_rms_norm_and_rotary_match_repro():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 8, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, (64,)).astype(np.float32)
    close(TC.rms_norm(tt(x), tt(scale), 1e-5),
          JC.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    q = rng.normal(0, 1, (2, 8, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 8)).astype(np.int32)
    for theta in (1e4, 1e6):
        close(TC.rotary_embed(tt(q), tt(pos), theta),
              JC.rotary_embed(jnp.asarray(q), jnp.asarray(pos), theta))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "starcoder2-7b"])
def test_mlp_matches_repro(arch):
    """SwiGLU (qwen) and the tanh-form GELU (starcoder2)."""
    jcfg, tcfg = both(arch)
    p = JM.init_mlp(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(1).normal(0, 1, (2, 16, 64)).astype(np.float32)
    close(TM.mlp_forward(group(TM.MLPParams, p), tt(x), tcfg),
          JM.mlp_forward(p, jnp.asarray(x), jcfg))


# --- attention -------------------------------------------------------------

def _attn(arch, seed, s, b=2, **changes):
    jcfg, tcfg = both(arch)
    jcfg = dataclasses.replace(jcfg, **changes)
    tcfg = dataclasses.replace(tcfg, **changes)
    p = JA.init_attn(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    return jcfg, tcfg, p, group(TA.AttnParams, p), x, pos


def test_full_and_blockwise_attention_match_repro():
    jcfg, tcfg, jp, tp, x, pos = _attn("qwen2-1.5b", 0, 32, attn_chunk_q=8,
                                       attn_chunk_kv=8)
    jq = JA._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    tq = TA._project_qkv(tp, tt(x), tcfg, tt(pos))
    for g, w in zip(tq, jq):
        close(g, w)
    close(TA.full_attention(*tq, tcfg), JA.full_attention(*jq, jcfg))
    close(TA.blockwise_attention(*tq, tcfg),
          JA.blockwise_attention(*jq, jcfg))


def test_blockwise_attention_windowed_matches_repro():
    jcfg, tcfg, jp, tp, x, pos = _attn("mixtral-8x22b", 1, 64, b=1,
                                       attn_chunk_q=8, attn_chunk_kv=8,
                                       window=12)
    jq = JA._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    tq = TA._project_qkv(tp, tt(x), tcfg, tt(pos))
    close(TA.blockwise_attention(*tq, tcfg),
          JA.blockwise_attention(*jq, jcfg))
    close(TA.full_attention(*tq, tcfg), JA.full_attention(*jq, jcfg))


@pytest.mark.parametrize("arch,s,window", [
    ("qwen2-1.5b", 20, 0),          # fill the first s rows of T = 28
    ("mixtral-8x22b", 40, 32),      # past the window: the ring fold
    ("mixtral-8x22b", 20, 32),      # inside the window
    ("mixtral-8x22b", 80, 0)])      # blockwise prefill (s > threshold 64)
def test_prefill_cache_fill_matches_repro(arch, s, window):
    jcfg, tcfg, jp, tp, x, _ = _attn(arch, 2, s, window=window)
    max_t = 28 if s < 28 else s
    jc0 = JA.init_kv_cache(jcfg, 2, max_t, jnp.float32)
    tc0 = TA.init_kv_cache(tcfg, 2, max_t, torch.float32)
    jout, jc = JA.attention_forward(jp, jnp.asarray(x), jcfg, cache=jc0)
    tout, tc = TA.attention_forward(tp, tt(x), tcfg, cache=tc0)
    close(tout, jout)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    assert int(tc.pos) == int(jc.pos) == s


@pytest.mark.parametrize("window,prefix", [(8, 5), (0, 5)])
def test_decode_attention_matches_repro(window, prefix):
    """Twelve decode steps after a prefill: across the ring (window 8:
    slots reused from step 4 on) and into a full cache."""
    jcfg, tcfg, jp, tp, x, _ = _attn("mixtral-8x22b", 3, prefix,
                                     window=window)
    max_t = prefix + 12
    _, jc = JA.attention_forward(jp, jnp.asarray(x), jcfg,
                                 cache=JA.init_kv_cache(jcfg, 2, max_t,
                                                        jnp.float32))
    _, tc = TA.attention_forward(tp, tt(x), tcfg,
                                 cache=TA.init_kv_cache(tcfg, 2, max_t,
                                                        torch.float32))
    step = jax.jit(functools.partial(JA.decode_attention, cfg=jcfg))
    rng = np.random.default_rng(4)
    for _ in range(12):
        xt = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
        jout, jc = step(jp, jnp.asarray(xt), jc)
        tout, tc = TA.decode_attention(tp, tt(xt), tc, tcfg)
        close(tout, jout)
        close(tc.k, jc.k)
        close(tc.v, jc.v)
        assert int(tc.pos) == int(jc.pos)


# --- MoE -------------------------------------------------------------------

def _moe_cfgs(cf=8.0, group_size=64):
    """tests/test_moe.py's config, in each package."""
    kw = dict(name="t", n_layers=1, d_model=32, n_heads=4, n_kv=2,
              head_dim=8, d_ff=48, vocab=64, segments=((1, ("attn_moe",)),),
              param_dtype="float32", compute_dtype="float32")
    moe = dict(n_experts=4, top_k=2, capacity_factor=cf,
               group_size=group_size)
    return (JModelConfig(moe=JMoEConfig(**moe), **kw),
            TModelConfig(moe=TMoEConfig(**moe), **kw))


def _moe_inputs(seed, shape=(2, 32, 32)):
    jcfg, _ = _moe_cfgs()
    p = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return p, group(TMOE.MoEParams, p), x


@pytest.mark.parametrize("cf", [0.3, 8.0])
def test_moe_routing_and_drops_equal_repro(cf, monkeypatch):
    """Expert ids, kept assignments and capacity slots equal exactly (one
    dispatch group); outputs and aux losses within tolerance."""
    jcfg, tcfg = _moe_cfgs(cf)
    jp, tp, x = _moe_inputs(0)
    seen = {}
    top_k = jax.lax.top_k

    def capture_top_k(v, k):
        out = top_k(v, k)
        seen.setdefault("idx", np.asarray(out[1]))
        return out

    def capture_disp(a, *kinds):
        seen.setdefault("disp", np.asarray(a))
        return a

    monkeypatch.setattr(jax.lax, "top_k", capture_top_k)
    monkeypatch.setattr(JMOE, "constrain_dims", capture_disp)
    jout, jaux = JMOE.moe_forward(jp, jnp.asarray(x), jcfg)
    monkeypatch.undo()
    tout, taux = TMOE.moe_forward(tp, tt(x), tcfg)

    c = TMOE._capacity(tcfg.moe, 64)
    assert c == JMOE._capacity(jcfg.moe, 64)
    _, _, _, idx, oh, within, pos_c = TMOE._route(tp, tt(x), tcfg.moe, c)
    np.testing.assert_array_equal(idx.numpy(), seen["idx"])
    disp = seen["disp"]                                # (B, S, k, E, C)
    np.testing.assert_array_equal(within.numpy(), disp.sum(-1) > 0)
    np.testing.assert_array_equal(pos_c.numpy(),
                                  disp.argmax(-1) * (disp.sum(-1) > 0))
    assert (int(oh.sum() - within.sum()) > 0) == (cf < 1.0)
    close(tout, jout)
    for k in ("lb_loss", "z_loss", "drop_frac"):
        close(taux[k], jaux[k])


def test_moe_chunked_matches_repro():
    """group 16 over s = 32: two dispatch groups, aux averaged over them."""
    jcfg, tcfg = _moe_cfgs(0.5, group_size=16)
    jp, tp, x = _moe_inputs(5)
    jout, jaux = JMOE.moe_forward(jp, jnp.asarray(x), jcfg)
    tout, taux = TMOE.moe_forward(tp, tt(x), tcfg)
    close(tout, jout)
    for k in jaux:
        close(taux[k], jaux[k])


def test_moe_fsplit_matches_repro(monkeypatch):
    """Both packages with each expert's d_ff split in 3 (as
    tests/test_moe.py patches it): equal to each other and to the
    unsplit port."""
    jcfg, tcfg = _moe_cfgs()
    jp, tp, x = _moe_inputs(1, (2, 16, 32))
    base, _ = TMOE.moe_forward(tp, tt(x), tcfg)
    monkeypatch.setattr(JMOE, "_f_split", lambda e, f: 3)
    monkeypatch.setattr(TMOE, "_f_split", lambda e, f: 3)
    jout, _ = JMOE.moe_forward(jp, jnp.asarray(x), jcfg)
    tout, _ = TMOE.moe_forward(tp, tt(x), tcfg)
    close(tout, jout)
    close(tout, base.numpy())


# --- SSM -------------------------------------------------------------------

@pytest.mark.parametrize("t", [40, 2])
def test_ssm_forward_with_state_and_decode_match_repro(t):
    """t = 40: chunks of 16 with 8 padded positions; t = 2: shorter than
    the conv's ring (its tail padded). Then five decode steps."""
    jcfg, tcfg = both("mamba2-2.7b")
    jp = JS.init_ssm(jax.random.PRNGKey(6), jcfg)
    tp = group(TS.SSMParams, jp)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, t, 64)).astype(np.float32)
    jout, jst = JS.ssm_forward(jp, jnp.asarray(x), jcfg, return_state=True)
    tout, tst = TS.ssm_forward(tp, tt(x), tcfg, return_state=True)
    close(tout, jout)
    close(TS.ssm_forward(tp, tt(x), tcfg), jout)
    for g, w in zip(tst, jst, strict=True):
        close(g, w)
    step = jax.jit(functools.partial(JS.ssm_decode, cfg=jcfg))
    for _ in range(5):
        xt = rng.normal(0, 1, (2, 1, 64)).astype(np.float32)
        jout, jst = step(jp, jnp.asarray(xt), jst)
        tout, tst = TS.ssm_decode(tp, tt(xt), tst, tcfg)
        close(tout, jout)
        for g, w in zip(tst, jst, strict=True):
            close(g, w)


# --- the whole LM ----------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_lm_forward_and_loss_match_repro(arch):
    jcfg, tcfg, params, model = lm_pair(arch, 0)
    batch = smoke_batch(jcfg)
    (jlogits, jaux), (jtotal, jmetrics) = jax.jit(
        lambda p, b: (JLM.lm_forward(p, jcfg, b), JLM.lm_loss(p, jcfg, b)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: tt(v) for k, v in batch.items()}
    tlogits, taux = TLM.lm_forward(model, tcfg, tbatch)
    assert tlogits.shape == (2, 32, tcfg.vocab)
    close(tlogits, jlogits)
    close(model(tbatch)[0], jlogits)
    ttotal, tmetrics = TLM.lm_loss(model, tcfg, tbatch)
    close(ttotal, jtotal)
    assert tmetrics.keys() == jmetrics.keys()
    for k in jmetrics:
        close(tmetrics[k], jmetrics[k])
    for k in jaux:
        close(taux[k], jaux[k])


@pytest.mark.parametrize("arch,s,prefix,seed", [
    *[(a, 24, 16, 2) for a in DECODE_ARCHS],
    ("mixtral-8x22b", 48, 40, 4)])   # past the window of 32: the ring
def test_prefill_and_decode_match_repro(arch, s, prefix, seed):
    """Prefill logits and caches, then every decode step's logits, and the
    caches after the last step, against the JAX package's."""
    jcfg, tcfg, params, model = lm_pair(arch, seed)
    tokens = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab, (2, s)).astype(np.int32)
    max_t = s + 8
    jl, jc = JLM.lm_prefill(params, jcfg,
                            {"tokens": jnp.asarray(tokens[:, :prefix])},
                            max_t=max_t)
    tl, tc = TLM.lm_prefill(model, tcfg, {"tokens": tt(tokens[:, :prefix])},
                            max_t)
    close(tl, jl)
    same_caches(tcfg, tc, jc)
    step = jax.jit(lambda p, c, t: JLM.lm_decode_step(p, c, jcfg, t))
    for i in range(prefix, s):
        jl, jc = step(params, jc, jnp.asarray(tokens[:, i:i + 1]))
        tl, tc2 = TLM.lm_decode_step(model, tc, tcfg,
                                     tt(tokens[:, i:i + 1]))
        assert tc2 is tc                   # updated in place
        close(tl, jl)
    same_caches(tcfg, tc, jc)
    # and the JAX caches carried into the port decode on from there
    tc = convert.caches_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    jl, _ = step(params, jc, jnp.asarray(tokens[:, :1]))
    tl, _ = TLM.lm_decode_step(model, tc, tcfg, tt(tokens[:, :1]))
    close(tl, jl)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_init_caches_match_repro(arch):
    """Zeroed caches: the same shapes, dtypes and zeros per layer (the
    window caps mixtral's T at 32)."""
    jcfg, tcfg = both(arch)
    same_caches(tcfg, TLM.init_caches(tcfg, 2, 40, device="cpu"),
                JLM.init_caches(jcfg, 2, 40))


def test_cast_for_compute_shares_and_keeps_leaves():
    """bfloat16 compute: the cast copy holds bfloat16 leaves except the
    SSM's float32 and conv leaves, shares leaves already in the compute
    dtype and leaves the original alone; its forward equals the uncast
    model's."""
    cfg = dataclasses.replace(treg.smoke_config("jamba-v0.1-52b"),
                              compute_dtype="bfloat16")
    model = TLM.init_lm(cfg, seed=3, device="cpu")
    cast = TLM.cast_for_compute(model)
    kept = set()
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 cast.named_parameters(), strict=True):
        assert p.dtype == torch.float32
        if q.dtype == torch.float32:
            kept.add(name.rsplit(".", 1)[1])
            assert q is p
        else:
            assert q.dtype == torch.bfloat16
            assert torch.equal(q, p.to(torch.bfloat16))
    assert kept == {"conv_x", "conv_x_b", "conv_bc", "conv_bc_b", "a_log",
                    "dt_bias", "d_skip"}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)))
    with torch.inference_mode():
        a, _ = TLM.lm_forward(model, cfg, {"tokens": tokens})
        b, _ = TLM.lm_forward(cast, cfg, {"tokens": tokens})
    assert torch.equal(a, b)
