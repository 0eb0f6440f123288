"""The port's LM serving path (``repro_torch.serve.decode``,
``repro_torch.launch.serve``) against the JAX package's on the CPU: greedy
and sampled generation token for token, the threefry keys and draws
under sampling, the launcher, and the RAG flow
of examples/rag_serve.py (filtered retrieval through ``RetrievalFrontend``
feeding ``generate``) with the JAX package's index and weights carried
across."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from repro import api as japi
from repro.api.session import SessionConfig as JSessionConfig
from repro.configs import smoke_config as jsmoke_config
from repro.models import lm as JLM
from repro.serve.decode import generate as jgenerate
from repro.serve.retrieval import RetrievalFrontend as JRetrievalFrontend
from repro_torch import api as tapi
from repro_torch import random as trandom
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert
from repro_torch.models import lm as TLM
from repro_torch.serve import RetrievalFrontend, generate
from repro_torch.serve.decode import make_decode_step, make_prefill, \
    sample_token
from torch_port_helpers import port_index


def lm_pair(jcfg, tcfg, seed=0):
    params = JLM.init_lm(jcfg, jax.random.PRNGKey(seed))
    return params, convert.lm_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b",
                                  "mixtral-8x22b"])
def test_greedy_generate_equals_repro(arch):
    """Prompts of 40 tokens (past mixtral's window of 32) and 12 new
    tokens: the same tokens from both packages."""
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    params, model = lm_pair(jcfg, tcfg, seed=5)
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab, (3, 40)).astype(np.int32)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompts), 12))
    got = generate(model, tcfg, prompts, 12)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_token_seeded_and_greedy_at_zero(seed):
    """Sampling under a key draws ``jax.random.categorical``'s tokens;
    temperature 0 (with or without a key) and a tiny one are greedy."""
    logits_np = np.random.default_rng(seed).normal(
        0, 1, (4, 1, 512)).astype(np.float32)
    logits = torch.from_numpy(logits_np)
    greedy = sample_token(logits)
    assert greedy.shape == (4, 1) and greedy.dtype == torch.int32
    assert torch.equal(greedy[:, 0], logits[:, -1].argmax(-1).int())
    key = trandom.PRNGKey(seed)
    assert torch.equal(sample_token(logits, key, 0.0), greedy)
    assert torch.equal(sample_token(logits, key, 1e-6), greedy)
    for temp in (0.7, 1.0, 1.3):
        want = jax.random.categorical(
            jax.random.PRNGKey(seed),
            jnp.asarray(logits_np[:, -1]) / temp, axis=-1)
        np.testing.assert_array_equal(
            sample_token(logits, key, temp).numpy()[:, 0], np.asarray(want))
    subkeys = trandom.split(key, 3)
    draws = [sample_token(logits, k, 1.0) for k in subkeys]
    assert not all(torch.equal(draws[0], d) for d in draws[1:])


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1])
def test_threefry_keys_and_bits_equal_jax(seed):
    """``PRNGKey``, ``split``, the bits and ``uniform`` equal jax's
    outright (partitionable threefry), over shapes of odd sizes."""
    kj, kt = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(
            trandom.split(kt, n).numpy(),
            np.asarray(jax.random.split(kj, n)).astype(np.int64))
    for shape in ((1,), (5,), (3, 7), (2, 3, 513)):
        np.testing.assert_array_equal(
            trandom.random_bits(kt, shape).numpy(),
            np.asarray(jax.random.bits(kj, shape, jnp.uint32))
            .astype(np.int64))
        np.testing.assert_array_equal(
            trandom.uniform(kt, shape).numpy(),
            np.asarray(jax.random.uniform(kj, shape)))
        np.testing.assert_array_equal(
            trandom.uniform(kt, shape, -2.5, 3.7).numpy(),
            np.asarray(jax.random.uniform(kj, shape, minval=-2.5,
                                          maxval=3.7)))


@pytest.mark.parametrize("seed", [0, 3, 123456789])
def test_gumbel_log_and_categorical_equal_jax(seed):
    """``gumbel``, the log under it and ``categorical`` equal jax's
    outright (XLA-CPU's log polynomial and fused multiply-adds)."""
    kj, kt = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    for shape in ((5,), (3, 7), (4, 4099)):
        np.testing.assert_array_equal(
            trandom.gumbel(kt, shape).numpy(),
            np.asarray(jax.random.gumbel(kj, shape)))
        logits = np.random.default_rng(seed).normal(
            0, 3, shape).astype(np.float32)
        np.testing.assert_array_equal(
            trandom.categorical(kt, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(kj, jnp.asarray(logits))))
    x = np.abs(np.random.default_rng(seed).normal(0, 40, 20000)) \
        .astype(np.float32) + np.float32(1e-30)
    np.testing.assert_array_equal(trandom.log(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.log(jnp.asarray(x))))


@pytest.mark.parametrize("temperature", [0.7, 1.3])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b",
                                  "mixtral-8x22b"])
def test_sampled_generate_equals_repro(arch, temperature):
    """Sampled generation from the same seed: the JAX package's tokens."""
    jcfg, tcfg = jsmoke_config(arch), smoke_config(arch)
    params, model = lm_pair(jcfg, tcfg, seed=6)
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab, (3, 20)).astype(np.int32)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompts), 10,
                                temperature=temperature, seed=11))
    got = generate(model, tcfg, prompts, 10, temperature=temperature,
                   seed=11)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, np.asarray(jgenerate(
        params, jcfg, jnp.asarray(prompts), 10)))


def test_generate_sampled_is_seeded():
    cfg = smoke_config("qwen2-1.5b")
    model = TLM.init_lm(cfg, seed=1, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 10))
    a = generate(model, cfg, prompts, 6, temperature=1.0, seed=3)
    b = generate(model, cfg, prompts, 6, temperature=1.0, seed=3)
    c = generate(model, cfg, prompts, 6, temperature=1.0, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    timings = {}
    d = generate(model, cfg, prompts, 6, temperature=1.0, seed=3,
                 timings=timings)
    assert torch.equal(a, d)
    assert timings["prefill_s"] > 0 and len(timings["step_s"]) == 5


def test_make_prefill_and_decode_step_match_generate():
    cfg = smoke_config("jamba-v0.1-52b")
    model = TLM.init_lm(cfg, seed=2, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 20)))
    logits, caches = make_prefill(cfg, 40)(model, {"tokens": prompts})
    step = make_decode_step(cfg)
    toks = [sample_token(logits)]
    for _ in range(4):
        logits, caches = step(model, caches, toks[-1])
        toks.append(sample_token(logits))
    assert torch.equal(torch.cat(toks, 1),
                       generate(model, cfg, prompts, 5, max_t=40))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-v0.1-52b"])
def test_launch_serve_main_on_cpu(arch, capsys):
    res = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "3", "--prompt-len", "12",
                        "--new-tokens", "5"])
    assert "[serve]" in capsys.readouterr().out
    cfg = smoke_config(arch)
    assert res["device"] == "cpu" and res["peak_bytes"] is None
    assert res["params"] == JLM.param_count(jsmoke_config(arch))
    assert res["param_bytes"] == 4 * res["params"]
    assert len(res["first_request"]) == 5
    assert res["prefill_s"] > 0 and res["decode_ms_per_token"] > 0
    assert res["torch_ops_per_step"] > 10 * cfg.n_layers
    # float32 compute: the step reads every weight but the embedding
    # (untied: a step gathers 3 of its rows) and the caches of T = 25
    d = cfg.d_model
    assert res["step_read_bytes"] > res["param_bytes"] - 4 * cfg.vocab * d


def test_launch_serve_max_repeat_cuts_depth():
    res = tlaunch.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device",
                        "cpu", "--requests", "1", "--prompt-len", "4",
                        "--new-tokens", "2", "--max-repeat", "1"])
    assert res["layers"] == 8


# --- the RAG flow of examples/rag_serve.py ---------------------------------

def embed_docs(docs: np.ndarray, d_embed: int, seed: int = 0) -> np.ndarray:
    """examples/rag_serve.py's stub embedding."""
    rng = np.random.default_rng(seed)
    vocab = int(docs.max()) + 1
    proj = rng.normal(0, 1 / np.sqrt(vocab), (vocab, d_embed))
    hist = np.zeros((len(docs), vocab), np.float32)
    for i, doc in enumerate(docs):
        np.add.at(hist[i], doc, 1.0)
    return (hist @ proj).astype(np.float32)


@pytest.fixture(scope="module")
def rag():
    rng = np.random.default_rng(0)
    n_docs, doc_len, vocab = 800, 24, 512
    docs = rng.integers(0, vocab, (n_docs, doc_len))
    topics = rng.integers(0, 8, n_docs)
    freshness = rng.uniform(0, 100, n_docs).astype(np.float32)
    metadata = [{"topic": int(t), "freshness": float(f)}
                for t, f in zip(topics, freshness)]
    jindex = japi.Index.build(
        embed_docs(docs, 32), metadata,
        japi.IndexConfig(r=16, r_dense=160, l_build=32, pq_m=8),
        defaults=japi.SearchConfig(k=4, l=24))
    queries = embed_docs(docs[rng.integers(0, n_docs, 6)], 32, seed=1)
    req_topics = [int(rng.integers(0, 8)) for _ in range(6)]
    return docs, topics, freshness, jindex, queries, req_topics


def test_rag_flow_matches_repro(rag):
    """Six requests under Tag ∧ Num, admitted to each package's frontend
    and flushed once: equal matches, every one inside its filter, and
    equal greedy tokens from the prompts built on them."""
    docs, topics, freshness, jindex, queries, req_topics = rag
    jcfg = dataclasses.replace(jsmoke_config("qwen2-1.5b"), vocab=512)
    tcfg = dataclasses.replace(smoke_config("qwen2-1.5b"), vocab=512)
    params, model = lm_pair(jcfg, tcfg)

    def serve(api, frontend_cls, session_cls, index):
        fe = frontend_cls(index, session_cls(max_batch=8, max_delay_s=10.0))
        handles = [fe.submit(queries[i], (api.Tag("topic") == t)
                             & api.Num("freshness").between(25.0, 90.0))
                   for i, t in enumerate(req_topics)]
        assert fe.flush() == len(handles)
        assert fe.session.n_batches == 1
        return [h.result() for h in handles]

    jres = serve(japi, JRetrievalFrontend, JSessionConfig, jindex)
    tres = serve(tapi, RetrievalFrontend, tapi.SessionConfig,
                 port_index(jindex))
    n_matches = 0
    for topic, j, t in zip(req_topics, jres, tres, strict=True):
        assert [m[0] for m in t.matches] == [m[0] for m in j.matches]
        np.testing.assert_allclose([m[1] for m in t.matches],
                                   [m[1] for m in j.matches],
                                   rtol=1e-6, atol=1e-6)
        assert all(topics[i] == topic and 25 <= freshness[i] < 90
                   for i, _, _ in t.matches)
        n_matches += len(t.matches)
        ctx = RetrievalFrontend.context_tokens(t, docs, per_doc=8)
        np.testing.assert_array_equal(
            ctx, JRetrievalFrontend.context_tokens(j, docs, per_doc=8))
        prompt = np.concatenate([ctx, docs[0][:8]])[None].astype(np.int32)
        want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt), 8))
        np.testing.assert_array_equal(
            generate(model, tcfg, prompt, 8).numpy(), want)
    assert n_matches > 0
