"""Serving entry points: prefill + decode step builders, generation loop.
Counterpart of ``repro.serve.decode``."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


def make_prefill(cfg: ModelConfig, max_t: int):
    @torch.inference_mode()
    def prefill(params, batch):
        return lm.lm_prefill(params, cfg, batch, max_t)
    return prefill


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def step(params, caches, tokens):
        return lm.lm_decode_step(params, caches, cfg, tokens)
    return step


def sample_token(logits, key: Optional[torch.Tensor] = None,
                 temperature: float = 0.0):
    """logits: (B, 1, V) -> (B, 1) int32. Greedy when temperature == 0
    (the lower index on ties, as ``jnp.argmax``); otherwise a draw from
    ``softmax(logits / temperature)`` under ``key`` (a
    :func:`repro_torch.random.PRNGKey` key), equal to
    ``jax.random.categorical``'s."""
    if temperature <= 0.0:
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    scaled = logits[:, -1].float() / temperature
    return R.categorical(key, scaled, axis=-1).to(torch.int32)[:, None]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: lm.TransformerLM, cfg: ModelConfig, prompt_tokens,
             n_new: int, temperature: float = 0.0, seed: int = 0,
             max_t: Optional[int] = None,
             timings: Optional[dict] = None) -> torch.Tensor:
    """Batched generation: prefill the prompt, decode n_new tokens.
    Returns (B, n_new) int32 on the model's device.

    ``prompt_tokens`` (B, S) may be numpy or a tensor; it goes to the
    model's device. The weights are cast once to the compute dtype
    (:func:`~repro_torch.models.lm.cast_for_compute`), which gives the
    values of a cast at every use. Sampling starts from ``PRNGKey(seed)``
    and splits the key before every decode step, as the JAX package does,
    so sampled tokens equal its tokens. With a ``timings``
    dict, the device is synchronised after the prefill and after each
    step, and ``timings["prefill_s"]`` (prefill and the first token) and
    ``timings["step_s"]`` (one entry a decode step) are filled in."""
    dev = params.embed.device
    tokens = torch.as_tensor(np.asarray(prompt_tokens) if not isinstance(
        prompt_tokens, torch.Tensor) else prompt_tokens).to(dev)
    b, s = tokens.shape
    max_t = max_t or (s + n_new + 8)
    params = lm.cast_for_compute(params)
    prefill = make_prefill(cfg, max_t)
    step = make_decode_step(cfg)
    key = R.PRNGKey(seed, device=dev)
    clock = time.perf_counter
    if timings is not None:
        _sync(dev)
        t0 = clock()
    logits, caches = prefill(params, {"tokens": tokens})
    out = [sample_token(logits, key, temperature)]
    if timings is not None:
        _sync(dev)
        timings["prefill_s"] = clock() - t0
        timings["step_s"] = []
    for _ in range(n_new - 1):
        if timings is not None:
            t0 = clock()
        key, sub = R.split(key)
        logits, caches = step(params, caches, out[-1])
        out.append(sample_token(logits, sub, temperature))
        if timings is not None:
            _sync(dev)
            timings["step_s"].append(clock() - t0)
    return torch.cat(out, dim=1)
