"""The decoder-only LM of the serving path: configs' building blocks
(attention, dense and MoE FFNs, Mamba-2), their composition into
:class:`~repro_torch.models.lm.TransformerLM`, prefill and KV-cache decode.
Counterpart of ``repro.models``; every computation is plain PyTorch (the
JAX package's is plain ``jnp``: no kernel of its own lies on this path)."""
