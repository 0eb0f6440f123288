"""Tree helpers. Counterpart of ``repro.utils``; ``repro.utils.compat``
holds jax version shims only and has no counterpart."""
