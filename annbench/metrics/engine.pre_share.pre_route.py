"""``engine.pre_share`` in the cells that report no end-to-end ``qps`` (the
``pre``-route cells): the same reading, under a name of its own."""
from annbench.harness import metric_reader

read = metric_reader("engine.pre_share")
