"""Launchers and launch tooling of the port: ``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.launch.train``,
the mesh (``mesh``) and its sharding rules (``shardings``), the analytic
H100 roofline (``roofline``), and the ``meta``-device dry-runs
(``dryrun``, ``dryrun_ann``, ``roofline_table``). Counterpart of
``repro.launch``."""
