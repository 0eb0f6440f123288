"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``. Counterpart of ``repro.launch``'s
serving and training entry points."""
