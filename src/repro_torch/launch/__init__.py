"""Launchers of the port: ``python -m repro_torch.launch.serve``.
Counterpart of ``repro.launch``'s serving entry point."""
