"""Launchers of the port: ``python -m repro_torch.launch.serve`` serves
tenants through the engine (module docstring there)."""
