"""Launchers of the port: ``python -m repro_torch.launch.serve`` serves
tenants through the engine, ``python -m repro_torch.launch.train`` trains
a model (module docstrings there)."""
