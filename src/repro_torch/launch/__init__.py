"""Launchers of the port: ``python -m repro_torch.launch.serve`` serves
tenants through the engine, ``python -m repro_torch.launch.train`` trains
a model, ``python -m repro_torch.launch.dryrun`` traces a step on a fake
production mesh (module docstrings there)."""
from .mesh import make_mesh, make_production_mesh
