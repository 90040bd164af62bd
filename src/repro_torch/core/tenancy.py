"""Tenant model: latency-sensitive (LS) vs best-effort (BE) inference tenants
with QoS weights — the unit of isolation for every SGDRC mechanism."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class TenantSpec:
    name: str
    priority: str                   # "LS" | "BE"
    nice: int = 1                   # PCIe CFS weight (larger = more bandwidth)
    sm_quota: float = 1.0           # fraction of compute partitions usable
    channels: tuple = ()            # VRAM channel ids assigned by the controller
    model: Optional[str] = None     # arch name from the registry
    batch_size: int = 1
    slo_ms: Optional[float] = None  # LS latency target

    @property
    def is_ls(self) -> bool:
        return self.priority == "LS"


@dataclass
class TenantRegistry:
    tenants: dict = field(default_factory=dict)

    def add(self, spec: TenantSpec):
        assert spec.name not in self.tenants, spec.name
        self.tenants[spec.name] = spec
        return spec

    def ls(self):
        return [t for t in self.tenants.values() if t.is_ls]

    def be(self):
        return [t for t in self.tenants.values() if not t.is_ls]

    def __getitem__(self, name):
        return self.tenants[name]

    def __iter__(self):
        return iter(self.tenants.values())
