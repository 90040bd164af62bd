"""Tenancy and resource plans: the pieces of ``repro.core`` the serving
engine needs (the controller's search and the simulator are not ported)."""
from .controller import ResourcePlan
from .tenancy import TenantRegistry, TenantSpec
