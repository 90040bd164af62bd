"""SGDRC's control plane on the host: tenancy, elastic compute multiplexing
(``compute``), the analytical cost model and the contention simulator the
offline controller searches with (``costmodel``, ``simulator``), the
offline plan search and the online tidal controller (``controller``), and
the colored arena of ``core.coloring``. These modules are copies of the
reference's (numpy and the standard library only). The interconnect model
and the PCIe scheduler (``interconnect``, ``pcie``) are not ported yet."""
from . import coloring, compute, controller, costmodel, simulator, tenancy
from .compute import ComputePolicy, ElasticMeshPartitioner, LoadSignal
from .controller import ResourcePlan, grid_search, memory_bound_ops
from .simulator import (DeviceSpec, GPU_DEVICES, GPUSimulator, Kernel,
                        SimResult, TPU_V5E, Tenant, apollo_like_trace,
                        poisson_trace, request_kernels)
from .tenancy import TenantRegistry, TenantSpec
