"""SGDRC's control plane on the host: tenancy, elastic compute multiplexing
(``compute``), the analytical cost model and the contention simulator the
offline controller searches with (``costmodel``, ``simulator``), the
offline plan search and the online tidal controller (``controller``), the
PCIe bus model and its completely fair scheduler (``pcie``, which the host
KV tier logs its copies against), the colored arena of
``core.coloring``, and the multi-device link model the disaggregated
engine ships KV page groups over (``interconnect``). These modules are
copies of the reference's (numpy and the standard library only), except
the MLP hash fit of ``core.coloring``, which trains with torch."""
from . import (coloring, compute, controller, costmodel, interconnect, pcie,
               simulator, tenancy)
from .compute import ComputePolicy, ElasticMeshPartitioner, LoadSignal
from .controller import ResourcePlan, grid_search, memory_bound_ops
from .interconnect import (Flow, FlowCompletion, InterconnectSim, Link,
                           Topology, ring_allgather_flows)
from .simulator import (DeviceSpec, GPU_DEVICES, GPUSimulator, Kernel,
                        SimResult, TPU_V5E, Tenant, apollo_like_trace,
                        poisson_trace, request_kernels)
from .tenancy import TenantRegistry, TenantSpec
