from .bus import (PACKET, BusSpec, Completion, CopyRequest,
                  closed_loop_requests, poisson_requests, summarize)
from .cfs import PCIeCFS
from .schedulers import Baymax, MultiStream, StreamBox
from .autotune import autotune_cfs_period, saturated_throughput

SCHEDULERS = {
    "cfs": PCIeCFS,
    "baymax": Baymax,
    "streambox": StreamBox,
    "multistream": MultiStream,
}
