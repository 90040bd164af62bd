"""Attention kernels for Hopper (CUDA C++ in ``csrc/``, built by ``nvcc``
for ``sm_90a`` at first use) and their plain PyTorch versions (``ref``).
``ops`` dispatches: CUDA tensors launch the kernels, CPU tensors take the
plain versions; the CUDA wrappers live in ``decode_attention`` and
``prefill_attention``.

Ported: decode_attention, decode_attention_paged, prefill_attention,
prefill_attention_paged. The reference's other Pallas kernels
(flash_attention, dual_tenant_attention, dual_tenant_matmul,
spt_gather/spt_scatter, ssd_scan) are not ported yet.
"""
from . import ops, ref
