"""The kernel layer for Hopper: CUDA C++ in ``csrc/``, built by ``nvcc`` for
``sm_90a`` at first use, and each kernel's plain PyTorch version (``ref``).
``ops`` is the public API and dispatches: CUDA tensors launch the kernels,
CPU tensors take the plain versions. The CUDA wrappers live in
``decode_attention``, ``prefill_attention``, ``flash_attention``,
``dual_tenant_attention``, ``dual_tenant_matmul``, ``spt_gather`` and
``ssd_scan``.

Ported, all ten of the reference's kernels: decode_attention,
decode_attention_paged, prefill_attention, prefill_attention_paged,
flash_attention, dual_tenant_attention, dual_tenant_matmul, spt_gather,
spt_scatter and ssd_scan.
"""
from . import ops, ref
