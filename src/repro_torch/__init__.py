"""PyTorch/CUDA port of the SGDRC reproduction (``repro``), module for module.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it or JAX. Plain tensor code is PyTorch; every Pallas
kernel on the ported path is a CUDA C++ kernel for Hopper (``sm_90a``) under
``kernels/csrc``, built with ``nvcc`` at first use. Public entry points run
on CUDA unless the caller asks for the CPU (``torch_device="cpu"``), where
each kernel's plain PyTorch version runs instead.
"""
