"""PyTorch/CUDA port of the asymmetric-GEMM serving system, for NVIDIA Hopper.

A second package beside the JAX reference (``repro``), mirroring its
module layout: ``core`` (blocking, schedulers, execution contexts,
control trees, device classes), ``kernels`` (the CUDA GEMM and paged
attention kernels with their plain PyTorch versions), ``models``,
``runtime`` (paging, the serving engine) and ``launch`` (the serving CLI).
It imports ``torch`` and never ``jax`` or ``repro``.
"""
