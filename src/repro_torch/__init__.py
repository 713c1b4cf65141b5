"""PyTorch/CUDA port of the SpecEE decode path (counterpart of ``repro``).

Imports ``torch`` and numpy only — never JAX, never the ``repro`` package.
Its hand-written CUDA kernels live in ``csrc/`` and are built at first use
(``repro_torch.kernels.build``).
"""
