"""PyTorch / CUDA port of the TD-VMM system (the JAX package ``repro`` is the
reference it is tested against).

The layout mirrors ``repro``: ``configs/`` (a copy of the config layer),
``core/`` (codes, layers, calibration, energy), ``kernels/tdvmm/`` (the
hand-written Hopper kernels and their plain torch versions), ``models/``,
``runtime/`` (paged serving engine) and ``launch/`` (CLI).  Nothing here
imports JAX or the ``repro`` package.
"""
