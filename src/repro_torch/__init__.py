"""PyTorch / CUDA port of the TD-VMM system (the JAX package ``repro`` is the
reference it is tested against).

The layout mirrors ``repro``: ``configs/`` (a copy of the config layer),
``core/`` (codes, layers, calibration, energy, the circuit simulator),
``kernels/`` (the hand-written Hopper kernels and their plain torch
versions), ``models/``, ``optim/``, ``data/``, ``checkpoint/`` (training),
``runtime/`` (paged serving engine, fault helpers) and ``launch/`` (CLI:
serving, training, the perceptron).  Nothing here imports JAX or the
``repro`` package.
"""
