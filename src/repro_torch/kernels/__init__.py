"""Hand-written Hopper kernels (CUDA C++ under ``*/csrc``), each beside its
plain torch version."""
