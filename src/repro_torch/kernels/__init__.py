"""Hand-written Hopper kernels (CUDA C++ under ``*/csrc``), each beside its
plain torch version: B1/B2 in ``tdvmm``, B3 in ``ssd``, B4 in ``crossing``."""


def build_all(verbose: bool = False) -> float:
    """Build every kernel library of the port, one ``nvcc`` per source, all
    started together; returns the seconds spent."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.crossing import crossing
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.tdvmm import tdvmm
    return _build.build([*tdvmm.LIBRARIES.values(), *ssd.LIBRARIES.values(),
                         *crossing.LIBRARIES.values()], verbose)
