"""TD-VMM integrate + readout: kernels B1/B2 (``tdvmm``), the public ops
(``ops``) and the plain oracle (``ref``)."""
