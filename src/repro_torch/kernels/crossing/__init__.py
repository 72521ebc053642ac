"""The latch threshold-crossing solver: kernel B4, its wrapper and its plain
version (``crossing``), the sort-based exact oracle (``ref``) and the
readout over the [0, 2T] window (``ops``)."""
