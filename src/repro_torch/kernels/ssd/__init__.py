"""Mamba-2 SSD chunked scan: kernel B3, its wrapper and its plain version
(``ssd``), and the token-by-token oracle (``ref``)."""
