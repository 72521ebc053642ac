"""The yardstick's table of peaks: NVIDIA's data-sheet rates for one H100
SXM (dense, without sparsity), at its full 700 W power limit.  Copied here
so that a change to the program cannot move what its rooflines and MFU are
measured against.  A card set below 700 W runs slower under load: every
result line carries the card's ``power.limit`` beside these numbers.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100": {
        "int8": 1979e12,        # TOP/s, tensor cores
        "fp8": 1979e12,
        "bfloat16": 989e12,     # FLOP/s, tensor cores
        "float16": 989e12,
        "tf32": 495e12,
        "float32": 67e12,       # outside the tensor cores
        "hbm_bytes_s": 3.35e12,
        "hbm_bytes": 80e9,
    },
}


def for_device(name: str) -> dict:
    """The peaks of the card named ``name`` (``torch.cuda.get_device_name``);
    raises for a card the table does not hold, so no share is ever read
    against another card's peaks."""
    for key, peaks in PEAKS.items():
        if name.startswith(key):
            return peaks
    raise KeyError(f"no data-sheet peaks for {name!r}")
