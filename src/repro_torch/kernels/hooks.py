"""A hook on every kernel wrapper's call, for counting tools.

Each wrapper of kernels B1-B4 (``tdvmm.tdvmm_matmul_raw``, ``tdvmm_fused``,
``tdvmm_calibrated``, ``ssd.ssd_scan``, ``crossing.crossing_kernel``) runs
its body inside ``call(kernel, **geometry)``, on either route: the kernel
on the card, the plain version on the CPU, or, for a fake tensor (the dry
run, ``launch.dryrun``), only the output's allocation: a fake tensor takes
the card's route at every device branch of the port (``card_route``),
whatever its device (the dry run's are on the CPU: Python indexing of a
fake CUDA tensor needs a torch built with CUDA).  ``kernel`` is the
wrapper's launch-counter key (``tdvmm.LAUNCHES``' "raw", "fused_int4",
...; "ssd"; "crossing").  With no hook installed ``call`` does nothing;
``launch.roofline.StepCounter`` installs one that counts the call by its
geometry, as one launch, and leaves out the ops inside it.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import is_fake

HOOK = None


@contextlib.contextmanager
def call(kernel: str, **geometry):
    if HOOK is None:
        yield
        return
    with HOOK(kernel, geometry):
        yield


def card_route(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route: a CUDA tensor, or a fake one
    (shapes only: a wrapper then allocates its output and returns before
    any launch)."""
    return t.device.type == "cuda" or is_fake(t)
