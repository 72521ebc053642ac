"""Roofline terms of one rank's step on an NVIDIA H100 — the port's
counterpart of ``repro.launch.roofline``.

The JAX module parses the optimized XLA HLO of a compiled step; a torch
step has no such program, so the port counts the step as it runs, one
rank of it, under ``StepCounter`` (a ``TorchDispatchMode``):

  * FLOPs of every product (``torch.utils.flop_counter``'s formulas), by
    operand class: bf16 / f16 at the bf16 tensor-core peak, int8 at the
    int8 peak, float32 at the TF32 peak (``PEAKS``);
  * the port's kernels (B1 / B2 / B3 and B4) counted at their wrappers
    (``kernels.hooks``), with the formulas of ``chip_smoke.py``'s bound
    column (``kernel_cost``), one launch each; the ops inside a wrapper
    (its plain version on the CPU) are not counted again;
  * HBM bytes: each op's tensor inputs plus outputs.  In eager mode one op
    is about one kernel, as one top-level HLO instruction is one kernel in
    the JAX module's convention; views, allocations and collectives move
    none, and an in-place write of rows into a buffer (a cache update)
    moves its rows twice, as the JAX module counts a dynamic-update-slice;
    a host constant copied to the device moves no HBM bytes;
  * collective wire bytes: each collective's result bytes times the JAX
    module's factor (all-reduce 2, others 1), over the rate of the link
    its group crosses: NVLink within a node of ``H100_NODE_GPUS`` ranks
    (row-major rank order), InfiniBand across nodes;
  * the live bytes the step allocates (each storage from its first op to
    its release), whose peak the dry run adds to the step's arguments, and
    what is live at that peak by the op and dtype that made it
    (``peak_by_op``).

``RooflineTerms`` has the JAX module's fields and ``as_dict`` keys, its
times on the H100's data-sheet peaks: compute is the sum over operand
classes of FLOPs / peak, collective the sum over links of bytes / rate.
``model_flops`` is the JAX module's.  Every number here is a static
estimate from data-sheet peaks, not a measurement.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import constants as C
from repro_torch.kernels import hooks

PEAKS = {"bf16": C.H100_BF16_FLOPS, "int8": C.H100_INT8_OPS,
         "f32": C.H100_TF32_FLOPS}
LINKS = {"nvlink": C.H100_NVLINK_BW, "ib": C.H100_IB_BW}
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}
_C10D = (("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
         ("allgather", "all-gather"), ("alltoall", "all-to-all"),
         ("send", "collective-permute"), ("recv", "collective-permute"),
         ("broadcast", "collective-permute"))
# in-place writes of a few rows into a large buffer: the rows move (read
# and written), not the buffer (the JAX module's dynamic-update-slice)
_SCATTER = {"index_put_", "index_copy_", "scatter_", "masked_scatter_",
            "index_fill_"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "detach",
         "alias", "lift_fresh", "_local_scalar_dense", "set_", "resize_",
         "_to_copy_fake"}


def _class(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "f32"


def kernel_cost(kernel: str, g: dict) -> tuple[float, str, float]:
    """(FLOPs, operand class, HBM bytes) of one kernel call of geometry
    ``g``, as ``chip_smoke.py`` bounds it: B1 / B2 read their codes once
    (int4 as packed pairs, float32 as 4 bytes) with their scales and
    windows and write float32 (or int32) once, 2 E M K N products at the
    int8 rate for integer codes, the bf16 rate for "f32" codes and three
    TF32 products for "f32x3"; B3 its inputs and y / state once, its
    causal chunk products at the TF32 rate; B4 its operands and times
    once, the 3xTF32 product t_on . I."""
    if kernel == "ssd":
        b, l, h, p, gr, s = (g[f] for f in "blhpgs")
        q = min(g["q"], l)
        elt = g["elt"]
        nbytes = (2 * b * l * h * p * elt + 4 * b * l * h
                  + 2 * b * l * gr * s * elt + 4 * h + 4 * b * h * p * s)
        nc = -(-l // q)
        flops = (b * gr * nc * q * (q + 1) * s
                 + b * h * nc * (q * (q + 1) * p + 4 * q * p * s))
        return float(flops), "f32", float(nbytes)
    if kernel == "crossing":
        b, k, n = g["b"], g["k"], g["n"]
        return 6.0 * b * k * n, "f32", 4.0 * (b * k + k * n + b * n)
    e, ex, m, k, n, codes = (g[f] for f in ("e", "ex", "m", "k", "n",
                                            "codes"))
    kb = (k + 1) // 2 if codes == "int4" else k
    cb = 4 if codes.startswith("f32") else 1
    nbytes = cb * (ex * m * kb + e * kb * n) + 4 * e * m * n
    if g["scales"]:
        nbytes += 4 * (ex * m + e * n)
    if g["readout"]:
        nbytes += 4 * e
    flops = 2.0 * e * m * k * n
    if codes == "f32x3":
        return 3 * flops, "f32", float(nbytes)
    return flops, ("bf16" if codes == "f32" else "int8"), float(nbytes)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _host_copy(func, args, out) -> bool:
    """A host tensor copied to the device (a constant: it crosses the host
    link, not HBM), or into the dry run's fake tensors."""
    from torch._subclasses.fake_tensor import is_fake
    if func.overloadpacket.__name__ != "_to_copy" or not args:
        return False
    src = args[0]
    return (isinstance(src, torch.Tensor) and not is_fake(src)
            and src.device.type == "cpu"
            and (is_fake(out) or out.device.type != "cpu"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Count one rank's step (see the module docstring).  Use as a context
    manager around the step; read ``flops``, ``hbm_bytes`` (and by op or
    kernel, ``bytes_by_op``), ``coll``, ``coll_links``, ``launches``,
    ``peak_bytes`` and ``peak_by_op`` after it, or ``summary()``."""

    def __init__(self, node_gpus: int = C.H100_NODE_GPUS):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop = flop_registry
        self.node_gpus = node_gpus
        self.flops = {c: 0.0 for c in PEAKS}
        self.hbm_bytes = 0.0
        self.bytes_by_op: dict[str, float] = {}
        self.coll = {k: 0.0 for k in WIRE_FACTOR}
        self.coll_links = {k: 0.0 for k in LINKS}
        self.launches: dict[str, int] = {}
        self.live = 0
        self.peak_bytes = 0
        self._live_by: dict[str, int] = {}
        self._peak_by: dict[str, int] = {}
        self._at_peak = False
        self._inside = 0
        from torch.utils.weak import WeakIdKeyDictionary
        self._storages = WeakIdKeyDictionary()
        self._links: dict = {}

    # -- kernel wrappers --------------------------------------------------
    @contextlib.contextmanager
    def _kernel(self, kernel: str, geometry: dict):
        if self._inside:                 # a wrapper inside a wrapper
            yield
            return
        flops, cls, nbytes = kernel_cost(kernel, geometry)
        self.flops[cls] += flops
        self.hbm_bytes += nbytes
        self.bytes_by_op[kernel] = self.bytes_by_op.get(kernel, 0.0) + nbytes
        self.launches[kernel] = self.launches.get(kernel, 0) + 1
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def __enter__(self):
        self._old_hook = hooks.HOOK
        hooks.HOOK = self._kernel
        return super().__enter__()

    def __exit__(self, *a):
        hooks.HOOK = self._old_hook
        return super().__exit__(*a)

    def known(self, *trees) -> None:
        """Storages that exist before the step (its arguments): an op that
        writes them in place allocates nothing."""
        for t in _tensors(list(trees)):
            st = t.untyped_storage()
            self._storages[st] = st.nbytes()

    # -- every op ------------------------------------------------------
    def _track(self, out, op: str) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            key = f"{op} {str(t.dtype).removeprefix('torch.')}"
            self.live += n
            self._live_by[key] = self._live_by.get(key, 0) + n
            if self.live > self.peak_bytes:
                self.peak_bytes = self.live
                self._at_peak = True
            weakref.finalize(st, self._free, n, key)

    def _free(self, n: int, key: str) -> None:
        if self._at_peak:               # leaving a peak: keep what it held
            self._peak_by = {k: v for k, v in self._live_by.items() if v}
            self._at_peak = False
        self.live -= n
        self._live_by[key] -= n

    @property
    def peak_by_op(self) -> dict[str, int]:
        """The bytes live at the peak, by the op and dtype that made them,
        largest first."""
        by = self._peak_by
        if self._at_peak:
            by = {k: v for k, v in self._live_by.items() if v}
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))

    def _link(self, pg) -> str:
        if pg not in self._links:
            ranks = dist.get_process_group_ranks(pg)
            nodes = {r // self.node_gpus for r in ranks}
            self._links[pg] = "nvlink" if len(nodes) == 1 else "ib"
        return self._links[pg]

    def _collective(self, func, args, kwargs, out) -> None:
        name = func.__name__ if hasattr(func, "__name__") else str(func)
        kind = next(k for key, k in _C10D if key in name)
        schema = func._schema.arguments
        pg = None
        for i, a in enumerate(schema):
            if a.name == "process_group":
                v = args[i] if i < len(args) else kwargs.get(a.name)
                pg = v if isinstance(v, dist.ProcessGroup) else \
                    dist.ProcessGroup.unbox(v)
        # result bytes: the first argument is the output (a list for
        # all-gather, in place for all-reduce)
        nbytes = sum(_nbytes(t) for t in _tensors(args[0] if args else ()))
        wire = nbytes * WIRE_FACTOR[kind]
        self.coll[kind] += wire
        if pg is not None:
            self.coll_links[self._link(pg)] += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track(out, func.overloadpacket.__name__)
        if self._inside:
            return out
        ns = func.namespace
        if ns == "prim":                 # metadata queries (``.device``)
            return out
        if ns == "c10d":
            self._collective(func, args, kwargs, out)
            return out
        if func.is_view or func.overloadpacket.__name__ in _FREE \
                or _host_copy(func, args, out):
            return out
        packet = func.overloadpacket
        if packet in self._flop:
            a = next(_tensors(args), None)
            cls = _class(a.dtype) if a is not None else "f32"
            # a product with an output dtype (``mm.dtype``) takes two
            # operands
            operands = args[:2] if func._overloadname == "dtype" else args
            self.flops[cls] += float(self._flop[packet](
                *operands, out_val=out))
        if packet.__name__ in _SCATTER:
            nbytes = 2.0 * sum(_nbytes(t) for t in _tensors(args[1:]))
        else:
            nbytes = float(sum(_nbytes(t) for t in _tensors(args))
                           + sum(_nbytes(t) for t in _tensors(out)))
        if nbytes:
            self.hbm_bytes += nbytes
            name = str(func)
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nbytes
        return out

    def summary(self) -> dict:
        return {"flops_by_class": dict(self.flops),
                "flops": sum(self.flops.values()),
                "hbm_bytes": self.hbm_bytes,
                "bytes_by_op": dict(sorted(self.bytes_by_op.items())),
                "collective_bytes": dict(self.coll,
                                         total=sum(self.coll.values())),
                "collective_bytes_by_link": dict(self.coll_links),
                "kernel_launches": dict(sorted(self.launches.items())),
                "peak_step_bytes": self.peak_bytes}


@dataclasses.dataclass
class RooflineTerms:
    """The JAX module's terms on the H100: ``flops_by_class`` (operand
    class -> FLOPs) and ``coll_bytes_by_link`` (link -> wire bytes) give
    the times; without them all FLOPs go at the bf16 peak and all bytes
    at the InfiniBand rate."""
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float
    flops_by_class: Optional[dict] = None
    coll_bytes_by_link: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        if self.flops_by_class is None:
            return self.flops_per_device / C.H100_BF16_FLOPS
        return sum(f / PEAKS[c] for c, f in self.flops_by_class.items())

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / C.H100_HBM_BW

    @property
    def t_collective(self) -> float:
        if self.coll_bytes_by_link is None:
            return self.coll_bytes_per_device / C.H100_IB_BW
        return sum(b / LINKS[k] for k, b in self.coll_bytes_by_link.items())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        t = self.step_time_lower_bound
        if t <= 0:
            return 0.0
        return (self.model_flops / self.chips) / (t * C.H100_BF16_FLOPS)

    @property
    def flops_ratio(self) -> float:
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    def as_dict(self) -> dict:
        return {
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "step_time_lower_bound_s": self.step_time_lower_bound,
            "mfu_at_bound": self.mfu,
            "model_to_hlo_flops": self.flops_ratio,
        }


def model_flops(cfg, shape) -> float:
    """6*N_active*D (train) / 2*N_active*D per token (inference) — the
    standard decoder estimate used for the useful-FLOPs ratio."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch
