"""Atomic training checkpoints — the part of ``repro.checkpoint.checkpoint``
that the train loop uses (``save``, ``latest_step``, ``restore``), in the
port's own format.

Layout of one checkpoint::

    <dir>/step_000123/
        manifest.json      # step, and per leaf: path, shape, dtype
        state.pt           # {leaf path: CPU tensor}, torch.save
    <dir>/step_000123.done # commit marker, written last

Properties, as in the JAX package:
  * atomic: written to a temporary directory, renamed, then the ``.done``
    marker; a crash mid-save never corrupts the latest valid checkpoint;
  * self-validating: the manifest carries the crc32 of ``state.pt``, which
    restore verifies;
  * keep-last-k garbage collection;
  * non-blocking: ``save(blocking=False)`` snapshots every leaf to host
    memory first, then writes in a background thread (returned, so the
    caller may join it).
Leaves are named by their tree path (``tree.leaves_with_paths``), so a
restore into a tree of the same structure puts every tensor back, bitwise,
on the device and in the dtype of the leaf it replaces.  The calibration
and engine snapshots of the JAX package's module wait for the port's fault
and telemetry slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
import zlib
from pathlib import Path
from typing import Optional

import torch

from repro_torch.tree import leaves_with_paths, unflatten

_SAVE_LOCK = threading.Lock()   # serializes concurrent saves (async + final)


def save(tree, directory: str | Path, step: int, keep: int = 3,
         blocking: bool = True):
    """Snapshot the tree to host memory, then write it atomically; returns
    the checkpoint's path, or the writer thread when ``blocking=False``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    snap = {name: leaf.detach().to("cpu", copy=True)
            for name, leaf in leaves_with_paths(tree)}

    def _write():
        with _SAVE_LOCK:
            final = directory / f"step_{step:08d}"
            if (directory / f"step_{step:08d}.done").exists():
                return  # another writer already committed this step
            tmp = directory / (f".tmp_{step:08d}_{os.getpid()}_"
                               f"{uuid.uuid4().hex[:8]}")
            tmp.mkdir(parents=True)
            torch.save(snap, tmp / "state.pt")
            manifest = {
                "step": step,
                "crc32": zlib.crc32((tmp / "state.pt").read_bytes()),
                "leaves": {name: {"shape": list(t.shape),
                                  "dtype": str(t.dtype)}
                           for name, t in snap.items()}}
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            (directory / f"step_{step:08d}.done").write_text("ok")
            _gc(directory, keep)

    if blocking:
        _write()
        return directory / f"step_{step:08d}"
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(directory: Path, keep: int) -> None:
    done = sorted(directory.glob("step_*.done"))
    for marker in done[:-keep]:
        step_dir = directory / marker.stem
        if step_dir.exists():
            shutil.rmtree(step_dir)
        marker.unlink()


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    done = sorted(directory.glob("step_*.done"))
    if not done:
        return None
    return int(done[-1].stem.split("_")[1])


def restore(tree_like, directory: str | Path, step: Optional[int] = None,
            verify: bool = True):
    """(tree, step): the checkpoint at ``step`` (default the latest) in the
    structure of ``tree_like``, each leaf on the device and in the dtype of
    the leaf it replaces."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    cdir = directory / f"step_{step:08d}"
    manifest = json.loads((cdir / "manifest.json").read_text())
    raw = (cdir / "state.pt").read_bytes()
    if verify and zlib.crc32(raw) != manifest["crc32"]:
        raise IOError(f"checksum mismatch in {cdir}")
    leaves = torch.load(cdir / "state.pt", map_location="cpu",
                        weights_only=True)
    out = []
    for name, like in leaves_with_paths(tree_like):
        if name not in leaves:
            raise KeyError(f"checkpoint missing leaf {name}")
        t = leaves[name]
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {name}: checkpoint shape "
                             f"{tuple(t.shape)} != {tuple(like.shape)}")
        out.append(t.to(device=like.device, dtype=like.dtype))
    return unflatten(tree_like, out), step
