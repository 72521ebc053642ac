"""Atomic checkpoints — torch port of ``repro.checkpoint.checkpoint`` in
the port's own format: the training state (``save``, ``latest_step``,
``restore``), the calibration windows (``save_calibration``,
``restore_calibration``) and the serving engine's snapshots
(``save_engine_snapshot``, ``load_engine_snapshot``).

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
Leaves are named by their tree path (``leaf_paths``), so a restore into a
tree of the same structure puts every tensor back, bitwise, on the device
and in the dtype of the leaf it replaces; ``load_flat`` returns the
name -> CPU tensor dict itself, for a caller that rebuilds its own
structure (``runtime.engine.Engine.restore``).
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

# (name, leaf) pairs with "/"-joined tree paths, the names of every leaf in
# this layout; a flat dict whose keys hold "/" gives the same names
from repro_torch.tree import leaves_with_paths as leaf_paths, unflatten

_SAVE_LOCK = threading.Lock()   # serializes concurrent saves (async + final)


def save(tree, directory: str | Path, step: int, keep: int = 3,
         blocking: bool = True):
    """Snapshot the tree to host memory, then write it atomically; returns
    the checkpoint's path, or the writer thread when ``blocking=False``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    snap = {name: leaf.detach().to("cpu", copy=True)
            for name, leaf in leaf_paths(tree)}

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


def load_flat(directory: str | Path, step: Optional[int] = None,
              verify: bool = True) -> tuple[dict, int]:
    """({leaf name: CPU tensor}, step) of the checkpoint at ``step``
    (default the latest), its checksum verified — no template tree
    needed."""
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
    return torch.load(cdir / "state.pt", map_location="cpu",
                      weights_only=True), step


def restore(tree_like, directory: str | Path, step: Optional[int] = None,
            verify: bool = True, shardings=None):
    """(tree, step): the checkpoint at ``step`` (default the latest) in the
    structure of ``tree_like``, each leaf on the device and in the dtype of
    the leaf it replaces.

    ``shardings`` = (placement tree, mesh) restores elastically: the
    checkpoint holds whole leaves (a mesh-sharded state is saved gathered,
    ``launch.sharding.gather_tree``), and each comes back as this rank's
    shard under the given placements — of any mesh, not only the one it
    was saved from.  ``tree_like`` then holds the shards (only their
    devices and dtypes are read)."""
    leaves, step = load_flat(directory, step, verify)
    specs = mesh = None
    if shardings is not None:
        from repro_torch.launch import sharding
        spec_tree, mesh = shardings
        specs = dict(leaf_paths(spec_tree))
    out = []
    for name, like in leaf_paths(tree_like):
        if name not in leaves:
            raise KeyError(f"checkpoint missing leaf {name}")
        t = leaves[name]
        if specs is not None:
            t = sharding.shard(t, specs[name], mesh)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {name}: checkpoint shape "
                             f"{tuple(t.shape)} != {tuple(like.shape)}")
        out.append(t.to(device=like.device, dtype=like.dtype))
    return unflatten(tree_like, out), step


# ---------------------------------------------------------------------------
# TD-VMM calibration state (site-keyed readout windows)
# ---------------------------------------------------------------------------
# Saved under the conventional sub-directory, so a serving restart finds the
# windows next to the weights; leaves are named "windows/<site>", as in the
# JAX package.
_CALIB_SUBDIR = "calibration"


def save_calibration(calib, directory: str | Path, step: int = 0,
                     keep: int = 3, blocking: bool = True):
    """Persist a ``core.calibration.CalibrationState`` under
    ``<directory>/calibration/step_XXXXXXXX`` (atomic, checksummed)."""
    return save({"windows": calib.windows}, Path(directory) / _CALIB_SUBDIR,
                step, keep=keep, blocking=blocking)


def restore_calibration(calib_like, directory: str | Path,
                        step: Optional[int] = None):
    """(CalibrationState, step) saved by ``save_calibration``;
    ``calib_like`` supplies the site names and window shapes (the state
    ``models.model.calibrate`` returns for the same model config)."""
    tree, step = restore({"windows": calib_like.windows},
                         Path(directory) / _CALIB_SUBDIR, step=step)
    return type(calib_like)(windows=tree["windows"]), step


def latest_calibration_step(directory: str | Path) -> Optional[int]:
    return latest_step(Path(directory) / _CALIB_SUBDIR)


# ---------------------------------------------------------------------------
# Serving-engine snapshots (the whole in-flight state)
# ---------------------------------------------------------------------------
# ``Engine.snapshot()`` is one tree — the page pools, the pinned windows and
# a uint8 "meta" tensor holding the host-side structures as JSON — saved in
# the same atomic, checksummed layout and loaded flat: the engine rebuilds
# its own structure from the names.
_ENGINE_SUBDIR = "engine"


def save_engine_snapshot(snap, directory: str | Path, step: int,
                         keep: int = 3, blocking: bool = True):
    """Persist an ``Engine.snapshot()`` tree under
    ``<directory>/engine/step_XXXXXXXX`` (atomic, checksummed)."""
    return save(snap, Path(directory) / _ENGINE_SUBDIR, step, keep=keep,
                blocking=blocking)


def load_engine_snapshot(directory: str | Path, step: Optional[int] = None,
                         verify: bool = True) -> tuple[dict, int]:
    """Flat-load the latest (or the given step's) engine snapshot saved by
    ``save_engine_snapshot``; ``Engine.restore`` takes the dict."""
    return load_flat(Path(directory) / _ENGINE_SUBDIR, step=step,
                     verify=verify)


def latest_engine_snapshot_step(directory: str | Path) -> Optional[int]:
    return latest_step(Path(directory) / _ENGINE_SUBDIR)
