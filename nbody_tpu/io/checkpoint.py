"""Checkpoint / resume.

The reference has no persistence — a run's outputs die with the process
(``main.cpp:361-366``; SURVEY.md section 5).  The rebuild adds NPZ
save/restore of ``(pos, vel, acc, mass, step, config)`` so long runs and the
1k-step validation can resume.  NPZ is the default (zero extra deps,
host-level IO); an Orbax adapter is provided for users already in that
ecosystem.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import SimConfig
from ..models.state import SimState


# Device tuning rather than physics: a checkpoint written by an older
# layout of the config (one with fields this version no longer has) was
# tuned for another device, so these fall back to this version's defaults.
_DEVICE_TUNING = ("impl", "block_i", "block_j", "chunk")


def _config_from_json(raw: dict) -> SimConfig:
    known = {f.name for f in dataclasses.fields(SimConfig)}
    drop = set(raw) - known
    if drop:
        drop.update(_DEVICE_TUNING)
    return SimConfig(**{k: v for k, v in raw.items() if k not in drop})


def save_checkpoint(path: str, state, step: int,
                    cfg: Optional[SimConfig] = None) -> None:
    """Atomic NPZ checkpoint write (tmp file + rename)."""
    payload = {
        "pos": np.asarray(state.pos),
        "vel": np.asarray(state.vel),
        "acc": np.asarray(state.acc),
        "mass": np.asarray(state.mass),
        "step": np.asarray(step, dtype=np.int64),
    }
    if cfg is not None:
        payload["config_json"] = np.frombuffer(
            json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, dtype=None
                    ) -> Tuple[SimState, int, Optional[SimConfig]]:
    """Load (state, step, config-or-None) from an NPZ checkpoint.

    ``dtype=None`` keeps the checkpoint's stored precision (a float64 run
    resumes in float64 when x64 is enabled); pass a dtype to convert."""
    with np.load(path) as z:
        state = SimState(
            pos=jnp.asarray(z["pos"], dtype=dtype),
            vel=jnp.asarray(z["vel"], dtype=dtype),
            acc=jnp.asarray(z["acc"], dtype=dtype),
            mass=jnp.asarray(z["mass"], dtype=dtype),
        )
        step = int(z["step"])
        cfg = None
        if "config_json" in z:
            cfg = _config_from_json(
                json.loads(bytes(z["config_json"].tobytes()).decode()))
    return state, step, cfg


def load_checkpoint_meta(path: str
                         ) -> Tuple[int, Optional[SimConfig], int]:
    """Read (step, config-or-None, n_bodies) WITHOUT creating any device
    array, so ``Simulation.resume`` can reconcile the config before the
    big arrays are transferred."""
    with np.load(path) as z:
        step = int(z["step"])
        # n_bodies comes from the npy HEADER of the mass entry, not the
        # array: z["mass"] would decompress ~134 MB at 33.5M bodies just
        # to read a shape, and this runs twice per resume.
        try:
            with z.zip.open("mass.npy") as f:
                version = np.lib.format.read_magic(f)
                reader = {(1, 0): np.lib.format.read_array_header_1_0,
                          (2, 0): np.lib.format.read_array_header_2_0}[
                              version]
                shape, _, _ = reader(f)
            n = int(shape[0])
        except (KeyError, AttributeError, ValueError, OSError):
            n = int(z["mass"].shape[0])   # unknown layout: full read
        cfg = None
        if "config_json" in z:
            cfg = _config_from_json(
                json.loads(bytes(z["config_json"].tobytes()).decode()))
    return step, cfg, n


def save_trajectory(path: str, snapshots: np.ndarray,
                    snap_every: int, cfg: Optional[SimConfig] = None,
                    mass: Optional[np.ndarray] = None,
                    vel_snapshots: Optional[np.ndarray] = None) -> None:
    """NPZ trajectory export (positions over time) — the persistent
    replacement for the reference's render-only output.

    ``mass`` must be persisted for faithful rendering: the reference's
    central visual semantic is the mass->color lerp
    (simulation_visualization.cpp:46-56), which needs per-body masses at
    render time.  ``vel_snapshots`` (optional, same (T, N, 3) shape)
    makes the trajectory energy/virial-analyzable
    (``analysis.analyze_trajectory``)."""
    payload = {"snapshots": np.asarray(snapshots),
               "snap_every": np.asarray(snap_every, dtype=np.int64)}
    if vel_snapshots is not None:
        payload["vel_snapshots"] = np.asarray(vel_snapshots)
    if mass is not None:
        payload["mass"] = np.asarray(mass)
    if cfg is not None:
        payload["config_json"] = np.frombuffer(
            json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


class TrajectoryWriter:
    """INCREMENTAL trajectory writer: snapshots spill to the NPZ (zip) one
    entry at a time, so peak host memory is O(one snapshot) regardless of
    snapshot count (collecting then ``np.stack``-ing 100 snapshots at
    N=8M peaked ~19 GB host RAM).

    Writes ``snap_000000 ... snap_{k}``, plus ``mass`` / ``snap_every`` /
    ``config_json`` / ``n_snaps`` metadata on close; ``load_trajectory``
    reads both this layout and the monolithic ``snapshots`` layout.
    Atomic: assembles in a tmp file, renamed into place on close."""

    def __init__(self, path: str, snap_every: int,
                 cfg: Optional[SimConfig] = None,
                 mass: Optional[np.ndarray] = None,
                 compress: bool = True):
        import zipfile
        self._path = path
        self._snap_every = snap_every
        self._cfg = cfg
        self._mass = None if mass is None else np.asarray(mass)
        self.n_snaps = 0
        directory = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(directory, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
        os.close(fd)
        self._zf = zipfile.ZipFile(
            self._tmp, "w",
            zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED)

    def _write_entry(self, name: str, arr: np.ndarray) -> None:
        with self._zf.open(name + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.ascontiguousarray(arr))

    def append(self, pos, vel=None) -> None:
        """Append one (N,3) position snapshot (device or host).  ``vel``
        is stored alongside when given — every snapshot of one trajectory
        must be appended consistently (all with vel or none; the loader
        treats a count mismatch as position-only)."""
        self._write_entry(f"snap_{self.n_snaps:06d}", np.asarray(pos))
        if vel is not None:
            self._write_entry(f"vel_{self.n_snaps:06d}", np.asarray(vel))
        self.n_snaps += 1

    def close(self) -> None:
        if self._zf is None:
            return
        try:
            if self._mass is not None:
                self._write_entry("mass", self._mass)
            self._write_entry(
                "snap_every", np.asarray(self._snap_every, dtype=np.int64))
            self._write_entry(
                "n_snaps", np.asarray(self.n_snaps, dtype=np.int64))
            if self._cfg is not None:
                self._write_entry("config_json", np.frombuffer(
                    json.dumps(dataclasses.asdict(self._cfg)).encode(),
                    dtype=np.uint8))
            self._zf.close()
            self._zf = None
            os.replace(self._tmp, self._path)
        except BaseException:
            if self._zf is not None:
                self._zf.close()
                self._zf = None
            if os.path.exists(self._tmp):
                os.unlink(self._tmp)
            raise

    def discard(self) -> None:
        """Abandon the stream: close and remove the tmp file WITHOUT
        committing over the destination."""
        if self._zf is None:
            return
        self._zf.close()
        self._zf = None
        if os.path.exists(self._tmp):
            os.unlink(self._tmp)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # Atomic semantics: only a run that exits the with-block cleanly
        # commits (os.replace over the destination).  A failure mid-run
        # (device error, Ctrl-C) must leave any previous complete
        # trajectory at ``path`` untouched.
        if exc_type is not None:
            self.discard()
        else:
            self.close()


class LazySnapshots:
    """Sequence view over a streamed trajectory NPZ: snapshots load from
    the zip ONE AT A TIME (O(one snapshot) host memory), with the same
    iteration/indexing surface consumers use on the (T, N, 3) array.
    ``prefix`` selects the entry family (``snap_`` positions /
    ``vel_`` velocities)."""

    def __init__(self, npz, n_snaps: int, prefix: str = "snap_"):
        self._z = npz
        self._n = n_snaps
        self._prefix = prefix
        self.shape = ((n_snaps,) + tuple(npz[f"{prefix}000000"].shape)
                      if n_snaps else (0, 0, 3))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k: int) -> np.ndarray:
        if not -self._n <= k < self._n:
            raise IndexError(k)
        return self._z[f"{self._prefix}{k % self._n:06d}"]

    def __iter__(self):
        for k in range(self._n):
            yield self[k]


def load_trajectory(path: str):
    """Load a trajectory NPZ -> (snapshots, mass-or-None, snap_every).

    Handles both layouts: monolithic ``snapshots`` (T,N,3) arrays load
    eagerly; streamed per-snapshot entries (``TrajectoryWriter``) return a
    ``LazySnapshots`` view.  Caller owns closing nothing — the underlying
    zip handle lives until the returned view is garbage-collected."""
    snaps, _, mass, snap_every, _ = load_trajectory_full(path)
    return snaps, mass, snap_every


def load_trajectory_full(path: str):
    """Load a trajectory NPZ with every stored stream ->
    ``(snapshots, vel_snapshots-or-None, mass-or-None, snap_every,
    cfg-or-None)``.

    The superset of ``load_trajectory`` for consumers that use the
    optional velocity stream and the embedded config (the analysis CLI
    needs ``cfg.eps2`` for potential-energy/virial diagnostics).  Both
    layouts, same laziness contract as ``load_trajectory``."""
    z = np.load(path)
    mass = z["mass"] if "mass" in z.files else None
    snap_every = (int(np.ravel(z["snap_every"])[0])
                  if "snap_every" in z.files else 1)
    cfg = None
    if "config_json" in z.files:
        # Filter to known fields (same cross-version tolerance as
        # load_checkpoint above): a trajectory written by a SimConfig
        # with an extra field must not silently lose its eps2 — the
        # analysis energy series would quietly use the default softening.
        raw = json.loads(bytes(z["config_json"]).decode())
        known = {f.name for f in dataclasses.fields(SimConfig)}
        cfg = SimConfig(**{k: v for k, v in raw.items() if k in known})
    if "snapshots" in z.files:
        snaps = z["snapshots"]
        vel = z["vel_snapshots"] if "vel_snapshots" in z.files else None
        z.close()   # eager layout: nothing lazy holds the zip open
        return snaps, vel, mass, snap_every, cfg
    # Fallback count must match only snap_NNNNNN entries — a bare
    # startswith("snap_") would also count the "snap_every" metadata.
    n = (int(np.ravel(z["n_snaps"])[0]) if "n_snaps" in z.files
         else sum(1 for f in z.files
                  if f.startswith("snap_") and f[5:].isdigit()))
    n_vel = sum(1 for f in z.files
                if f.startswith("vel_") and f[4:].isdigit())
    vel = LazySnapshots(z, n, prefix="vel_") if n_vel == n and n else None
    return LazySnapshots(z, n), vel, mass, snap_every, cfg


# --- Orbax adapter (optional; orbax-checkpoint is in the base image) -------

def save_checkpoint_orbax(directory: str, state: SimState, step: int) -> None:
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(os.path.join(directory, f"step_{step}")),
               {"pos": state.pos, "vel": state.vel, "acc": state.acc,
                "mass": state.mass},
               force=True)
    ckptr.wait_until_finished()


def load_checkpoint_orbax(directory: str, step: int) -> SimState:
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    tree = ckptr.restore(
        os.path.abspath(os.path.join(directory, f"step_{step}")))
    return SimState(pos=tree["pos"], vel=tree["vel"], acc=tree["acc"],
                    mass=tree["mass"])
