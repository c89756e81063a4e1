"""Checkpoint/resume and structured logging (capabilities absent from the
reference — SURVEY.md section 5 — added as idiomatic replacements)."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from nbody_tpu import SimConfig, SimState, run_steps
from nbody_tpu.io.checkpoint import (
    load_checkpoint, save_checkpoint, save_trajectory)
from nbody_tpu.io.logger import RunLogger
from conftest import make_small_system


def make_state(n, seed=0):
    pos, vel, mass = make_small_system(n, seed=seed)
    return SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass))


def test_checkpoint_roundtrip(tmp_path):
    state = make_state(128, seed=30)
    cfg = SimConfig(n_bodies=128, impl="xla_nxn")
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, step=42, cfg=cfg)
    state2, step, cfg2 = load_checkpoint(p)
    assert step == 42
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(state.pos),
                                  np.asarray(state2.pos))
    np.testing.assert_array_equal(np.asarray(state.mass),
                                  np.asarray(state2.mass))


def test_resume_equals_continuous(tmp_path):
    """10 continuous steps == 5 steps -> checkpoint -> resume -> 5 steps."""
    n = 128
    state = make_state(n, seed=31)
    cfg = SimConfig(n_bodies=n, impl="xla_nxn")
    cont = run_steps(state, cfg, 10)

    half = run_steps(state, cfg, 5)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, half, step=5, cfg=cfg)
    restored, step, rcfg = load_checkpoint(p)
    resumed = run_steps(restored, rcfg, 5)
    # fp32 state round-trips exactly; trajectories must be bit-identical.
    np.testing.assert_array_equal(np.asarray(cont.pos),
                                  np.asarray(resumed.pos))
    np.testing.assert_array_equal(np.asarray(cont.vel),
                                  np.asarray(resumed.vel))


def test_trajectory_save(tmp_path):
    snaps = np.random.default_rng(0).normal(size=(4, 32, 3)).astype(np.float32)
    p = str(tmp_path / "traj.npz")
    save_trajectory(p, snaps, snap_every=10)
    with np.load(p) as z:
        assert z["snapshots"].shape == (4, 32, 3)
        assert int(z["snap_every"]) == 10


def test_run_logger(tmp_path):
    jl = str(tmp_path / "log.jsonl")
    cv = str(tmp_path / "log.csv")
    with RunLogger(jsonl_path=jl, csv_path=cv, quiet=True) as lg:
        lg.log(step=1, ms_per_step=1.5, ginter_per_s=100.0)
        lg.log(step=2, ms_per_step=1.4, ginter_per_s=110.0,
               energy_drift=1e-5)
    lines = [json.loads(l) for l in open(jl)]
    assert lines[0]["step"] == 1 and lines[1]["energy_drift"] == 1e-5
    rows = open(cv).read().strip().splitlines()
    assert rows[0].startswith("step,") and len(rows) == 3


def test_checkpoint_meta_reads_header_only(tmp_path, monkeypatch):
    """load_checkpoint_meta must take n_bodies from the npy HEADER of the
    mass entry — decompressing the array itself is ~134 MB at 33.5M
    bodies and runs twice per resume."""
    from nbody_tpu.io.checkpoint import load_checkpoint_meta, save_checkpoint
    state = make_state(4096, seed=31)
    cfg = SimConfig(n_bodies=4096, impl="xla")
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, state, 7, cfg)

    # Poison full-array reads of the big entries: only header reads pass.
    import numpy.lib.format as fmt
    real_read = fmt.read_array

    def guarded(fp, *a, **kw):
        out = real_read(fp, *a, **kw)
        # step scalar and the ~400-byte config_json blob are fine; the
        # (N,) mass / (N,3) pos arrays (>=16 KB at this n) are not.
        assert out.nbytes < 4096, \
            f"full array of shape {out.shape} decompressed for metadata"
        return out

    monkeypatch.setattr(fmt, "read_array", guarded)
    step, got_cfg, n = load_checkpoint_meta(p)
    assert (step, n) == (7, 4096)
    assert got_cfg is not None and got_cfg.n_bodies == 4096


def test_trajectory_vel_roundtrip_both_layouts(tmp_path):
    """The optional velocity stream round-trips in BOTH layouts (monolithic
    save_trajectory and the streamed TrajectoryWriter), and a position-only
    trajectory loads with vel=None through the full loader."""
    from nbody_tpu.io.checkpoint import (
        TrajectoryWriter, load_trajectory, load_trajectory_full)
    rng = np.random.default_rng(1)
    snaps = rng.normal(size=(3, 16, 3)).astype(np.float32)
    vels = rng.normal(size=(3, 16, 3)).astype(np.float32)
    mass = np.ones(16, np.float32)
    cfg = SimConfig(n_bodies=16, eps2=0.25)

    p1 = str(tmp_path / "mono.npz")
    save_trajectory(p1, snaps, snap_every=2, cfg=cfg, mass=mass,
                    vel_snapshots=vels)
    s, v, m, every, c = load_trajectory_full(p1)
    np.testing.assert_array_equal(np.asarray(v), vels)
    np.testing.assert_array_equal(np.asarray(s), snaps)
    assert every == 2 and c.eps2 == 0.25

    p2 = str(tmp_path / "stream.npz")
    with TrajectoryWriter(p2, snap_every=2, cfg=cfg, mass=mass) as tw:
        for k in range(3):
            tw.append(snaps[k], vel=vels[k])
    s, v, m, every, c = load_trajectory_full(p2)
    assert len(v) == 3
    np.testing.assert_array_equal(np.stack(list(v)), vels)
    np.testing.assert_array_equal(np.stack(list(s)), snaps)
    assert c.eps2 == 0.25
    # The 3-tuple loader stays position-only (render path unchanged).
    s3, m3, every3 = load_trajectory(p2)
    assert len(s3) == 3 and every3 == 2

    p3 = str(tmp_path / "posonly.npz")
    with TrajectoryWriter(p3, snap_every=1, mass=mass) as tw:
        for k in range(2):
            tw.append(snaps[k])
    s, v, m, every, c = load_trajectory_full(p3)
    assert v is None and len(s) == 2


def test_trajectory_cfg_cross_version_tolerant(tmp_path):
    """A trajectory whose embedded config carries unknown fields (written
    by a different SimConfig version) still yields its cfg — losing it
    silently would make the analysis energy series use the DEFAULT eps2
   .  Same known-field filter as load_checkpoint."""
    import dataclasses
    import json as _json
    import zipfile
    from nbody_tpu.io.checkpoint import load_trajectory_full
    rng = np.random.default_rng(2)
    snaps = rng.normal(size=(2, 8, 3)).astype(np.float32)
    p = str(tmp_path / "xv.npz")
    raw = dataclasses.asdict(SimConfig(n_bodies=8, eps2=0.125))
    raw["a_future_field"] = 42
    np.savez(p, snapshots=snaps,
             snap_every=np.asarray(1, np.int64),
             config_json=np.frombuffer(_json.dumps(raw).encode(),
                                       dtype=np.uint8))
    s, v, m, every, cfg = load_trajectory_full(p)
    assert cfg is not None and cfg.eps2 == 0.125


def test_checkpoint_from_older_config_layout_loads(tmp_path):
    """A checkpoint whose embedded config has fields this version no
    longer knows (an older layout) still loads and resumes: the unknown
    fields are dropped, and the device tuning (impl, blocks, chunk) falls
    back to this version's defaults while the physics is kept."""
    import dataclasses
    from nbody_tpu.io.checkpoint import load_checkpoint_meta
    from nbody_tpu.models.simulation import Simulation
    n = 64
    raw = dataclasses.asdict(SimConfig(n_bodies=n, dt=0.05, eps2=0.01,
                                       seed=3))
    raw.update(impl="pallas_sym2", block_i=512, block_j=2048, chunk=4096,
               block_u=1536, panel_nb=None, prog_cap=None,
               flat_state=None, resident=None)
    p = str(tmp_path / "old.npz")
    state = make_state(n, seed=34)
    save_checkpoint(p, state, step=9)
    with np.load(p) as z:
        payload = dict(z)
    payload["config_json"] = np.frombuffer(json.dumps(raw).encode(),
                                           dtype=np.uint8)
    np.savez(p, **payload)
    step, cfg, n_saved = load_checkpoint_meta(p)
    fresh = SimConfig()
    assert (step, n_saved) == (9, n)
    assert (cfg.dt, cfg.eps2, cfg.seed, cfg.n_bodies) == (0.05, 0.01, 3, n)
    assert (cfg.impl, cfg.block_i, cfg.block_j, cfg.chunk) == (
        fresh.impl, fresh.block_i, fresh.block_j, fresh.chunk)
    sim = Simulation.resume(p)
    assert sim.step_count == 9 and sim.cfg == cfg
    sim.run(n_steps=2, log_every=0)
    assert sim.step_count == 11


def test_trajectory_writer_stream_roundtrip(tmp_path):
    """Streamed trajectory == the snapshots appended, loaded lazily."""
    from nbody_tpu.io.checkpoint import (TrajectoryWriter, LazySnapshots,
                                         load_trajectory)
    path = str(tmp_path / "traj.npz")
    rng = np.random.default_rng(0)
    snaps = rng.normal(size=(5, 17, 3)).astype(np.float32)
    mass = rng.uniform(1, 2, 17).astype(np.float32)
    with TrajectoryWriter(path, snap_every=4, mass=mass) as tw:
        for s in snaps:
            tw.append(s)
    got, got_mass, snap_every = load_trajectory(path)
    assert isinstance(got, LazySnapshots)
    assert snap_every == 4 and len(got) == 5
    assert got.shape == (5, 17, 3)
    np.testing.assert_array_equal(got_mass, mass)
    for k in range(5):
        np.testing.assert_array_equal(got[k], snaps[k])
    np.testing.assert_array_equal(got[-1], snaps[-1])
    with pytest.raises(IndexError):
        got[5]


def test_trajectory_writer_discards_on_exception(tmp_path):
    """A failure mid-stream must NOT commit over a previous complete
    trajectory (atomic tmp+rename semantics)."""
    from nbody_tpu.io.checkpoint import TrajectoryWriter, load_trajectory
    path = str(tmp_path / "traj.npz")
    full = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    with TrajectoryWriter(path, snap_every=1) as tw:
        for s in full:
            tw.append(s)
    with pytest.raises(RuntimeError, match="mid-run"):
        with TrajectoryWriter(path, snap_every=1) as tw:
            tw.append(full[0])
            raise RuntimeError("mid-run device error")
    # Destination still holds BOTH snapshots of the committed run, and
    # the tmp file is gone.
    got, _, _ = load_trajectory(path)
    assert len(got) == 2
    np.testing.assert_array_equal(got[1], full[1])
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]


def test_load_trajectory_snap_count_fallback(tmp_path):
    """Without an n_snaps entry the fallback count must not mistake the
    'snap_every' metadata entry for a snapshot."""
    from nbody_tpu.io.checkpoint import load_trajectory
    path = str(tmp_path / "traj.npz")
    np.savez(path,
             snap_000000=np.zeros((4, 3), np.float32),
             snap_000001=np.ones((4, 3), np.float32),
             snap_every=np.asarray(2, dtype=np.int64))
    got, _, snap_every = load_trajectory(path)
    assert len(got) == 2 and snap_every == 2
    np.testing.assert_array_equal(got[1], np.ones((4, 3), np.float32))
