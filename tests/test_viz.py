"""Headless visualization: device rasterizer + PNG writer + frame streamer.

Behavioral parity targets from the reference GL pipeline
(simulation_visualization.cpp): 800x600 default framebuffer, NDC clip of the
+/-MAX_VIEW box, green->red mass color lerp.
"""

import os

import numpy as np
import jax.numpy as jnp

from nbody_tpu.viz.png import encode_png, read_png_size, write_png
from nbody_tpu.viz.raster import render_frame
from nbody_tpu.viz.stream import FrameStreamer


def test_render_frame_shape_and_colors():
    # Three bodies: light (green), heavy (red), out-of-view (clipped).
    pos = jnp.asarray([
        [0.0, 0.0, 0.0],          # center, light
        [100_000.0, 100_000.0, 0.0],   # upper-right quadrant, heavy
        [500_000.0, 0.0, 0.0],    # outside view box -> clipped
    ], dtype=jnp.float32)
    mass = jnp.asarray([1e5, 1e9, 1e9], dtype=jnp.float32)
    frame = np.asarray(render_frame(
        pos, mass, 1e5, 1e9, 200_000.0, width=200, height=100))
    assert frame.shape == (100, 200, 3) and frame.dtype == np.uint8
    # Center pixel: weight 0 -> pure green (fragment shader mix at w=0).
    cy, cx = 49, 99  # (1-(v+1)/2)*(H-1) with v=0 -> 49.5 -> 49
    center = frame[cy:cy + 2, cx:cx + 2].reshape(-1, 3)
    assert any((p[1] > 200 and p[0] < 50) for p in center), center
    # Heavy body at NDC (0.5, 0.5): red-ish pixel present in that quadrant.
    quad = frame[:50, 100:]
    assert quad[:, :, 0].max() > 200
    # Exactly 2 drawn pixels (third clipped).
    drawn = (frame.sum(axis=-1) > 0).sum()
    assert drawn == 2


def test_ghosts_do_not_draw():
    pos = jnp.zeros((4, 3), jnp.float32)
    mass = jnp.zeros((4,), jnp.float32)
    frame = np.asarray(render_frame(pos, mass, 1e5, 1e9, 2e5,
                                    width=64, height=64))
    assert frame.sum() == 0


def test_png_roundtrip(tmp_path):
    rgb = (np.random.default_rng(0).uniform(0, 255, (48, 64, 3))
           .astype(np.uint8))
    p = str(tmp_path / "t.png")
    write_png(p, rgb)
    assert read_png_size(p) == (64, 48)
    data = encode_png(rgb)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # zlib-decodable IDAT reproduces the raw scanlines.
    import struct, zlib
    off = 8
    idat = b""
    while off < len(data):
        (length,), tag = struct.unpack(">I", data[off:off+4]), data[off+4:off+8]
        if tag == b"IDAT":
            idat += data[off+8:off+8+length]
        off += 12 + length
    raw = zlib.decompress(idat)
    rows = np.frombuffer(raw, np.uint8).reshape(48, 1 + 64 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(48, 64, 3), rgb)


def test_gif_writer(tmp_path):
    from nbody_tpu.viz.gif import write_gif
    frames = []
    for i in range(3):
        f = np.zeros((20, 30, 3), np.uint8)
        f[5 + i, 7 + i] = (255, 0, 0)       # heavy body: red
        f[10, 10] = (0, 255, 0)             # light body: green
        frames.append(f)
    p = str(tmp_path / "a.gif")
    assert write_gif(p, frames) == 3
    data = open(p, "rb").read()
    assert data[:6] == b"GIF89a"
    assert data[-1:] == b"\x3B"
    import struct
    w, h = struct.unpack("<HH", data[6:10])
    assert (w, h) == (30, 20)
    # 3 image descriptors
    assert data.count(b"\x21\xF9") == 3


def test_run_trajectory_frames_matches_per_step_render():
    """Frames rendered inside the compiled scan equal frames rendered from
    the corresponding trajectory snapshots (the interactive-rate path)."""
    import jax.numpy as jnp
    from nbody_tpu import SimConfig, SimState
    from nbody_tpu.ops.step import run_trajectory, run_trajectory_frames
    from nbody_tpu.viz.raster import render_frame
    from conftest import make_small_system
    n = 128
    pos, vel, mass = make_small_system(n, seed=40)
    state = SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                     acc=jnp.zeros((n, 3), jnp.float32),
                     mass=jnp.asarray(mass))
    cfg = SimConfig(n_bodies=n, impl="xla_nxn", viz_width=96, viz_height=64)
    final, frames = run_trajectory_frames(state, cfg, 6, frame_every=2)
    final2, snaps = run_trajectory(state, cfg, 6, snap_every=2)
    assert frames.shape == (3, 64, 96, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(final.pos),
                                  np.asarray(final2.pos))
    for f, s in zip(np.asarray(frames), np.asarray(snaps)):
        expect = np.asarray(render_frame(
            jnp.asarray(s), state.mass, cfg.min_mass, cfg.max_mass,
            cfg.max_view, 96, 64))
        np.testing.assert_array_equal(f, expect)


def test_packed_weights_colorize_exactly():
    """colorize(render_weights(...)) reproduces render_frame pixel-exactly
    (the packed 1-byte wire format loses nothing)."""
    import jax.numpy as jnp
    from nbody_tpu.viz.raster import colorize, render_frame, render_weights
    from conftest import make_small_system
    pos, _, mass = make_small_system(256, seed=41)
    args = (jnp.asarray(pos), jnp.asarray(mass), 1e5, 1e9, 2e5, 120, 90)
    rgb = np.asarray(render_frame(*args))
    w8 = np.asarray(render_weights(*args))
    assert w8.shape == (90, 120) and w8.dtype == np.uint8
    np.testing.assert_array_equal(colorize(w8), rgb)


def test_live_viewer_serves_frames():
    """LiveViewer: latest-frame endpoint and multipart stream deliver the
    submitted PNG (the reference's live-window replacement)."""
    import urllib.request
    from nbody_tpu.viz.server import LiveViewer
    frame = np.zeros((8, 8, 3), np.uint8)
    frame[2, 3] = (255, 0, 0)
    with LiveViewer(port=0) as lv:
        lv.submit(0, frame)
        url = f"http://127.0.0.1:{lv.port}"
        html = urllib.request.urlopen(f"{url}/", timeout=10).read()
        assert b"/stream" in html
        png = urllib.request.urlopen(f"{url}/frame.png", timeout=10).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        with urllib.request.urlopen(f"{url}/stream", timeout=10) as r:
            assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
            header = (b"--nbodyframe\r\nContent-Type: image/png\r\n"
                      b"Content-Length: " + str(len(png)).encode()
                      + b"\r\n\r\n")
            part = r.read(len(header) + len(png))
            assert part == header + png
    assert lv.frames_written == 1


def test_cli_viz_serve(tmp_path):
    """--viz-serve end-to-end through the CLI (port 0 = auto)."""
    from nbody_tpu.cli import main
    rc = main(["run", "--n", "64", "--steps", "4", "--impl", "xla_nxn",
               "--viz-serve", "0", "--viz-every", "2"])
    assert rc == 0


def test_simulation_batched_viz_counts_frames(tmp_path):
    """The batched on-device render path submits one frame per viz_every."""
    from nbody_tpu import SimConfig
    from nbody_tpu.models.simulation import Simulation
    from nbody_tpu.viz.stream import FrameStreamer
    cfg = SimConfig(n_bodies=64, impl="xla_nxn", viz_every=3,
                    viz_width=64, viz_height=48)
    sim = Simulation(cfg)
    vd = str(tmp_path / "f")
    with FrameStreamer(vd) as fs:
        sim.run(n_steps=12, log_every=6, frame_streamer=fs)
    assert fs.frames_written == 4


def test_mesh_inloop_frames_match_gathered_render():
    """The mesh in-loop frame path (render local shards,
    pmax-combine) is PIXEL-IDENTICAL to rendering the gathered sharded
    state at every frame boundary — the max-combine across chips is the
    same brightest-point rule the splat uses per pixel."""
    import jax.numpy as jnp
    from nbody_tpu import SimConfig, SimState
    from nbody_tpu.parallel.mesh import make_mesh
    from nbody_tpu.parallel.ring import (run_steps_sharded,
                                         run_trajectory_frames_sharded)
    from nbody_tpu.viz.raster import render_weights
    from conftest import make_small_system
    n = 256
    pos, vel, mass = make_small_system(n, seed=60)
    state = SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                     acc=jnp.zeros((n, 3), jnp.float32),
                     mass=jnp.asarray(mass))
    cfg = SimConfig(n_bodies=n, impl="xla", viz_width=64, viz_height=48)
    mesh = make_mesh(8)
    out, frames = run_trajectory_frames_sharded(
        state, cfg, mesh, 4, frame_every=2, impl="xla", comm="ring")
    assert frames.shape == (2, 48, 64)
    for k, steps in enumerate((2, 4)):
        ref_state = run_steps_sharded(state, cfg, mesh, steps, impl="xla",
                                      comm="ring")
        want = render_weights(
            jnp.asarray(np.asarray(ref_state.pos)),
            jnp.asarray(np.asarray(ref_state.mass)),
            cfg.min_mass, cfg.max_mass, cfg.max_view, 64, 48)
        np.testing.assert_array_equal(np.asarray(frames[k]),
                                      np.asarray(want))
    # Final state advanced past the last frame boundary.
    assert np.all(np.isfinite(np.asarray(out.pos)))


def test_simulation_mesh_batched_viz(tmp_path):
    """Simulation(mesh=...) with a frame streamer uses the in-loop mesh
    path (no boundary-render fallback) and submits one frame per
    viz_every."""
    from nbody_tpu import SimConfig
    from nbody_tpu.models.simulation import Simulation
    from nbody_tpu.parallel.mesh import make_mesh
    from nbody_tpu.viz.stream import FrameStreamer
    cfg = SimConfig(n_bodies=64, impl="xla", viz_every=3,
                    viz_width=64, viz_height=48)
    sim = Simulation(cfg, mesh=make_mesh(8))
    vd = str(tmp_path / "f")
    with FrameStreamer(vd) as fs:
        sim.run(n_steps=12, log_every=6, frame_streamer=fs)
    assert fs.frames_written == 4


def test_frame_streamer(tmp_path):
    out = str(tmp_path / "frames")
    with FrameStreamer(out) as fs:
        for i in range(5):
            fs.submit(i, np.full((16, 16, 3), i * 40, np.uint8))
    files = sorted(os.listdir(out))
    assert len(files) == 5
    assert files[0] == "frame_000000.png"


def test_viewer_run_control_stops_run(tmp_path):
    """Browser /stop ends a run cleanly at the next chunk boundary,
    checkpointing first — the reference's close-window-to-stop semantics
    (main.cpp:118) without killing the process."""
    import urllib.request
    from nbody_tpu import SimConfig
    from nbody_tpu.models.simulation import Simulation
    from nbody_tpu.viz.server import LiveViewer
    viewer = LiveViewer(port=0)
    try:
        url = f"http://127.0.0.1:{viewer.port}"
        assert viewer.control_state() == "run"
        # pause -> resume round-trips; stop is sticky.
        urllib.request.urlopen(f"{url}/pause", data=b"")
        assert viewer.control_state() == "pause"
        urllib.request.urlopen(f"{url}/resume", data=b"")
        assert viewer.control_state() == "run"
        urllib.request.urlopen(f"{url}/stop", data=b"")
        urllib.request.urlopen(f"{url}/resume", data=b"")
        assert viewer.control_state() == "stop"

        cfg = SimConfig(n_bodies=64, impl="xla_nxn", viz_every=1,
                        viz_width=32, viz_height=24)
        sim = Simulation(cfg)
        ckpt = str(tmp_path / "stopped.npz")
        res = sim.run(n_steps=50, log_every=1, frame_streamer=viewer,
                      checkpoint_path=ckpt)
        assert res.steps_run < 50
        assert os.path.exists(ckpt)
        with np.load(ckpt) as z:
            assert int(z["step"]) == res.steps_run
    finally:
        viewer.close()


def test_tee_streamer_forwards_control(tmp_path):
    from nbody_tpu.viz.server import LiveViewer
    from nbody_tpu.viz.stream import TeeStreamer
    viewer = LiveViewer(port=0)
    try:
        with FrameStreamer(str(tmp_path / "f")) as fs:
            tee = TeeStreamer(fs, viewer)
            assert tee.control_state() == "run"
            viewer.request_stop()
            assert tee.control_state() == "stop"
    finally:
        viewer.close()


def test_render_pan_zoom_camera():
    """Traced camera scalars: pan centers a body on the middle pixel;
    zoom-in clips bodies outside the shrunk view box."""
    from nbody_tpu.viz.raster import render_weights
    pos = jnp.array([[60.0, -30.0, 0.0]])
    mass = jnp.array([5e8])
    w, h = 33, 25
    # Fixed camera: body lands off-center.
    base = np.asarray(render_weights(pos, mass, 1e5, 1e9, 100.0, w, h))
    ys, xs = np.nonzero(base)
    assert (xs[0], ys[0]) != (w // 2, h // 2)
    # Pan to the body: it must land exactly on the center pixel.
    panned = np.asarray(render_weights(pos, mass, 1e5, 1e9, 100.0, w, h,
                                       2, 60.0, -30.0))
    ys, xs = np.nonzero(panned)
    assert (xs[0], ys[0]) == (w // 2, h // 2)
    # Zoom in (smaller max_view) without panning: the body clips out.
    zoomed = np.asarray(render_weights(pos, mass, 1e5, 1e9, 25.0, w, h))
    assert not zoomed.any()


def test_viewer_view_endpoint():
    """/view relative ops and absolute sets update view_state; bad input
    is rejected without changing it."""
    import urllib.request
    from urllib.error import HTTPError
    from nbody_tpu.viz.server import LiveViewer
    with LiveViewer(port=0) as lv:
        url = f"http://127.0.0.1:{lv.port}"
        assert lv.view_state() == (1.0, 0.0, 0.0)
        urllib.request.urlopen(f"{url}/view?op=in", data=b"")
        z, cx, cy = lv.view_state()
        assert z == 1.25 and (cx, cy) == (0.0, 0.0)
        urllib.request.urlopen(f"{url}/view?op=right", data=b"")
        z, cx, cy = lv.view_state()
        assert cx == 0.25 / 1.25 and cy == 0.0
        urllib.request.urlopen(f"{url}/view?zoom=4&cx=-0.5&cy=0.125")
        assert lv.view_state() == (4.0, -0.5, 0.125)
        try:
            urllib.request.urlopen(f"{url}/view?zoom=0", data=b"")
            raise AssertionError("zoom=0 must 400")
        except HTTPError as e:
            assert e.code == 400
        assert lv.view_state() == (4.0, -0.5, 0.125)
        urllib.request.urlopen(f"{url}/view?op=reset", data=b"")
        assert lv.view_state() == (1.0, 0.0, 0.0)


def test_simulation_honors_viewer_camera(tmp_path):
    """A zoomed/panned view_state reaches the batched on-device render:
    submitted frames equal a direct render with the same camera."""
    from nbody_tpu import SimConfig, init_state
    from nbody_tpu.models.simulation import Simulation
    from nbody_tpu.ops.step import run_steps
    from nbody_tpu.viz.raster import colorize, render_weights

    class CamStreamer:
        frames = []

        def view_state(self):
            return (2.0, 0.1, -0.2)   # zoom 2x, panned

        def submit(self, idx, frame):
            self.frames.append(np.asarray(frame))

        def close(self):
            pass

    cfg = SimConfig(n_bodies=64, impl="xla_nxn", viz_every=2,
                    viz_width=48, viz_height=36)
    sim = Simulation(cfg)
    fs = CamStreamer()
    sim.run(n_steps=4, log_every=0, frame_streamer=fs)
    assert len(fs.frames) == 2
    ref_state = run_steps(init_state(cfg), cfg, 2)
    mv = cfg.max_view / 2.0
    expect = colorize(render_weights(
        ref_state.pos, ref_state.mass, cfg.min_mass, cfg.max_mass, mv,
        cfg.viz_width, cfg.viz_height, 2,
        0.1 * cfg.max_view, -0.2 * cfg.max_view))
    np.testing.assert_array_equal(fs.frames[0], expect)


class _Collect:
    """Minimal frame sink recording colorized frames by index."""

    def __init__(self):
        self.frames = {}

    def submit(self, idx, frame):
        self.frames[idx] = np.asarray(frame)

    def close(self):
        pass


def _last_frame_of_state(sim):
    from nbody_tpu.viz.raster import colorize, render_weights
    cfg = sim.cfg
    return colorize(render_weights(
        jnp.asarray(np.asarray(sim.state.pos)),
        jnp.asarray(np.asarray(sim.state.mass)), cfg.min_mass,
        cfg.max_mass, cfg.max_view, cfg.viz_width, cfg.viz_height))


def test_kernel_inloop_frames_at_cadence(kernel_interpret):
    """A run through the tiled kernel streams frames at the viz cadence,
    rendered on device inside the compiled chunk; the last one is the
    final state's picture."""
    from nbody_tpu import SimConfig
    from nbody_tpu.models.simulation import Simulation
    cfg = SimConfig(n_bodies=256, impl="pallas", block_i=16, block_j=32,
                    viz_every=2, viz_width=64, viz_height=48)
    sink = _Collect()
    sim = Simulation(cfg)
    sim.run(n_steps=6, log_every=0, frame_streamer=sink)
    assert sorted(sink.frames) == [0, 1, 2]
    np.testing.assert_array_equal(sink.frames[2], _last_frame_of_state(sim))


def test_mesh_inloop_frames_at_cadence():
    """The mesh twin: each device renders its shard and the maps
    max-combine across the mesh (pmax), pixel-identical to rendering the
    gathered state."""
    from nbody_tpu import SimConfig
    from nbody_tpu.models.simulation import Simulation
    from nbody_tpu.parallel.mesh import make_mesh
    cfg = SimConfig(n_bodies=256, impl="xla", chunk=64, viz_every=2,
                    viz_width=64, viz_height=48)
    sink = _Collect()
    sim = Simulation(cfg, mesh=make_mesh(4))
    sim.run(n_steps=4, log_every=0, frame_streamer=sink)
    assert sorted(sink.frames) == [0, 1]
    np.testing.assert_array_equal(sink.frames[1], _last_frame_of_state(sim))
