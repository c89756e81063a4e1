"""MJPEG-MP4 writer: ISO-BMFF structure, sample-table integrity, frame
round-trip (decode JPEG samples back), extension dispatch, CLI paths."""

import struct

import numpy as np
import pytest

import conftest  # noqa: F401

from nbody_tpu.viz.mp4 import Mp4Writer, write_mp4
from test_avi import _frames


def _boxes(data, start=0, end=None):
    """Iterate (type, payload_start, payload_end) of sibling boxes."""
    end = len(data) if end is None else end
    p = start
    out = []
    while p + 8 <= end:
        size = struct.unpack(">I", data[p:p + 4])[0]
        assert size >= 8, "corrupt box size"
        out.append((data[p + 4:p + 8], p + 8, p + size))
        p += size
    assert p == end, "box sizes don't tile the parent"
    return out


def _find(data, path, start=0, end=None):
    """Descend a box path like [b'moov', b'trak', ...]; returns (s, e)."""
    for name in path:
        got = [(s, e) for typ, s, e in _boxes(data, start, end)
               if typ == name]
        assert got, f"missing box {name!r}"
        start, end = got[0]
    return start, end


def _parse_mp4(path):
    """Returns (n_frames, sample bytes list) after structural checks."""
    data = open(path, "rb").read()
    top = [t for t, _, _ in _boxes(data)]
    assert top == [b"ftyp", b"mdat", b"moov"]
    mdat_s, mdat_e = _find(data, [b"mdat"])
    stbl_s, stbl_e = _find(data, [b"moov", b"trak", b"mdia", b"minf",
                                  b"stbl"])
    kids = {t: (s, e) for t, s, e in _boxes(data, stbl_s, stbl_e)}
    # stsd declares exactly one mp4v (MPEG-4 visual container) entry.
    s, e = kids[b"stsd"]
    assert struct.unpack(">I", data[s + 4:s + 8])[0] == 1
    assert data[s + 12:s + 16] == b"mp4v"
    # esds inside the sample entry declares JPEG (OTI 0x6C).
    assert b"esds" in data[s:e]
    esds = data.index(b"esds", s, e)
    oti = data[esds + 4 + 4 + 2 + 2 + 1 + 2:][:1]   # fullbox+ES hdr+DCD tag
    assert oti == b"\x6c", f"objectTypeIndication {oti!r} != JPEG"
    s, e = kids[b"stsz"]
    _, n = struct.unpack(">2I", data[s + 4:s + 12])
    sizes = struct.unpack(f">{n}I", data[s + 12:s + 12 + 4 * n])
    s, e = kids[b"stco"]
    assert struct.unpack(">I", data[s + 4:s + 8])[0] == n
    offs = struct.unpack(f">{n}I", data[s + 8:s + 8 + 4 * n])
    s, e = kids[b"stts"]
    if n:
        assert struct.unpack(">3I", data[s + 4:s + 16]) == (1, n, 1)
    samples = []
    for off, size in zip(offs, sizes):
        assert mdat_s <= off and off + size <= mdat_e, "sample outside mdat"
        chunk = data[off:off + size]
        assert chunk[:2] == b"\xff\xd8" and chunk[-2:] == b"\xff\xd9", \
            "sample is not a standalone JPEG"
        samples.append(chunk)
    # Samples tile mdat exactly (streaming writer appends back to back).
    assert offs[0] == mdat_s and offs[-1] + sizes[-1] == mdat_e
    return n, samples


def test_mp4_structure_and_roundtrip(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image
    import io
    path = str(tmp_path / "out.mp4")
    frames = _frames()
    n = write_mp4(path, frames, fps=10, quality=95)
    assert n == len(frames)
    n_tab, samples = _parse_mp4(path)
    assert n_tab == len(frames)
    decoded = np.asarray(Image.open(io.BytesIO(samples[0])).convert("RGB"))
    assert decoded.shape == frames[0].shape
    assert np.mean(np.abs(decoded.astype(int) - frames[0].astype(int))) < 24


def test_mp4_durations_and_dimensions(tmp_path):
    pytest.importorskip("PIL")
    path = str(tmp_path / "t.mp4")
    with Mp4Writer(path, 64, 48, fps=30) as mp:
        for fr in _frames(5):
            mp.add(fr)
    data = open(path, "rb").read()
    s, _ = _find(data, [b"moov", b"mvhd"])
    _, _, _, ts, dur = struct.unpack(">5I", data[s:s + 20])
    assert (ts, dur) == (30, 5)
    s, _ = _find(data, [b"moov", b"trak", b"tkhd"])
    w, h = struct.unpack(">2I", data[s + 76:s + 84])
    assert (w >> 16, h >> 16) == (64, 48)


def test_video_dispatch_by_extension(tmp_path):
    pytest.importorskip("PIL")
    from nbody_tpu.viz.avi import AviWriter
    from nbody_tpu.viz.video import video_streamer, video_writer
    from nbody_tpu.viz.mp4 import Mp4Streamer, Mp4Writer as MW
    w = video_writer(str(tmp_path / "a.MP4"), 64, 48)
    assert isinstance(w, MW)
    w.add(_frames(1)[0]); w.close()
    w = video_writer(str(tmp_path / "a.avi"), 64, 48)
    assert isinstance(w, AviWriter)
    w.add(_frames(1)[0]); w.close()
    st = video_streamer(str(tmp_path / "b.m4v"), 64, 48)
    assert isinstance(st, Mp4Streamer)
    st.submit(0, _frames(1)[0]); st.close()
    assert _parse_mp4(str(tmp_path / "b.m4v"))[0] == 1


def test_mp4_requires_pil(tmp_path, monkeypatch):
    import nbody_tpu.viz.video as video
    monkeypatch.setattr(video, "_pil_available", lambda: False)
    with pytest.raises(RuntimeError, match="PIL"):
        video.video_writer(str(tmp_path / "x.mp4"), 64, 48)


def test_cli_render_mp4(tmp_path):
    pytest.importorskip("PIL")
    from nbody_tpu.cli import main
    from nbody_tpu.io.checkpoint import save_trajectory
    rng = np.random.default_rng(1)
    snaps = rng.uniform(-2e5, 2e5, (4, 32, 3)).astype(np.float32)
    mass = rng.uniform(1e5, 1e9, 32).astype(np.float32)
    traj = str(tmp_path / "t.npz")
    save_trajectory(traj, snaps, 1, mass=mass)
    mp4 = str(tmp_path / "t.mp4")
    rc = main(["render", traj, "--out-dir", str(tmp_path / "f"),
               "--width", "64", "--height", "48", "--video", mp4])
    assert rc == 0
    assert _parse_mp4(mp4)[0] == 4


def test_cli_run_viz_mp4(tmp_path):
    """--viz-video with an .mp4 path writes an MP4 during a live run."""
    pytest.importorskip("PIL")
    from nbody_tpu.cli import main
    mp4 = str(tmp_path / "run.mp4")
    rc = main(["run", "--n", "64", "--steps", "4", "--impl", "xla_nxn",
               "--viz-video", mp4, "--viz-every", "2", "--quiet"])
    assert rc == 0
    assert _parse_mp4(mp4)[0] == 2


def test_mp4_overflow_guard_fails_fast(tmp_path):
    """The 32-bit mdat/stco fields must reject the overflowing frame at
    add() time (before hours of frames stream), with a typed error rather
    than an opaque struct.error at close()."""
    pytest.importorskip("PIL")
    from nbody_tpu.viz.mp4 import Mp4Writer
    frame = np.zeros((8, 8, 3), np.uint8)
    w = Mp4Writer(str(tmp_path / "o.mp4"), 8, 8)
    w.add(frame)
    # Simulate a file whose next frame would push mdat past 4 GiB.
    w._mdat_off -= 1 << 32
    with pytest.raises(OverflowError, match="4 GiB"):
        w.add(frame)
    w._mdat_off += 1 << 32
    w.add(frame)
    w.close()
