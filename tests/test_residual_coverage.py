"""Residual edge-branch coverage from the round-5 sys.monitoring audit.

Each test pins a deterministic guard/fallback branch that production code
carries but no prior test reached (scripts/coverage_audit.py report): the
serve daemon's under-lock race rechecks, small-module validation raises,
WAV codec format edges, and the live-path import/default fallbacks."""

import json
import os
import struct
import sys
import threading
import time
import types

import numpy as np
import pytest

from jefferson_tpu.config import DEFAULT_CONFIG, EngineConfig
from jefferson_tpu.io.wavio import (
    StreamingWavWriter,
    _parse_chunks,
    read_wav,
    read_wav_info,
    read_wav_mono,
    write_wav,
)


# ---------------------------------------------------------------- config

def test_config_pad_len_guard_fires_for_subclasses():
    """__post_init__'s pad_len power-of-two assert is unreachable through
    the stock property (next_pow2 by construction) but guards subclasses
    that override the FFT-length policy."""

    class BrokenPad(EngineConfig):
        pad_len = property(lambda self: 1000)  # not a power of two

    with pytest.raises(AssertionError, match="power of two"):
        BrokenPad()


# -------------------------------------------------------------- resample

def test_resample_identity_passthrough():
    from jefferson_tpu.io.resample import resample

    x = np.arange(16, dtype=np.float64)
    y = resample(x, 44100, 44100)
    assert y.dtype == np.float32
    np.testing.assert_array_equal(y, x.astype(np.float32))


# ------------------------------------------------------------ trajectory

def test_trajectory_base_sample_is_abstract():
    from jefferson_tpu.trajectory.trajectory import Trajectory

    with pytest.raises(NotImplementedError):
        Trajectory().sample(4)


def test_position_events_requires_events():
    from jefferson_tpu.trajectory.trajectory import PositionEvents

    with pytest.raises(ValueError, match="at least one event"):
        PositionEvents([]).sample(4)


# ------------------------------------------------------------------- viz

def test_decimate_waveform_empty_and_short():
    from jefferson_tpu.viz.scene import decimate_waveform

    assert np.array_equal(decimate_waveform(np.zeros(0), bins=8), np.zeros(8))
    # shorter than bins: |x| padded into the head, zeros after
    out = decimate_waveform(np.array([-0.5, 0.25]), bins=8)
    np.testing.assert_allclose(out[:2], [0.5, 0.25])
    assert not out[2:].any()


def test_viz_writers_reject_empty_positions(tmp_path):
    from jefferson_tpu.viz.html import scene_html
    from jefferson_tpu.viz.scene import scene_svg
    from jefferson_tpu.viz.scene3d import scene3d_html

    empty = np.zeros((0, 3))
    samples = np.zeros((256, 2), np.float32)
    with pytest.raises(ValueError, match="at least one position"):
        scene_svg(empty, tmp_path / "s.svg")
    with pytest.raises(ValueError, match="at least one position"):
        scene_html(empty, samples, tmp_path / "s.html")
    with pytest.raises(ValueError, match="at least one position"):
        scene3d_html(empty, samples, tmp_path / "s3.html")


# ------------------------------------------------------------ wavio edges

def _wav_bytes(fmt_tag=1, channels=1, rate=44100, bits=16, data=b"",
               with_fmt=True, with_data=True):
    chunks = b""
    if with_fmt:
        align = channels * max(bits // 8, 1)
        fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate,
                          rate * align, align, bits)
        chunks += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if with_data:
        chunks += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def test_wavio_rejects_non_riff():
    with pytest.raises(ValueError, match="not a RIFF/WAVE"):
        _parse_chunks(b"this is not a wav file at all")


def test_wavio_missing_data_chunk(tmp_path):
    p = tmp_path / "nofmt.wav"
    p.write_bytes(_wav_bytes(with_data=False))
    with pytest.raises(ValueError, match="missing fmt/data"):
        read_wav(p)
    with pytest.raises(ValueError, match="missing fmt/data"):
        read_wav_info(p)


def test_wavio_rejects_zero_channels(tmp_path):
    p = tmp_path / "zero.wav"
    p.write_bytes(_wav_bytes(channels=0, data=b"\x00\x00"))
    with pytest.raises(ValueError, match="channels=0"):
        read_wav(p)


def test_wavio_pure_float32_read_and_bad_float_depth(tmp_path):
    # float64 dtype skips the native decoder: the pure f4 branch must decode
    vals = np.array([0.25, -0.5, 1.0], dtype="<f4")
    p = tmp_path / "f32.wav"
    p.write_bytes(_wav_bytes(fmt_tag=3, bits=32, data=vals.tobytes()))
    x, sr = read_wav(p, dtype=np.float64)
    assert sr == 44100 and x.dtype == np.float64
    np.testing.assert_allclose(x[:, 0], vals.astype(np.float64))

    bad = tmp_path / "f16.wav"
    bad.write_bytes(_wav_bytes(fmt_tag=3, bits=16, data=b"\x00" * 8))
    with pytest.raises(ValueError, match="unsupported float bit depth"):
        read_wav(bad, dtype=np.float64)


def test_wavio_mono_rejects_three_channels(tmp_path):
    data = np.zeros(6, dtype="<i2").tobytes()  # 2 frames x 3 channels
    p = tmp_path / "tri.wav"
    p.write_bytes(_wav_bytes(channels=3, data=data))
    with pytest.raises(ValueError, match="only mono or stereo"):
        read_wav_mono(p, dtype=np.float64)


def test_streaming_writer_rejects_channel_mismatch(tmp_path):
    w = StreamingWavWriter(tmp_path / "w.wav", 44100)
    try:
        with pytest.raises(ValueError, match="expected 2 channels"):
            w.write(np.zeros((8, 3), np.float32))
    finally:
        w.close()


# --------------------------------------------------------------- playout

def test_sounddevice_probe_returns_module(monkeypatch):
    import jefferson_tpu.rt.playout as pl

    fake = types.ModuleType("sounddevice")
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    assert pl._sounddevice() is fake


def test_playout_plain_callable_defaults_to_default_config():
    from jefferson_tpu.rt.playout import AudioPlayout

    play = AudioPlayout([lambda: np.zeros((128, 2), np.float32)])
    assert play.config is DEFAULT_CONFIG


def test_playout_unset_buf_raises(db, config):
    from jefferson_tpu.engine.stream import StreamingSpatializer
    from jefferson_tpu.rt.playout import AudioPlayout

    spat = StreamingSpatializer(db, config)  # .buf never set
    spat.set_position(azi=0, ele=0, r=1.0)
    play = AudioPlayout([spat], config)
    with pytest.raises(ValueError, match=r"needs \.buf"):
        play.run_offline(1)


def test_play_flushes_writer(db, config, castanets, monkeypatch, tmp_path):
    """The live (device) path flushes the writer before returning stats, so
    a capture is readable the moment play() returns."""
    import jefferson_tpu.rt.playout as pl
    from jefferson_tpu.rt.playout import AudioPlayout
    from test_playout import _FakeSD, _src

    monkeypatch.setattr(pl, "_sounddevice", lambda: _FakeSD())
    out = tmp_path / "cap.wav"
    w = StreamingWavWriter(out, config.sample_rate)
    play = AudioPlayout([_src(db, config, castanets)], config, writer=w)
    stats = play.play(num_blocks=2)
    assert stats.blocks == 2
    y, sr = read_wav(out)  # flushed: header already valid before close()
    assert sr == config.sample_rate
    assert y.shape[0] == 2 * config.frames_per_buffer
    w.close()


# --------------------------------------------------------------- control

def test_start_key_thread_survives_isatty_failure(monkeypatch):
    from jefferson_tpu.rt.control import SourceControl, start_key_thread

    class Broken:
        def isatty(self):
            raise RuntimeError("stdin gone")

    monkeypatch.setattr(sys, "stdin", Broken())
    assert start_key_thread(SourceControl()) is None


def test_tty_key_loop_discards_stale_carry_and_exits_on_eof():
    """A partial CSI kept over one timeout window is discarded after two
    (never decoded as a late move key), and pipe EOF ends the loop."""
    from jefferson_tpu.rt.control import SourceControl, tty_key_loop

    c = SourceControl()
    before = c.coordinates()
    r, w = os.pipe()
    t = threading.Thread(target=tty_key_loop, args=(c, r), daemon=True)
    t.start()
    try:
        os.write(w, b"\x1b[")      # partial CSI: carry, no key yet
        time.sleep(0.3)            # >2 empty 50 ms select windows: discarded
        os.close(w)                # EOF -> loop breaks
        w = None
        t.join(timeout=2.0)
        assert not t.is_alive()
        assert c.coordinates() == before  # the stale '[' never became a key
    finally:
        if w is not None:
            os.close(w)
        os.close(r)


# ------------------------------------------------------------- cli check

def test_check_rejects_sample_rate_mismatch(tmp_path, capsys):
    from jefferson_tpu.cli.check import main as check_main

    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    sig = np.zeros((64, 1), np.float32)
    write_wav(a, sig, 44100)
    write_wav(b, sig, 48000)
    assert check_main([str(a), str(b)]) == 1
    assert "sample rates differ" in capsys.readouterr().out


# ------------------------------------------------------------- cli main

def test_parse_trajectory_events_file(tmp_path):
    from jefferson_tpu.cli.main import parse_trajectory
    from jefferson_tpu.trajectory.trajectory import PositionEvents

    f = tmp_path / "ev.json"
    f.write_text(json.dumps([[0.0, 30.0, 0.0, 1.0], [0.5, 60.0, 5.0, 1.2]]))
    traj = parse_trajectory(f"events:{f}")
    assert isinstance(traj, PositionEvents)
    pos = traj.sample(8)
    assert pos.shape == (8, 3) and np.isfinite(pos).all()


def test_enable_compilation_cache_swallows_fs_errors(monkeypatch, tmp_path):
    """An unwritable cache directory leaves the cache off; the render runs."""
    import jax

    from jefferson_tpu.cli import main as cli_main

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir

    def boom(*a, **k):
        raise OSError("read-only filesystem")

    monkeypatch.setattr(os, "makedirs", boom)
    assert cli_main.enable_compilation_cache() is None  # must not raise
    assert jax.config.jax_compilation_cache_dir == before


def test_render_scene_spec_defaults_blocks_and_bounds_cache(
        db, config, castanets, tmp_path):
    """No blocks/duration -> length from the longest source; a caller cache
    is LRU-bounded so varied request shapes can't grow the daemon."""
    from jefferson_tpu.cli.main import _SCENE_RENDERER_CACHE_MAX, render_scene_spec

    src = tmp_path / "s.wav"
    write_wav(src, castanets[:4096], config.sample_rate)
    scene = {"sources": [
        {"input": str(src), "trajectory": "static:azi=30,ele=0,r=1.0"},
    ]}
    cache = {("dummy", i): object() for i in range(_SCENE_RENDERER_CACHE_MAX + 1)}
    out, nb = render_scene_spec(scene, db, config, renderer_cache=cache)
    assert nb == int(np.ceil(4096 / config.frames_per_buffer))
    assert out.shape == (nb * config.frames_per_buffer, 2)
    assert len(cache) <= _SCENE_RENDERER_CACHE_MAX
    assert ("dummy", 0) not in cache  # oldest evicted first


def test_cli_scene_rejects_unsupported_flags(tmp_path):
    from jefferson_tpu.cli.main import main

    with pytest.raises(SystemExit) as e:
        main(["--scene", str(tmp_path / "s.json"), "--backend", "fft",
              "--no-resample", "--profile-dir", str(tmp_path)])
    msg = str(e.value)
    assert "--backend" in msg and "--no-resample" in msg and "--profile-dir" in msg


def test_cli_nonfinite_render_aborts_and_clipping_alerts(
        config, castanets, tmp_path, monkeypatch, capsys):
    from jefferson_tpu.cli.main import main
    from jefferson_tpu.engine import renderer as rmod

    src = tmp_path / "in.wav"
    write_wav(src, castanets[:1024], config.sample_rate)
    out = tmp_path / "out.wav"

    def make_fake(val):
        def fake_render(self, signal, positions, ptype=0, *a, **k):
            n = len(positions) * config.frames_per_buffer
            return np.full((n, 2), val, np.float32)
        return fake_render

    monkeypatch.setattr(rmod.Renderer, "render", make_fake(np.nan))
    with pytest.raises(SystemExit, match="non-finite"):
        main(["-i", str(src), "-o", str(out), "--blocks", "4", "--quiet"])

    monkeypatch.setattr(rmod.Renderer, "render", make_fake(1.5))
    main(["-i", str(src), "-o", str(out), "--blocks", "4", "--quiet"])
    assert "CLIPPING" in capsys.readouterr().err


# ----------------------------------------------------------------- serve

@pytest.fixture(scope="module")
def svc():
    from jefferson_tpu.serve import RenderService

    return RenderService(hrtf_dir=None, chunk_blocks=64)


@pytest.fixture()
def stream_wav(config, castanets, tmp_path):
    p = tmp_path / "in.wav"
    write_wav(p, castanets[:4096], config.sample_rate)
    return p


def test_serve_render_duration_path(svc, config, stream_wav, tmp_path):
    out = tmp_path / "o.wav"
    r = svc.handle({"cmd": "render", "input": str(stream_wav),
                    "output": str(out), "duration": 0.05})
    assert r["ok"]
    assert r["blocks"] == int(np.ceil(0.05 / config.block_duration))
    bad = svc.handle({"cmd": "render", "input": str(stream_wav),
                      "output": str(out), "duration": 0.0})
    assert not bad["ok"] and "must be positive" in bad["error"]


def test_serve_render_nonfinite_reported(svc, stream_wav, tmp_path, monkeypatch):
    def nan_render(signal, positions, ptype=0, *a, **k):
        n = len(positions) * svc.config.frames_per_buffer
        return np.full((n, 2), np.nan, np.float32)

    monkeypatch.setattr(svc.renderer, "render", nan_render)
    r = svc.handle({"cmd": "render", "input": str(stream_wav),
                    "output": str(tmp_path / "o.wav"), "blocks": 4})
    assert not r["ok"] and "non-finite" in r["error"]


def test_serve_scene_nonfinite_reported(svc, stream_wav, tmp_path, monkeypatch):
    import jefferson_tpu.cli.main as cli_main

    monkeypatch.setattr(
        cli_main, "render_scene_spec",
        lambda *a, **k: (np.full((256, 2), np.nan, np.float32), 2))
    scene = {"sources": [{"input": str(stream_wav),
                          "trajectory": "static:azi=0,ele=0,r=1.0"}]}
    r = svc.handle({"cmd": "scene", "scene": scene,
                    "output": str(tmp_path / "m.wav")})
    assert not r["ok"] and "non-finite" in r["error"]


class _FlipGate:
    """max_streams stand-in: capacity OK at the unlocked pre-check, at
    capacity at the authoritative under-lock recheck — the race where a
    session registers between the two."""

    def __init__(self):
        self.calls = 0

    def __le__(self, other):  # evaluated for `sum(...) >= gate`
        self.calls += 1
        return self.calls >= 2

    def __repr__(self):
        return "flip-gate"


def test_serve_stream_capacity_recheck_under_lock(svc, stream_wav, tmp_path):
    gate = _FlipGate()
    svc.max_streams = gate
    try:
        r = svc._stream_start({"input": str(stream_wav), "paced": False,
                               "seconds": 0.05,
                               "output": str(tmp_path / "s.wav")})
        assert not r["ok"] and "too many active stream sessions" in r["error"]
        assert gate.calls == 2  # pre-check passed, locked recheck refused
        assert not svc._streams  # nothing registered
    finally:
        svc.max_streams = 8


def test_serve_stream_start_prunes_oldest_ended(svc, stream_wav, tmp_path):
    dead = lambda: types.SimpleNamespace(is_alive=lambda: False, ident=1)
    svc._streams = {
        f"e{i}": {"thread": dead(), "control": None, "play": None,
                  "spat": None, "output": "x", "blocks": 1}
        for i in range(svc.max_ended_retained + 1)
    }
    r = svc._stream_start({"input": str(stream_wav), "paced": False,
                           "seconds": 0.05,
                           "output": str(tmp_path / "p.wav")})
    assert r["ok"]
    try:
        assert "e0" not in svc._streams        # oldest ended pruned
        assert "e1" in svc._streams            # retention cap kept the rest
    finally:
        stop = svc._stream_stop({"session": r["session"]})
        assert stop["ok"]
        svc._streams = {}


def test_serve_stream_stop_reports_hung_thread(svc):
    from jefferson_tpu.rt.control import SourceControl

    hung = types.SimpleNamespace(is_alive=lambda: True,
                                 join=lambda timeout=None: None, ident=1)
    svc._streams = {"hung": {"thread": hung, "control": SourceControl(),
                             "play": None, "spat": None,
                             "output": "x", "blocks": 1}}
    try:
        r = svc._stream_stop({"session": "hung"})
        assert not r["ok"] and "did not stop" in r["error"]
        assert svc._streams["hung"]["control"].quit  # quit was requested
    finally:
        svc._streams = {}


# ------------------------------------------------- renderer edge arms

def _mover32(config):
    from jefferson_tpu.trajectory.trajectory import CircularOrbit

    return CircularOrbit(period_s=0.3, ele=5, r=1.0).sample(32, config)


def test_render_plan_rejects_broken_invariant(db, config, castanets):
    from jefferson_tpu.engine.plan import make_plan
    from jefferson_tpu.engine.renderer import Renderer

    plan = make_plan(_mover32(config), config)
    plan.idx_old[1, 0] = (plan.idx_old[1, 0] + 1) % config.num_hrtf
    with pytest.raises(ValueError, match="previous\\s+block's new arrays"):
        Renderer(db, chunk_blocks=8).render_plan(
            castanets[:4000], plan)


def test_fft_backend_no_crossfade_chunk(db, config, castanets):
    """A crossfade-free render through the fft backend (complex64 + XLA's
    FFT) matches the split-plane matmul backend."""
    from jefferson_tpu.engine.renderer import Renderer
    from jefferson_tpu.testing import precision_check

    pos = np.tile(np.array([0.0, 0.0, 0.5]), (16, 1))
    sig = castanets[:4000]
    a = Renderer(db, chunk_blocks=8, backend="fft").render(sig, pos)
    b = Renderer(db, chunk_blocks=8).render(sig, pos)
    rep = precision_check(a, b, eps=5e-7)
    assert rep.ok, str(rep)


def test_batch_dedup_varied_radius(db, config, castanets):
    """Twelve sources holding twelve radii: the batch dedup program keeps
    per-row distance ramps and is bit-exact against the direct program."""
    from jefferson_tpu.engine.batch import BatchRenderer

    s = 12
    signals = np.stack([np.roll(castanets[:2048], 7 * i) for i in range(s)])
    positions = np.stack([
        np.tile(np.array([10.0 * i, 0.0, 0.3 + 0.05 * i]), (16, 1))
        for i in range(s)
    ])
    br = BatchRenderer(db, config, chunk_blocks=16, dedup=True)
    got = br.render(signals, positions)
    assert all(k[1] is not None for k in br._jitted), list(br._jitted)
    want = BatchRenderer(db, config, chunk_blocks=16,
                         dedup=False).render(signals, positions)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------- multihost launcher arms

def test_multihost_launcher_fails_fast_and_reaps(monkeypatch):
    """One dead worker fails the dryrun immediately (collectives would
    strand the rest), survivors are reaped, logs are surfaced."""
    import subprocess

    import jefferson_tpu.parallel.multihost as mh

    insts = []

    class FakePopen:
        def __init__(self, cmd, env=None, stdout=None, stderr=None):
            self.i = len(insts)
            insts.append(self)
            self.killed = False

        def poll(self):
            if self.i == 0:
                return 1  # worker 0 died at once
            return -9 if self.killed else None

        def kill(self):
            self.killed = True

        def wait(self):
            return -9

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    with pytest.raises(RuntimeError, match="multi-process dryrun failed"):
        mh._run_once(2, 1, timeout=5.0)
    assert insts[1].killed  # the survivor was reaped, not leaked


def test_multihost_launcher_times_out_hung_workers(monkeypatch):
    import subprocess

    import jefferson_tpu.parallel.multihost as mh

    insts = []

    class HungPopen:
        def __init__(self, cmd, env=None, stdout=None, stderr=None):
            insts.append(self)
            self.killed = False

        def poll(self):
            return -9 if self.killed else None

        def kill(self):
            self.killed = True

        def wait(self):
            return -9

    monkeypatch.setattr(subprocess, "Popen", HungPopen)
    with pytest.raises(RuntimeError, match="timeout"):
        mh._run_once(2, 1, timeout=0.3)
    assert all(p.killed for p in insts)


def test_multihost_retries_once_on_timeout(monkeypatch):
    """A coordinator-port race (timeout) is retried once on a fresh port;
    any other failure propagates immediately."""
    import jefferson_tpu.parallel.multihost as mh

    calls = {"n": 0}

    def flaky(num_processes, local_devices, timeout):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("multi-process dryrun failed: timeout")

    monkeypatch.setattr(mh, "_run_once", flaky)
    mh.run_multiprocess_dryrun(2, 1, timeout=1.0)
    assert calls["n"] == 2

    def hard(num_processes, local_devices, timeout):
        calls["n"] += 1
        raise RuntimeError("worker crashed: segfault")

    monkeypatch.setattr(mh, "_run_once", hard)
    with pytest.raises(RuntimeError, match="segfault"):
        mh.run_multiprocess_dryrun(2, 1, timeout=1.0)
    assert calls["n"] == 3  # no retry for non-timeout failures


# ----------------------------------------------------- sweep gate harness

def test_sweep_dispatch_classifier_names_all_arms():
    from jefferson_tpu.bench.sweep import _batch_dispatches

    br = types.SimpleNamespace(_jitted={
        (16, 8, True): None,      # dedup
        (16, None, False): None,  # direct
    })
    assert _batch_dispatches(br) == {"dedup", "direct"}


def test_sweep_scene_gate_rejects_unknown_scenario(db, config):
    from jefferson_tpu.bench.sweep import run_scene_gate

    with pytest.raises(ValueError, match="unknown scene scenario"):
        run_scene_gate(np.zeros(1024, np.float32), db, config,
                       scenario="bogus")


# ------------------------------------------------------------ rt __main__

def test_rt_main_live_path_through_fake_device(
        db, config, castanets, tmp_path, monkeypatch, capsys):
    import jefferson_tpu.rt.playout as pl
    from jefferson_tpu.rt.__main__ import main
    from test_playout import _FakeSD

    monkeypatch.setattr(pl, "_sounddevice", lambda: _FakeSD())
    src = tmp_path / "in.wav"
    write_wav(src, castanets[:4096], config.sample_rate)
    out = tmp_path / "live.wav"
    assert main(["-i", str(src), "-o", str(out), "--live",
                 "--seconds", "0.02"]) == 0
    y, sr = read_wav(out)
    assert sr == config.sample_rate and y.shape[0] > 0


def test_rt_main_clipping_alert(db, config, castanets, tmp_path, capsys):
    from jefferson_tpu.rt.__main__ import main

    src = tmp_path / "loud.wav"
    # float WAV carries >1.0 amplitudes, so the rendered blocks must clip
    write_wav(src, castanets[:4096] * 200.0,
              config.sample_rate, bits=32, float_format=True)
    out = tmp_path / "clip.wav"
    assert main(["-i", str(src), "-o", str(out), "--seconds", "0.02"]) == 0
    assert "CLIPPING" in capsys.readouterr().err


def test_serve_render_defaults_blocks_from_input_length(
        svc, config, stream_wav, tmp_path):
    """Neither blocks nor duration: one full pass of the input."""
    r = svc.handle({"cmd": "render", "input": str(stream_wav),
                    "output": str(tmp_path / "d.wav")})
    assert r["ok"]
    assert r["blocks"] == int(np.ceil(4096 / config.frames_per_buffer))
