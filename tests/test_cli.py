"""CLI tests: flag surface, trajectory parsing, scene rendering, gates."""

import json

import numpy as np
import pytest

from jefferson_tpu.cli.main import main as cli_main, parse_trajectory
from jefferson_tpu.cli.check import main as check_main
from jefferson_tpu.io.wavio import read_wav, write_wav


@pytest.fixture
def wav_in(tmp_path, castanets):
    p = tmp_path / "in.wav"
    write_wav(p, castanets[:16000], 44100, bits=24)
    return p


def _run(args):
    return cli_main([str(a) for a in args])


def test_chunk_blocks_validation(tmp_path, wav_in):
    """0/negative --chunk-blocks is user error (not a default request), and
    the mesh-divisibility message names the EFFECTIVE default when the flag
    was never passed."""
    out = tmp_path / "out.wav"
    for bad in (0, -4):
        with pytest.raises(SystemExit, match="positive block count"):
            _run(["-i", wav_in, "-o", out, "--chunk-blocks", bad, "--quiet"])
    with pytest.raises(SystemExit, match="default chunk size 2048"):
        _run(["-i", wav_in, "-o", out, "--devices", 3, "--quiet"])


def test_render_roundtrip(tmp_path, wav_in, monkeypatch):
    monkeypatch.setenv("JEFFERSON_HRTF_DIR", "")  # force synthetic
    out = tmp_path / "out.wav"
    rc = _run(["-i", wav_in, "-o", out, "-t", 0, "--blocks", 20,
               "--trajectory", "orbit:period=1,r=1", "--chunk-blocks", 16, "--quiet"])
    assert rc == 0
    y, sr = read_wav(out)
    assert sr == 44100 and y.shape == (20 * 128, 2)
    assert np.abs(y).max() > 1e-4


def test_oracle_and_engine_agree_via_cli(tmp_path, wav_in):
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    common = ["-i", wav_in, "--blocks", 12, "--trajectory", "static:azi=40,ele=10,r=1",
              "--chunk-blocks", 12, "--quiet", "--float", "--bits", 32]
    assert _run(["-t", 0, "-o", a] + common) == 0
    assert _run(["-t", 3, "-o", b] + common) == 0
    assert check_main([str(a), str(b), "--eps", "1e-6"]) == 0
    # and the gate really fails on different content
    assert check_main([str(a), str(wav_in), "--eps", "1e-6"]) == 1


def test_scene_rendering(tmp_path, wav_in, castanets):
    second = tmp_path / "in2.wav"
    write_wav(second, np.roll(castanets, 777)[:12000], 44100, bits=24)
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps({
        "sources": [
            {"input": str(wav_in), "trajectory": "orbit:period=1,r=1", "gain": 0.8},
            {"input": str(second), "trajectory": "static:azi=270,ele=0,r=2", "gain": 0.5},
        ]
    }))
    out = tmp_path / "mix.wav"
    rc = _run(["--scene", scene, "-o", out, "--blocks", 16, "--chunk-blocks", 16, "--quiet"])
    assert rc == 0
    y, _ = read_wav(out)
    assert y.shape == (16 * 128, 2) and np.abs(y).max() > 1e-4


def test_trajectory_parsing():
    t = parse_trajectory("static:azi=30,ele=-10,r=2")
    assert (t.azi, t.ele, t.r) == (30, -10, 2)
    t = parse_trajectory("orbit:period=4,start=90")
    assert t.period_s == 4 and t.start_azi == 90
    t = parse_trajectory("sweep:start=10,blocks=5,steps=3")
    assert t.blocks_per_step == 5 and t.num_steps == 3
    t = parse_trajectory("path:0,0,1:1,0,-1:2.5")
    assert t.duration_s == 2.5
    # ValueError, NOT SystemExit: the parser is shared with the daemon,
    # whose per-request handler catches Exception — SystemExit escaped it
    # and silently dropped the client connection (review finding)
    with pytest.raises(ValueError):
        parse_trajectory("spiral:x=1")
    with pytest.raises(ValueError):
        parse_trajectory("orbit:frequency=2")
    with pytest.raises(ValueError, match="needs a number"):
        parse_trajectory("static:azi=abc")
    with pytest.raises(ValueError, match="needs a number"):
        parse_trajectory("static:azi")
    with pytest.raises(ValueError, match="not found"):
        parse_trajectory("events:/nonexistent/events.json")


def test_empty_scene_rejected(tmp_path):
    scene = tmp_path / "empty.json"
    scene.write_text(json.dumps({"sources": []}))
    with pytest.raises(SystemExit):
        _run(["--scene", scene, "-o", tmp_path / "x.wav", "--quiet"])


def test_resampling_input(tmp_path, castanets):
    """22.05 kHz input is resampled to the engine rate by default."""
    p = tmp_path / "in22.wav"
    write_wav(p, castanets[:8000], 22050, bits=16)
    out = tmp_path / "o.wav"
    rc = _run(["-i", p, "-o", out, "--blocks", 10, "--chunk-blocks", 10, "--quiet"])
    assert rc == 0
    y, sr = read_wav(out)
    assert sr == 44100 and y.shape[0] == 1280


def test_resample_function():
    from jefferson_tpu.io.resample import resample

    t = np.arange(22050) / 22050
    sig = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    up = resample(sig, 22050, 44100)
    assert abs(len(up) - 44100) <= 2
    # the tone frequency is preserved
    spec = np.abs(np.fft.rfft(up[:32768] * np.hanning(32768)))
    peak_hz = np.argmax(spec) * 44100 / 32768
    assert abs(peak_hz - 440) < 3


def test_selftest_flag(tmp_path, wav_in):
    out = tmp_path / "st.wav"
    rc = _run(["-i", wav_in, "-o", out, "--blocks", 8, "--chunk-blocks", 8,
               "--selftest", "--quiet"])
    assert rc == 0
    assert out.exists()


def test_device_cpu_flag(tmp_path, wav_in, monkeypatch):
    """--device cpu applies the jax_platforms=cpu config override BEFORE
    rendering (the only reliable override where a site preload pins the
    booted platform — env vars are too late by CLI entry).

    The suite's conftest already forces CPU session-wide, so asserting the
    resulting platform alone could never fail; instead record the config
    call the flag exists to make."""
    import jax

    calls = []
    orig_update = jax.config.update

    def recording_update(name, value):
        calls.append((name, value))
        return orig_update(name, value)

    monkeypatch.setattr(jax.config, "update", recording_update)
    out = tmp_path / "dev.wav"
    rc = _run(["-i", wav_in, "-o", out, "--blocks", 8, "--device", "cpu",
               "--trajectory", "orbit:period=1,r=1", "--quiet"])
    assert rc == 0
    assert ("jax_platforms", "cpu") in calls, calls
    assert jax.devices()[0].platform == "cpu"
    y, _ = read_wav(out)
    assert y.shape[0] == 8 * 128 and np.isfinite(y).all()


def test_device_native_flag_leaves_platform_alone(tmp_path, wav_in, monkeypatch):
    """--device native (the default) must NOT touch jax_platforms — on a
    direct-attached accelerator the booted platform is the right one."""
    import jax

    calls = []
    orig_update = jax.config.update

    def recording_update(name, value):
        calls.append((name, value))
        return orig_update(name, value)

    monkeypatch.setattr(jax.config, "update", recording_update)
    out = tmp_path / "devn.wav"
    rc = _run(["-i", wav_in, "-o", out, "--blocks", 8, "--device", "native",
               "--trajectory", "orbit:period=1,r=1", "--quiet"])
    assert rc == 0
    assert ("jax_platforms", "cpu") not in calls, calls


def test_float_flag_with_default_bits(tmp_path, wav_in, monkeypatch):
    """--float with the DEFAULT --bits 24 used to complete the render and
    then die in _encode (round-5 review); it now writes an IEEE float32
    WAV (fmt tag 3, 32 bits)."""
    import struct

    monkeypatch.setenv("JEFFERSON_HRTF_DIR", "")
    out = tmp_path / "out.wav"
    rc = _run(["-i", wav_in, "-o", out, "--blocks", 8, "--chunk-blocks", 8,
               "--float", "--quiet"])
    assert rc == 0
    hdr = out.read_bytes()[:36]
    fmt_tag, _, _, _, _, bits = struct.unpack_from("<HHIIHH", hdr, 20)
    assert fmt_tag == 3 and bits == 32  # WAVE_FORMAT_IEEE_FLOAT
    y, sr = read_wav(out)
    assert sr == 44100 and np.isfinite(y).all()


def test_scene_source_resampled(tmp_path, db, config, castanets):
    """A scene source at the wrong sample rate is resampled like the
    single-source paths (it used to be fed raw — pitch-shifted — with only
    a warning, and silently via the daemon)."""
    from jefferson_tpu.cli.main import render_scene_spec
    from jefferson_tpu.io.resample import resample

    raw = castanets[:8000]
    lo = tmp_path / "lo.wav"
    write_wav(lo, raw, 22050, bits=32, float_format=True)  # exact roundtrip
    hi = tmp_path / "hi.wav"
    write_wav(hi, resample(raw, 22050, config.sample_rate), config.sample_rate,
              bits=32, float_format=True)

    def scene(p):
        return {"sources": [{"input": str(p),
                             "trajectory": "static:azi=30,ele=0,r=1"}]}

    out_lo, _ = render_scene_spec(scene(lo), db, config, num_blocks=8, chunk_blocks=8)
    out_hi, _ = render_scene_spec(scene(hi), db, config, num_blocks=8, chunk_blocks=8)
    np.testing.assert_array_equal(out_lo, out_hi)


def test_scene_rejects_bad_blocks_and_empty_source(tmp_path, db, config):
    """Explicit blocks=0 / duration=0 and empty sources are clean errors,
    not a silent fallback to the input length."""
    from jefferson_tpu.cli.main import render_scene_spec

    empty = tmp_path / "empty.wav"
    write_wav(empty, np.zeros(0, np.float32), 44100)
    sc = {"sources": [{"input": str(empty), "trajectory": "static:azi=0,ele=0,r=1"}]}
    with pytest.raises(ValueError, match="is empty"):
        render_scene_spec(sc, db, config, num_blocks=4)
    ok = tmp_path / "ok.wav"
    write_wav(ok, np.ones(512, np.float32) * 0.1, 44100)
    sc = {"sources": [{"input": str(ok), "trajectory": "static:azi=0,ele=0,r=1"}]}
    with pytest.raises(ValueError, match="blocks .0. must be positive"):
        render_scene_spec(sc, db, config, num_blocks=0)
    with pytest.raises(ValueError, match="duration .0.*must be positive"):
        render_scene_spec(sc, db, config, duration=0.0)


def test_empty_input_rejected(tmp_path, monkeypatch):
    monkeypatch.setenv("JEFFERSON_HRTF_DIR", "")
    empty = tmp_path / "empty.wav"
    write_wav(empty, np.zeros(0, np.float32), 44100)
    with pytest.raises(SystemExit, match="is empty"):
        _run(["-i", empty, "-o", tmp_path / "out.wav", "--quiet"])


def test_renderer_constructors_reject_bad_chunk_blocks(db, config):
    from jefferson_tpu.engine.batch import BatchRenderer
    from jefferson_tpu.engine.renderer import Renderer

    with pytest.raises(ValueError, match="must be positive"):
        Renderer(db, config, chunk_blocks=0)
    with pytest.raises(ValueError, match="must be positive"):
        BatchRenderer(db, config, chunk_blocks=-1)


def test_scene_rejects_unsupported_flags(tmp_path, castanets, config):
    """Flags the batched scene pipeline does not implement must error, not
    silently not-apply (a --scene -r render without reverb was a silent
    lie; review finding)."""
    from jefferson_tpu.io.wavio import write_wav

    src = tmp_path / "s.wav"
    write_wav(src, castanets[:3000], config.sample_rate)
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps({"sources": [
        {"input": str(src), "trajectory": "static:azi=0"}]}))
    base = ["--scene", str(scene), "-o", str(tmp_path / "o.wav"), "--quiet",
            "--blocks", "4"]
    for extra in (["-r", str(src)], ["--viz"],
                  ["-t", "3"], ["-i", str(src)], ["--initial-old", "none"]):
        with pytest.raises(SystemExit, match="scene does not support"):
            _run(base + extra)
    _run(base)  # and without them the same scene renders


def test_single_source_blocks_validation(tmp_path, castanets, config):
    from jefferson_tpu.io.wavio import write_wav

    src = tmp_path / "in.wav"
    write_wav(src, castanets[:3000], config.sample_rate)
    base = ["-i", str(src), "-o", str(tmp_path / "o.wav"), "--quiet"]
    with pytest.raises(SystemExit, match="--blocks 0 must be positive"):
        _run(base + ["--blocks", "0"])
    with pytest.raises(SystemExit, match="--duration -1.0 must be positive"):
        _run(base + ["--duration", "-1"])
    with pytest.raises(SystemExit, match="initial-old"):
        _run(base + ["--blocks", "2", "--initial-old", "0,0,0"])
    with pytest.raises(SystemExit, match="needs a number"):
        _run(base + ["--blocks", "2", "--trajectory", "static:azi=abc"])


def test_check_fails_on_length_mismatch(tmp_path, castanets, config):
    """jefferson-check must FAIL on truncated/empty renders, not pass on
    the overlapping prefix (review finding)."""
    from jefferson_tpu.cli.check import main as check_main
    from jefferson_tpu.io.wavio import write_wav

    full = np.stack([castanets[:2000]] * 2, axis=-1)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(a, full, config.sample_rate)
    write_wav(b, full[:1500], config.sample_rate)  # truncated render
    assert check_main([str(a), str(b)]) == 1
    write_wav(b, full[:0], config.sample_rate)  # header-only render
    assert check_main([str(a), str(b)]) == 1
    write_wav(b, full, config.sample_rate)
    assert check_main([str(a), str(b)]) == 0


def test_version_flag(capsys):
    import pytest

    from jefferson_tpu import __version__

    with pytest.raises(SystemExit) as e:
        cli_main(["--version"])
    assert e.value.code == 0
    assert f"jefferson_tpu {__version__}" in capsys.readouterr().out


def test_cli_error_paths(tmp_path, wav_in):
    """The one-line SystemExit guards on the main CLI entry: missing input,
    broken scene files, reverb-mode without an IR, and a nonexistent HRTF
    dir all fail loudly with the documented messages."""
    with pytest.raises(SystemExit, match="missing -i/--input"):
        _run(["-o", tmp_path / "o.wav"])
    with pytest.raises(SystemExit, match="not found"):
        _run(["--scene", tmp_path / "nope.json", "-o", tmp_path / "o.wav"])
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(SystemExit, match="bad JSON"):
        _run(["--scene", bad, "-o", tmp_path / "o.wav"])
    with pytest.raises(SystemExit, match="requires -r/--reverb"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--reverb-mode", "linear"])
    with pytest.raises(SystemExit, match="does not exist"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav",
              "--hrtf-dir", tmp_path / "no_such_hrtf"])
    with pytest.raises(SystemExit, match="must be positive"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--blocks", "0"])
    with pytest.raises(SystemExit, match="must be positive"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--duration", "-1"])


def test_events_trajectory_bad_json(tmp_path):
    bad = tmp_path / "ev.json"
    bad.write_text("[[0, 10,")
    with pytest.raises(ValueError, match="bad JSON"):
        parse_trajectory(f"events:{bad}")
    with pytest.raises(ValueError, match="path spec"):
        parse_trajectory("path:0,0,1:1,0,-1")  # missing duration part
    with pytest.raises(ValueError, match="numeric"):
        parse_trajectory("path:a,b,c:1,0,-1:2.0")


def test_viz_flag_writes_all_artifacts(tmp_path, wav_in):
    """--viz writes the four self-contained artifacts next to the output
    WAV: top-down SVG, waveform SVG, synced HTML player, 3-D player."""
    out = tmp_path / "v.wav"
    rc = _run(["-i", wav_in, "-o", out, "--blocks", "8",
               "--trajectory", "orbit:period=1", "--viz", "--quiet"])
    assert rc == 0
    for suffix in (".scene.svg", ".wave.svg", ".html", ".3d.html"):
        p = tmp_path / f"v.wav{suffix}"
        assert p.exists() and p.stat().st_size > 200, suffix
    html = (tmp_path / "v.wav.html").read_text()
    # the SYNCED PLAYER must embed real audio — the scene <svg> alone is in
    # every artifact, so an OR with it could never fail (round-5 test review)
    assert "<audio" in html and "<svg" in html


def test_initial_old_parsing(tmp_path, wav_in):
    """--initial-old accepts 'none' and 'azi,ele'; rejects non-numeric and
    wrong arity (the 0,0,0 case is covered elsewhere)."""
    out = tmp_path / "io.wav"
    assert _run(["-i", wav_in, "-o", out, "--blocks", "2",
                 "--initial-old", "none", "--quiet"]) == 0
    assert _run(["-i", wav_in, "-o", out, "--blocks", "2",
                 "--initial-old", "30,-10", "--quiet"]) == 0
    with pytest.raises(SystemExit, match="initial-old"):
        _run(["-i", wav_in, "-o", out, "--blocks", "2", "--initial-old", "a,b"])


def test_non_quiet_render_and_scene_summaries(tmp_path, wav_in, castanets, capsys):
    """Without --quiet the CLI narrates its work: render summary, scene
    source resample notice, scene summary, and the --duration block count."""
    out = tmp_path / "out.wav"
    rc = _run(["-i", wav_in, "-o", out, "--blocks", 6,
               "--trajectory", "static:azi=10,ele=0,r=1", "--chunk-blocks", 6])
    assert rc == 0
    err = capsys.readouterr().err
    assert "x real time ->" in err and "TPU_FD_COMPLEX: 6 blocks" in err

    # scene: one 22.05 kHz source (resample notice) + --duration sizing
    foreign = tmp_path / "f22k.wav"
    write_wav(foreign, castanets[:8000], 22050, bits=16)
    scene = {"sources": [
        {"input": str(foreign), "trajectory": "static:azi=0,ele=0,r=1"},
    ]}
    spath = tmp_path / "scene.json"
    spath.write_text(json.dumps(scene))
    sout = tmp_path / "scene_out.wav"
    # 3.5 blocks' worth of seconds: ceil() must size the scene at 4 blocks
    # (an exact 4-block duration would be at the mercy of float rounding)
    duration = 3.5 * 128 / 44100.0
    rc2 = _run(["--scene", spath, "-o", sout, "--duration", f"{duration:.8f}",
                "--chunk-blocks", 4])
    assert rc2 == 0
    err2 = capsys.readouterr().err
    assert "resampled" in err2 and "22050 -> 44100" in err2
    assert "scene: 1 sources, 4 blocks" in err2
    y, sr = read_wav(sout)
    assert sr == 44100 and y.shape == (4 * 128, 2)


def test_scene_mesh_shrink_warning(capsys):
    """--devices that doesn't divide the source count shrinks to the largest
    divisor, loudly when not quiet."""
    from jefferson_tpu.cli.main import scene_mesh

    m = scene_mesh(num_sources=6, devices=4, quiet=False)
    assert m is not None and m.shape == {"src": 3}
    assert "shrunk to 3" in capsys.readouterr().err
    # quiet path stays silent; devices<=1 means no mesh at all
    assert scene_mesh(6, 4, quiet=True).shape == {"src": 3}
    assert capsys.readouterr().err == ""
    assert scene_mesh(6, 1) is None
    assert scene_mesh(5, 3, quiet=True) is None  # shrinks all the way to 1


def test_reverb_reference_mode_and_ir_resample(tmp_path, wav_in, castanets, capsys):
    """-r with --reverb-mode reference: a foreign-rate IR is resampled (with
    a notice) and the reference-semantics convolution runs."""
    ir = np.zeros(400, np.float32)
    ir[0], ir[200] = 1.0, 0.5
    ir_path = tmp_path / "ir22k.wav"
    write_wav(ir_path, ir, 22050, bits=16)
    out = tmp_path / "wet.wav"
    rc = _run(["-i", wav_in, "-o", out, "--blocks", 6, "-r", ir_path,
               "--reverb-mode", "reference",
               "--trajectory", "static:azi=0,ele=0,r=1", "--chunk-blocks", 6])
    assert rc == 0
    err = capsys.readouterr().err
    assert "resampled reverb IR 22050 -> 44100" in err
    assert "reverb (reference):" in err
    y, _ = read_wav(out)
    assert np.abs(y).max() > 1e-4


def test_scene_renderer_cache_quantizes_short_durations(tmp_path, db, config, castanets):
    """Daemon-style scene requests with varying SHORT durations share one
    pow2-quantized cache key instead of minting a BatchRenderer (and a
    compiled-program set) per novel duration (round-5 review)."""
    from jefferson_tpu.cli.main import render_scene_spec

    src = tmp_path / "s.wav"
    write_wav(src, castanets[:8000], config.sample_rate)
    scene = {"sources": [
        {"input": str(src), "trajectory": "static:azi=20,ele=0,r=1"},
    ]}
    cache = {}
    for nb in (5, 7, 8):  # all quantize to the cb=8 bucket
        out, got_nb = render_scene_spec(
            scene, db, config, num_blocks=nb, chunk_blocks=64,
            renderer_cache=cache,
        )
        assert got_nb == nb and out.shape == (nb * config.frames_per_buffer, 2)
    assert list(cache) == [(8, None)]
    # a longer request lands in its own bucket, capped at the request size
    render_scene_spec(scene, db, config, num_blocks=48, chunk_blocks=64,
                      renderer_cache=cache)
    assert set(cache) == {(8, None), (64, None)}


def test_no_resample_warning_and_selftest_messages(tmp_path, castanets, db,
                                                   monkeypatch, capsys):
    """--no-resample renders a foreign-rate input raw with the pitch-shift
    warning; --selftest narrates its pass when not quiet, exits with the
    scenario name when the gate fails, and --viz narrates its artifacts."""
    import jefferson_tpu.bench.sweep as sweep_mod
    import jefferson_tpu.cli.main as cli_main

    monkeypatch.setattr(cli_main, "load_hrtf", lambda *a, **k: db)
    p22 = tmp_path / "in22.wav"
    write_wav(p22, castanets[:8000], 22050, bits=16)
    out = tmp_path / "raw.wav"
    rc = _run(["-i", p22, "-o", out, "--blocks", 6, "--chunk-blocks", 6,
               "--no-resample"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "rendering raw (pitch-shifted" in err

    src = tmp_path / "in.wav"
    write_wav(src, castanets[:16000], 44100, bits=16)
    rc = _run(["-i", src, "-o", out, "--blocks", 8, "--chunk-blocks", 8,
               "--selftest", "--viz"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "selftest passed" in err and "scaled smoke" in err
    assert "viz:" in err and ".3d.html" in err

    # a failing gate exits naming the scenario, before any render happens
    from jefferson_tpu.testing import PrecisionReport

    bad = PrecisionReport(ok=False, max_abs_diff=1.0, max_index=0,
                          first_bad_index=0, rms=1.0, eps=2e-7)
    monkeypatch.setattr(sweep_mod, "run_benchmark_sweep",
                        lambda *a, **k: [bad])
    with pytest.raises(SystemExit, match="selftest FAILED at scenario"):
        _run(["-i", src, "-o", out, "--blocks", 8, "--chunk-blocks", 8,
              "--selftest", "--quiet"])


def test_selftest_full_runs_reference_workload(tmp_path, castanets, db,
                                               monkeypatch, capsys):
    """--selftest-full maps to the reference's unconditional benchmarkTesting
    (main.cu:88): the FULL-scale sweep (172 blocks/step x 72 steps) plus the
    per-block mover gate, sharing ONE renderer so the classic scenarios and
    the mover don't re-pay identical compiles.  Mocked here — the real
    full-scale run is the on-chip `bench.sweep` gate."""
    import jefferson_tpu.bench.sweep as sweep_mod
    import jefferson_tpu.cli.main as cli_main
    from jefferson_tpu.testing import PrecisionReport

    monkeypatch.setattr(cli_main, "load_hrtf", lambda *a, **k: db)
    ok = PrecisionReport(ok=True, max_abs_diff=1e-9, max_index=0,
                         first_bad_index=-1, rms=1e-10, eps=2e-7)
    seen = {}

    def fake_sweep(signal, db_, config, **kw):
        seen["sweep_kw"] = kw
        return [ok] * len(sweep_mod.SCENARIOS)

    def fake_mover(signal, db_, config, **kw):
        seen["mover_kw"] = kw
        return ok

    monkeypatch.setattr(sweep_mod, "run_benchmark_sweep", fake_sweep)
    monkeypatch.setattr(sweep_mod, "run_mover_gate", fake_mover)

    src = tmp_path / "in.wav"
    write_wav(src, castanets[:16000], 44100, bits=16)
    out = tmp_path / "out.wav"
    rc = _run(["-i", src, "-o", out, "--blocks", 8, "--chunk-blocks", 8,
               "--selftest-full"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "selftest passed" in err and "full benchmarkTesting" in err
    # the reference cadence, full scale, not the scaled smoke numbers
    assert seen["sweep_kw"]["blocks_per_step"] == 172
    assert seen["sweep_kw"]["num_steps"] == 72
    # one shared renderer across the sweep and the mover gate
    assert seen["sweep_kw"]["renderer"] is seen["mover_kw"]["renderer"]
    assert seen["sweep_kw"]["renderer"] is not None


def test_fft_backend_render_matches_oracle_render(tmp_path, wav_in):
    """--backend fft (the reference's FFT formulation, cuFFT on the GPU)
    holds the 2e-7 WAV gate against the CLI's own -t 3 oracle render."""
    common = ["-i", wav_in, "--blocks", 40, "--chunk-blocks", 16,
              "--trajectory", "orbit:period=1,r=1", "--float", "--quiet"]
    eng, ora = tmp_path / "fft.wav", tmp_path / "oracle.wav"
    assert _run(common + ["-o", eng, "--backend", "fft"]) == 0
    assert _run(common + ["-o", ora, "-t", 3]) == 0
    assert check_main([str(eng), str(ora), "--eps", "2e-7"]) == 0
