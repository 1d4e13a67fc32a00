"""Scaled benchmarkTesting: the reference's 4-scenario azimuth-sweep gate
(reference: Jefferson/src/precision_test.cu:2154-2201) at reduced block
counts for CI speed; the full 172x72 run is `python -m jefferson_tpu.bench.sweep`."""

import numpy as np

from jefferson_tpu.bench.sweep import SCENARIOS, run_benchmark_sweep
from jefferson_tpu.engine.renderer import Renderer


def test_four_scenario_sweep_fft_backend(db, config, castanets):
    """FFT-vs-FFT comparison holds the reference's own 2e-7 gate."""
    reports = run_benchmark_sweep(
        castanets,
        db,
        config,
        blocks_per_step=12,
        num_steps=24,
        eps=2e-7,
        renderer=Renderer(db, config, chunk_blocks=128, backend="fft"),
    )
    for (azi, ele), rep in zip(SCENARIOS, reports):
        assert rep.ok, f"scenario ({azi},{ele}): {rep}"


def test_four_scenario_sweep_matmul_backend(db, config, castanets):
    """The DFT-matmul backend holds the reference's own 2e-7 gate even
    across transform algorithms."""
    reports = run_benchmark_sweep(
        castanets,
        db,
        config,
        blocks_per_step=12,
        num_steps=24,
        eps=2e-7,
        renderer=Renderer(db, config, chunk_blocks=128, backend="matmul"),
    )
    for (azi, ele), rep in zip(SCENARIOS, reports):
        assert rep.ok and rep.rms < 2e-8, f"scenario ({azi},{ele}): {rep}"


def test_sweep_wraps_azimuth(config):
    from jefferson_tpu.trajectory.trajectory import AzimuthSweep

    t = AzimuthSweep(start_azi=350, step_deg=5, blocks_per_step=2, num_steps=4)
    pos = t.sample(t.total_blocks, config)
    azis = pos[::2, 0]
    np.testing.assert_array_equal(azis, [350, 355, 0, 5, 10])


def test_mover_gate_scaled(db, config, castanets):
    """The per-block mover scenario (exercises the direct every-block
    crossfade program, which the 4 hold-position scenarios never reach)
    holds the 2e-7 gate at CI scale."""
    from jefferson_tpu.bench.sweep import mover_positions, run_mover_gate

    pos = mover_positions(997)
    # the fixture must actually be a per-block mover across the full grid
    assert (np.diff(pos[:, 0]) != 0).mean() > 0.9
    assert pos[:, 1].min() < -35 and pos[:, 1].max() > 85

    rep = run_mover_gate(
        castanets, db, config, num_blocks=512, eps=2e-7,
        renderer=Renderer(db, config, chunk_blocks=128),
    )
    assert rep.ok, str(rep)


def test_sweep_cli_emits_margin_json(db, config, castanets, tmp_path, capsys, monkeypatch):
    """The sweep CLI emits the per-scenario margin JSON line (gate-headroom
    telemetry)."""
    import json

    from jefferson_tpu.bench import sweep as sweep_mod
    from jefferson_tpu.io.wavio import write_wav

    src = tmp_path / "in.wav"
    write_wav(src, castanets[:24000, None].repeat(2, 1), config.sample_rate)
    # tiny workload: 8 blocks/step x 3 steps, mover = 32 blocks
    import jefferson_tpu.cli.main as cli_main

    monkeypatch.setattr(cli_main, "load_hrtf", lambda *a, **k: db)
    rc = sweep_mod.main(["-i", str(src), "--blocks", "8", "--steps", "3",
                         "--scene-sources", "4"])
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    assert rc == 0 and data["ok"]
    assert set(data["scenarios"]) == {
        "azi0_ele0", "azi3_ele0", "azi0_ele5", "azi3_ele5", "mover",
        "scene_hold", "scene_movers",
    }
    assert 0 <= data["worst_margin"] <= 1


def test_scene_gate_scaled(db, config, castanets):
    """The BATCHED/scene programs (batch dedup for holding sources, the
    direct program for wide movers — the daemon/--scene production paths)
    are oracle-gated per source at the reference's 2e-7 eps; the dispatch
    pin verifies the gate exercises what it claims to."""
    from jefferson_tpu.bench.sweep import run_scene_gate

    rep = run_scene_gate(
        castanets, db, config, scenario="hold", num_sources=8, num_blocks=128,
        chunk_blocks=64,
    )
    assert rep.ok, f"scene hold: {rep}"
    rep = run_scene_gate(
        castanets, db, config, scenario="movers", num_sources=16, num_blocks=128,
        chunk_blocks=64,
    )
    assert rep.ok, f"scene movers: {rep}"


def test_oracle_workers_match_the_serial_oracle(db, config, castanets):
    """Oracle renders in spawned CPU worker processes equal the in-process
    ones bit for bit, in job order, and the sweep's reports do not change."""
    from jefferson_tpu.bench.sweep import run_benchmark_sweep
    from jefferson_tpu.oracle.reference import render_oracle, render_oracle_many

    pos = [np.tile([azi, 10.0, 0.8], (12, 1)) for azi in (0.0, 40.0, 300.0)]
    sigs = [np.roll(castanets, 997 * k)[: 12 * config.frames_per_buffer] for k in range(3)]
    many = render_oracle_many(zip(sigs, pos), db, config, workers=2)
    for s, p, got in zip(sigs, pos, many):
        np.testing.assert_array_equal(got, render_oracle(s, db, [tuple(x) for x in p], config))
    kw = dict(blocks_per_step=4, num_steps=2, scenarios=SCENARIOS[:2])
    serial = run_benchmark_sweep(castanets, db, config, **kw)
    pooled = run_benchmark_sweep(castanets, db, config, oracle_workers=2, **kw)
    assert [r.max_abs_diff for r in serial] == [r.max_abs_diff for r in pooled]


def test_scene_gate_dispatch_pin_detects_wrong_path(db, config, castanets):
    """The gate must refuse to pass when the intended program never ran
    (dedup disabled -> direct batch path -> AssertionError, not a green
    gate)."""
    import pytest

    from jefferson_tpu.bench.sweep import run_scene_gate

    with pytest.raises(AssertionError, match="dedup dispatch"):
        run_scene_gate(
            castanets, db, config, scenario="hold", num_sources=8,
            num_blocks=128, chunk_blocks=64, dedup=False,
        )


def test_sweep_cli_write_dir(db, config, castanets, tmp_path, capsys, monkeypatch):
    """--write-dir emits the four scenario WAVs (the reference's
    waveFileTesting, precision_test.cu:2203-2250) alongside the gate."""
    import json

    import jefferson_tpu.cli.main as cli_main
    from jefferson_tpu.bench import sweep as sweep_mod
    from jefferson_tpu.io.wavio import read_wav, write_wav

    src = tmp_path / "in.wav"
    write_wav(src, castanets[:24000, None].repeat(2, 1), config.sample_rate)
    monkeypatch.setattr(cli_main, "load_hrtf", lambda *a, **k: db)
    outdir = tmp_path / "waves"
    rc = sweep_mod.main(["-i", str(src), "--blocks", "6", "--steps", "2",
                         "--no-mover", "--no-scene",
                         "--write-dir", str(outdir)])
    assert rc == 0
    out = capsys.readouterr().out
    assert json.loads([l for l in out.splitlines() if l.startswith("{")][-1])["ok"]
    wavs = sorted(p.name for p in outdir.glob("*.wav"))
    assert wavs == [
        "sweep_azi0_ele0.wav", "sweep_azi0_ele5.wav",
        "sweep_azi3_ele0.wav", "sweep_azi3_ele5.wav",
    ]
    y, sr = read_wav(outdir / "sweep_azi0_ele0.wav")
    # blocks x (steps + 1): the start position plus one hold per step
    # (reference precision_test.cu:2102-2124 runs 172 x 73)
    assert sr == config.sample_rate and y.shape == (6 * 3 * 128, 2)
