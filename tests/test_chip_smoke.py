"""chip_smoke.py: its phases at tiny sizes on the CPU, and its refusals.

The full-size run needs the GPU (``python chip_smoke.py``); here every phase
runs as a function at CI scale, so its entry points, gates and bookkeeping
are exercised on each test run.  The ``gpu``-marked test runs the phases at
their real widths and skips without a card.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()


@pytest.fixture(scope="module")
def signal():
    return cs.sweep_signal(0)


def _result_lines(text: str) -> list:
    return [l for l in text.splitlines() if l.startswith('{"ok"')]


def test_main_refuses_a_cpu_device(capsys):
    """No GPU: exit non-zero and print no result line."""
    assert cs.main([]) != 0
    captured = capsys.readouterr()
    assert not _result_lines(captured.out)
    assert "no GPU" in captured.err


def test_script_alone_fails_without_the_program(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo:
    the script fails and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not _result_lines(proc.stdout)


def test_four_refuses_without_four_gpus(capsys):
    assert cs.main(["--four"]) != 0
    assert not _result_lines(capsys.readouterr().out)


def test_gate_reports_and_refuses():
    ok = cs.gate("same", np.zeros(8), np.full(8, 1e-7))
    assert ok["max_abs"] == pytest.approx(1e-7) and ok["margin"] == pytest.approx(0.5)
    with pytest.raises(cs.PhaseFailed, match="off by one"):
        cs.gate("off by one", np.zeros(8), np.full(8, 3e-7))


def test_check_report_applies_the_rms_limit():
    from jefferson_tpu.testing import PrecisionReport

    rep = PrecisionReport(ok=True, max_abs_diff=1e-7, max_index=3,
                          first_bad_index=-1, rms=2e-4, eps=2e-7)
    with pytest.raises(cs.PhaseFailed, match="rms limit"):
        cs.check_report("loud", rep)
    rep.rms = 1e-8
    assert cs.check_report("quiet", rep)["argmax"] == 3


def test_timed_renderer_records_each_call():
    class Stub:
        def render(self, x, scale=1):
            return x * scale

    t = cs.TimedRenderer(Stub())
    assert t.render(2, scale=3) == 6 and t.render(1) == 1
    assert len(t.seconds) == 2 and all(s >= 0 for s in t.seconds)


def test_phase_sweep_and_fft_tiny(db, config, signal, capsys):
    walls = cs.phase_sweep(db, config, signal, blocks_per_step=6, num_steps=2,
                           scene_sources=4)
    assert set(walls) == {"azi0_ele0", "azi3_ele0", "azi0_ele5", "azi3_ele5"}
    cs.phase_fft(db, config, signal, walls, blocks_per_step=6, num_steps=2)
    out = capsys.readouterr().out
    assert out.count("[sweep] scenario=") == 7  # 4 + mover + 2 scenes
    assert "fft_over_matmul=" in out


def test_phase_mover_batch_tiny(db, config, capsys):
    cs.phase_mover_batch(db, config, 0, n_sources=6, nb=8, steps=2, mix_steps=1)
    out = capsys.readouterr().out
    assert "source=0" in out and "mix_max_abs=" in out and "peak_bytes_in_use=" in out


def test_phase_cli_tiny(config, tmp_path, capsys):
    cs.phase_cli(config, tmp_path, 0, seconds=0.3, ir_seconds=0.02)
    out = capsys.readouterr().out
    assert "Passed precision check" in out and "[cli]" in out


def test_phase_daemon_tiny(config, tmp_path, capsys):
    cs.phase_daemon(config, tmp_path, 0, render_blocks=32, stream_blocks=30)
    out = capsys.readouterr().out
    assert "request=render" in out and "moves=4" in out


def test_phase_live_tiny(db, config, signal, capsys):
    cs.phase_live(db, config, signal, blocks=24)
    out = capsys.readouterr().out
    assert "[live] blocks=24 crossfades=8" in out and "p99_ms=" in out


def test_phase_four_on_virtual_devices(db, config, capsys):
    """The --four comparisons on 4 of the 8 virtual CPU devices (no HLO
    dump here: XLA_FLAGS are fixed once the backend is up)."""
    cs.phase_four(db, config, 0, None, scene_sources=8, scene_blocks=32,
                  render_blocks=64)
    out = capsys.readouterr().out
    assert out.count("compare=mesh vs one device") == 3
    assert "compare=mesh vs oracle" in out


def test_collective_counts_reads_partitioned_modules(tmp_path):
    (tmp_path / "module_0001.jit_mixed.sm_9.0_gpu_after_optimizations.txt").write_text(
        "HloModule jit_mixed, num_partitions=4\n"
        "  %a = f32[8] all-reduce-start(f32[8] %x)\n"
        "  %b = f32[8] all-reduce-done(f32[8] %a)\n")
    (tmp_path / "module_0002.jit_mixed.sm_9.0_gpu_after_optimizations.txt").write_text(
        "HloModule jit_mixed\n  %a = f32[8] all-reduce(f32[8] %x)\n")
    (tmp_path / "module_0003.jit_fn.sm_9.0_gpu_after_optimizations.txt").write_text(
        "HloModule jit_fn, num_partitions=4\n"
        "  %g = f32[8] all-gather(f32[2] %x)\n")
    assert cs.collective_counts(tmp_path, r"^jit_mixed$") == {
        "module_0001.jit_mixed": {"all-reduce": 1}}
    assert cs.collective_counts(tmp_path, r"^jit_fn$") == {
        "module_0003.jit_fn": {"all-gather": 1}}


@pytest.mark.parametrize("mix,per_source,ok", [
    ({"all-reduce": 1}, {}, True),
    ({"all-reduce": 2}, {}, False),
    ({"all-reduce": 1}, {"all-gather": 1}, False),
    ({"all-reduce": 1, "all-gather": 1}, {}, False),
    (None, {}, False),
])
def test_scene_collectives_gate(mix, per_source, ok):
    """One mixdown all-reduce, no all-gather, and both programs found."""
    counts = {"scene mixdown program": {} if mix is None else {"m.jit_mixed": mix},
              "scene per-source program": {"m.jit_fn": per_source}}
    if ok:
        cs.check_scene_collectives(counts)
    else:
        with pytest.raises(cs.PhaseFailed, match="scene collectives"):
            cs.check_scene_collectives(counts)


def test_result_line_shape(monkeypatch, capsys):
    """A passing run ends with exactly the result object the contract names."""
    monkeypatch.setattr(cs, "phase_device", lambda four=False: {
        "platform": "gpu", "kind": "Stub H100", "count": 4 if four else 1})
    monkeypatch.setattr(cs, "phase_four", lambda *a, **k: None)
    assert cs.main(["--four"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "Stub H100", "count": 4}}


@pytest.mark.gpu
def test_phases_on_the_gpu(gpu, db, config, signal, tmp_path):
    """The gated phases at real widths on the card (reduced lengths)."""
    walls = cs.phase_sweep(db, config, signal, blocks_per_step=172, num_steps=8,
                           scene_sources=16)
    cs.phase_fft(db, config, signal, walls, blocks_per_step=172, num_steps=8)
    cs.phase_mover_batch(db, config, 0)
    cs.phase_live(db, config, signal, blocks=300)
