"""Device policy: measurements refuse to run off the GPU, name the card,
and the live loop keeps the platform JAX booted unless told otherwise."""

import subprocess
import sys
from pathlib import Path

import pytest

from jefferson_tpu.utils import device as device_mod

REPO = Path(__file__).resolve().parents[1]


def test_gpu_devices_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device_mod.gpu_devices()


def test_device_summary_keys():
    import jax

    assert device_mod.device_summary(jax.devices()) == {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}


def test_power_limit_line_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert device_mod.power_limit_line().startswith("nvidia-smi unavailable")


def test_power_limit_line_reports_the_query(monkeypatch):
    seen = {}

    def fake(cmd, **k):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")

    monkeypatch.setattr(subprocess, "run", fake)
    assert device_mod.power_limit_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen["cmd"] == ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]


def test_bench_refuses_the_cpu(capsys, monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import bench

    assert bench.main() == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no GPU" in captured.err


def _platform_updates(monkeypatch):
    import jax

    calls = []
    real = jax.config.update

    def record(name, value):
        if name == "jax_platforms":
            calls.append(value)
        else:
            real(name, value)

    monkeypatch.setattr(jax.config, "update", record)
    return calls


@pytest.mark.parametrize("device,want", [("auto", []), ("cpu", ["cpu"])])
def test_rt_device_policy(monkeypatch, tmp_path, device, want):
    """jefferson-rt: auto keeps the platform JAX booted; cpu forces it."""
    from jefferson_tpu.rt.__main__ import main as rt_main

    calls = _platform_updates(monkeypatch)
    with pytest.raises((FileNotFoundError, SystemExit, ValueError, OSError)):
        rt_main(["-i", str(tmp_path / "missing.wav"), "--device", device])
    assert calls == want


def test_rt_rejects_the_old_native_choice(capsys):
    from jefferson_tpu.rt.__main__ import main as rt_main

    with pytest.raises(SystemExit):
        rt_main(["-i", "x.wav", "--device", "native"])
    assert "invalid choice" in capsys.readouterr().err
