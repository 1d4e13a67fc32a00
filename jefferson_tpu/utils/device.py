"""What a measurement on the accelerator must say about where it ran.

A timing or a gate result counts only with the device it came from, so the
chip smoke run and the benchmark both refuse to run without a GPU (they never
fall back to the CPU) and print the card's name and power limit: a card set
below its maximum power runs slower under load.
"""

from __future__ import annotations

import subprocess


def gpu_devices() -> list:
    """``jax.devices()`` when they are GPUs; raises RuntimeError otherwise."""
    import jax

    devs = jax.devices()
    if not devs or devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {[d.platform for d in devs]}; this measurement "
            f"runs only on the accelerator"
        )
    return devs


def device_summary(devs) -> dict:
    """The device keys every result line carries."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def power_limit_line() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports it."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__}: {e})"
    return res.stdout.strip() or f"nvidia-smi rc={res.returncode}: {res.stderr.strip()}"
