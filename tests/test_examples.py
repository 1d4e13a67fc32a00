"""The examples/ scripts are user-facing API documentation — run them.

Each example executes in its own subprocess from a scratch cwd (they write
WAV/SVG/HTML artifacts relative to the cwd) with a clean environment, the
way a user would run them.  The three long ones (localization fits, the
personalization fit, the daemon+viz tour — minutes each) only run when
JEFFERSON_RUN_SLOW_EXAMPLES=1; the round-end acceptance flow covers them.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "examples").glob("*.py"))
SLOW = {"03_localization.py", "06_personalization.py", "08_daemon_live_viz.py"}


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.name)
def test_example_runs(script, tmp_path):
    if script.name in SLOW and not os.environ.get("JEFFERSON_RUN_SLOW_EXAMPLES"):
        pytest.skip("slow example (set JEFFERSON_RUN_SLOW_EXAMPLES=1)")
    env = dict(os.environ)
    # examples force the CPU platform themselves; scrub the 8-virtual-device
    # flag the test conftest sets so each subprocess boots the user-default
    # single device (the multi-device examples provision their own via
    # ensure_virtual_devices / run_multiprocess_dryrun)
    env.pop("JEFFERSON_EXAMPLES_ACCELERATOR", None)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    proc = subprocess.run(
        [sys.executable, str(script)],
        cwd=tmp_path,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"{script.name} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-3000:]}\n"
        f"--- stderr ---\n{proc.stderr[-3000:]}"
    )
