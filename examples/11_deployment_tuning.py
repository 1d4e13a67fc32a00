"""Deployment tuning: the offline-render levers and when to pull them.

Every lever here is BIT-IDENTICAL to the defaults (same arithmetic, same
program outputs) — they trade dispatch/transfer schedule, not audio:

  * ``pipeline_fetch=True`` — overlap chunk i+1's dispatch with chunk i's
    device->host fetch; pays where a ~33 MB chunk fetch is comparable to
    its compute (not measured on the GPU yet — PERF.md).
  * explicit ``chunk_blocks`` — pins one compiled program shape.  Daemons
    serving varied durations keep ONE program per shape class this way.
  * ``Renderer(mesh=...)`` / ``BatchRenderer(mesh=...)`` — shard the block
    axis (single source) or the source axis (scenes) over multiple devices;
    see examples/04_multichip.py and 09_multihost.py.

Runs on CPU by default; JEFFERSON_EXAMPLES_ACCELERATOR=1 targets the attached GPU.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root import

import os

if not os.environ.get("JEFFERSON_EXAMPLES_ACCELERATOR"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import jefferson_tpu as jt
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.trajectory.trajectory import AzimuthSweep

cfg = jt.DEFAULT_CONFIG
db = jt.synthetic_database(cfg)

sr = cfg.sample_rate
sig = (0.3 * np.sin(2 * np.pi * 220 * np.arange(2 * sr) / sr)).astype(np.float32)
blocks = len(sig) // cfg.frames_per_buffer
# the reference benchmark cadence: positions hold for 172 blocks per step
positions = AzimuthSweep(
    start_azi=0, ele=0, r=0.5, step_deg=5.0, blocks_per_step=172,
    num_steps=blocks // 172 + 1,
).sample(blocks, cfg)

base = Renderer(db, cfg, chunk_blocks=256)
tuned = Renderer(db, cfg, chunk_blocks=256, pipeline_fetch=True)

t0 = time.time()
want = base.render(sig, positions)
t_base = time.time() - t0
t0 = time.time()
got = tuned.render(sig, positions)
t_tuned = time.time() - t0

assert np.array_equal(got, want), "the levers must not change one sample"
print(
    f"{blocks} blocks: sync {t_base*1e3:.0f} ms, pipelined {t_tuned*1e3:.0f} ms "
    f"(bit-identical; first calls include compiles — A/B properly with "
    f"scripts/bench_pipeline_fetch.py)"
)
print("deployment notes: fetch-bound renders -> pipeline_fetch=True; "
      "daemon -> pin chunk_blocks; multi-device -> mesh= (examples 04/09)")
