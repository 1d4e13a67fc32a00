"""Offline render: orbiting source, distance cues, WAV + scene SVG out.

Runs on CPU by default for instant startup; set JEFFERSON_EXAMPLES_ACCELERATOR=1 to
run on the platform JAX boots (the GPU where one is attached).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root import

import os

if not os.environ.get("JEFFERSON_EXAMPLES_ACCELERATOR"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import jefferson_tpu as jt
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.trajectory.trajectory import CircularOrbit
from jefferson_tpu.viz.scene import scene_svg, waveform_svg

cfg = jt.DEFAULT_CONFIG
db = jt.synthetic_database(cfg)  # or jt.load_database("/path/to/kemar")

# 3 seconds of a plucky test tone
sr = cfg.sample_rate
t = np.arange(3 * sr) / sr
sig = (0.4 * np.sin(2 * np.pi * 330 * t) * np.exp(-(t % 0.5) * 8)).astype(np.float32)

traj = CircularOrbit(period_s=3.0, ele=15, r=1.5)
blocks = len(sig) // cfg.frames_per_buffer
positions = traj.sample(blocks, cfg)

out = Renderer(db, cfg).render(sig, positions)
jt.write_wav("orbit.wav", out, sr)  # 24-bit PCM like the reference
scene_svg(positions, "orbit.scene.svg", config=cfg)
waveform_svg(out, "orbit.wave.svg")

# self-contained players: 2-D synced scene + the 3-D perspective view
# (mouse-orbit/zoom with the reference GL window's camera semantics)
from jefferson_tpu.viz.html import scene_html
from jefferson_tpu.viz.scene3d import scene3d_html

scene_html(positions, out, "orbit.html", config=cfg)
scene3d_html(positions, out, "orbit.3d.html", config=cfg)
print(f"rendered {out.shape[0]/sr:.1f}s -> orbit.wav "
      f"(+ .scene.svg, .wave.svg, .html, .3d.html)")
