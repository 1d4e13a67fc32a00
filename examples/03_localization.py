"""Inverse rendering: recover a source position from a binaural recording.

Uses the differentiable (smooth-interpolation) renderer: coarse grid search
over direction x radius, then coarse-to-fine gradient refinement.
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
from jefferson_tpu.diff.render import DifferentiableRenderer

cfg = jt.DEFAULT_CONFIG
db = jt.synthetic_database(cfg)
r = DifferentiableRenderer(db, cfg)

# band-limited probe signal (white noise has a delta autocorrelation, which
# makes the waveform loss blind to the distance delay)
rng = np.random.default_rng(0)
sig = np.convolve(rng.standard_normal(9000), np.hanning(16), mode="same")
sig = (0.3 * sig / np.abs(sig).max()).astype(np.float32)

blocks = 12
hidden = np.tile([62.0, 18.0, 1.3], (blocks, 1)).astype(np.float32)
recording = np.asarray(r.render(sig, hidden))
print("hidden position: azi=62 ele=18 r=1.3")

init = np.tile([0.0, 0.0, 1.0], (blocks, 1)).astype(np.float32)
fitted, losses = r.localize(sig, recording, init, steps=400, lr=0.1)
print(
    f"recovered: azi={fitted[:, 0].mean():.1f} ele={fitted[:, 1].mean():.1f} "
    f"r={fitted[:, 2].mean():.2f}   (loss {losses[0]:.4f} -> {losses[-1]:.6f})"
)
