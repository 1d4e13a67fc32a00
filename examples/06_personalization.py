"""HRTF personalization: adapt a generic set to a listener from 24 points.

A 'listener' is simulated as the generic set with a smooth spectral tilt
(ear-shape EQ differences dominate individual HRTF deviation).  Two dozen
measured directions are enough for the smoothed multiplicative correction
field to fix the WHOLE 710-filter table, and renders through the fitted set
land much closer to the listener's true output.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root import

import os

if not os.environ.get("JEFFERSON_EXAMPLES_ACCELERATOR"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import scipy.fft

import jefferson_tpu as jt
from jefferson_tpu.hrtf.kemar import NUM_HRTF, HRTFDatabase, grid_position
from jefferson_tpu.trajectory.trajectory import CircularOrbit

cfg = jt.DEFAULT_CONFIG
generic = jt.synthetic_database(cfg)

# the listener: generic filters seen through an individual ear-shape EQ
k = np.arange(cfg.num_bins) / cfg.num_bins
eq = (1.0 + 0.5 * np.sin(2 * np.pi * k))[None, None, :]
hrirs = scipy.fft.irfft(generic.spectra * eq, n=cfg.pad_len, axis=-1)
listener = HRTFDatabase.from_hrirs(
    hrirs[:, :, : cfg.hrtf_len].astype(np.float32), cfg, source="listener"
)

# 24 measured directions -> fitted table
rng = np.random.default_rng(7)
picks = rng.choice(NUM_HRTF, 24, replace=False)
measurements = [
    (grid_position(int(i))[1], grid_position(int(i))[0], listener.hrirs[i, :, : cfg.hrtf_len])
    for i in picks
]
fitted, history = jt.fit_database(measurements, generic, cfg, steps=250)
err = lambda a: float(np.mean(np.abs(a.spectra - listener.spectra) ** 2))
print(f"table error vs listener: generic {err(generic):.5f} -> fitted {err(fitted):.5f}")

# does it matter audibly? render the same orbit through all three sets
sig = (0.3 * np.sin(2 * np.pi * 440 * np.arange(8192) / cfg.sample_rate)).astype(np.float32)
pos = CircularOrbit(period_s=0.5, ele=10, r=1.0).sample(32, cfg)
r_true = jt.Renderer(listener, cfg, chunk_blocks=32).render(sig, pos)
r_gen = jt.Renderer(generic, cfg, chunk_blocks=32).render(sig, pos)
r_fit = jt.Renderer(fitted, cfg, chunk_blocks=32).render(sig, pos)
e = lambda a: float(np.sqrt(np.mean((a - r_true) ** 2)))
print(f"render RMS vs listener-true: generic {e(r_gen):.6f} -> personalized {e(r_fit):.6f}")
