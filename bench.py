"""Benchmark: sustained 128-sample blocks/sec on one GPU (flagship pipeline).

Workload = BASELINE config 5: a batch of 256 concurrent moving source streams
(crossfade active every block) in 64-block steps through the full
interpolating binaural pipeline, state carried between steps like a
production streaming service.  Inputs are staged on device; the measurement
is steady-state step time, each step ended by ``jax.block_until_ready``.

Baseline: the reference GPU renders one 128-sample block in ~0.3 ms worst
case (reference: README.md:24) => ~3,333 blocks/s/GPU.  vs_baseline is the
ratio to that number.

Refuses to run without a GPU.  Prints ONE JSON line to stdout; diagnostics,
with the device, its count and its power limit, go to stderr.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from jefferson_tpu import DEFAULT_CONFIG, synthetic_database
    from jefferson_tpu.cli.main import enable_compilation_cache
    from jefferson_tpu.engine.batch import batched_chunk_fn
    from jefferson_tpu.engine.plan import make_plan
    from jefferson_tpu.oracle.reference import render_oracle
    from jefferson_tpu.trajectory.trajectory import CircularOrbit
    from jefferson_tpu.utils.device import device_summary, gpu_devices, power_limit_line

    try:
        devs = gpu_devices()
    except RuntimeError as e:
        log(f"bench: {e}")
        return 1
    device = device_summary(devs)
    log(f"device: {device} | nvidia-smi: {power_limit_line()}")
    enable_compilation_cache()

    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    n_sources, nb = 256, 64
    rng = np.random.default_rng(0)
    spectra = (
        jnp.asarray(np.real(db.spectra).astype(np.float32)),
        jnp.asarray(np.imag(db.spectra).astype(np.float32)),
    )
    hists = jnp.zeros((n_sources, cfg.history_len), jnp.float32)
    feds = jnp.asarray(
        rng.standard_normal((n_sources, nb * cfg.frames_per_buffer)).astype(np.float32) * 0.2
    )
    orbits = [CircularOrbit(period_s=0.4 + 0.01 * i, ele=5, r=1.0).sample(nb, cfg)
              for i in range(n_sources)]
    plans = [make_plan(p, cfg) for p in orbits]
    stack = lambda attr: jnp.asarray(np.stack([getattr(p, attr) for p in plans]))
    xs = (
        stack("idx_new"), stack("w_new"), stack("idx_old"), stack("w_old"),
        stack("xfade"), stack("u_hi"), stack("u_lo"), stack("inv_frac"),
    )
    step = jax.jit(batched_chunk_fn(cfg, num_blocks=nb, with_xfade=True))

    t0 = time.perf_counter()
    out, h = jax.block_until_ready(step(spectra, hists, feds, *xs))
    log(f"compile+first step: {time.perf_counter() - t0:.1f}s")

    # the oracle check runs on the very function being measured and fails
    # the benchmark when it misses: source 0's blocks vs the NumPy oracle
    got = np.asarray(out[0]).reshape(nb * cfg.frames_per_buffer, 2)
    want = render_oracle(np.asarray(feds[0]), db, [tuple(p) for p in orbits[0]], cfg)
    rms = float(np.sqrt(np.mean((got - want) ** 2)))
    max_abs = float(np.max(np.abs(got - want)))
    log(f"parity (source 0 vs oracle): max|diff| = {max_abs:.3e}, rms = {rms:.3e}")
    if not (max_abs <= 2e-7 and rms < 1e-4):
        log("bench: parity outside the 2e-7 max-abs / 1e-4 rms gate")
        return 1

    for _ in range(3):  # warm
        h = step(spectra, h, feds, *xs)[1]
    jax.block_until_ready(h)
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        out, h = jax.block_until_ready(step(spectra, h, feds, *xs))
        times.append(time.perf_counter() - t0)
    per_step = float(np.median(times))
    bps = n_sources * nb / per_step
    q1, q3 = np.percentile(times, [25, 75])
    log(
        f"steady state: median {per_step * 1e3:.3f} ms per {n_sources}x{nb}-block "
        f"step (quartiles {q1 * 1e3:.3f}-{q3 * 1e3:.3f} ms over {len(times)} steps) "
        f"-> {bps:,.0f} blocks/s"
    )
    print(json.dumps({
        "metric": "blocks_per_sec",
        "value": bps,
        "unit": "128-sample 44.1kHz blocks/s",
        "vs_baseline": bps / 3333.3,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
