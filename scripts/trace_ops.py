"""Per-op device time of the engine's main programs, from jax.profiler traces.

    python scripts/trace_ops.py [--out chiprun_out/trace_ops.json]

Traces, each in a window of its own after a warm-up that pays the compiles:

  mover_step       bench.py's step: 256 orbiting sources x 64 blocks through
                   batched_chunk_fn (matmul form; BatchRenderer has no other)
  mover_<backend>  Renderer on the sweep's per-block mover, 4096 blocks
  sweep_<backend>  Renderer on one reference scenario (73 positions x 172
                   blocks), the dedup program

for backend in matmul and fft.  For each window it reports the device's
busy and idle share (union of op intervals on the device's op line over the
window) and each XLA op's share of the device time, and writes them all to
one JSON file.  Runs only on the GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np


def reduce_trace(path: str, window_s: float) -> dict:
    """Device op time by name and the device's busy share, from one
    .xplane.pb.  The device plane is '/device:GPU:0'; its op line is the
    line with the most events whose name mentions 'Ops' (XLA's own op line),
    else the busiest line."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    if not planes:
        return {"error": f"no GPU plane; planes: {[p.name for p in pd.planes]}"}
    plane = planes[0]
    lines = {ln.name: list(ln.events) for ln in plane.lines}
    op_lines = [n for n in lines if "Ops" in n] or list(lines)
    op_line = max(op_lines, key=lambda n: len(lines[n]))
    events = lines[op_line]
    by_op: dict[str, float] = defaultdict(float)
    spans = []
    for ev in events:
        by_op[ev.name] += ev.duration_ns
        spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    total = sum(by_op.values())
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {
        "lines": {n: len(v) for n, v in lines.items()},
        "op_line": op_line,
        "window_s": window_s,
        "device_busy_s": busy * 1e-9,
        "idle_share": 1.0 - busy * 1e-9 / window_s,
        "op_time_s": total * 1e-9,
        "ops": [{"name": n, "s": t * 1e-9, "share": t / total} for n, t in ops],
    }


def traced(label: str, run, repeats: int, results: dict) -> None:
    import jax

    run()  # warm: compiles outside the window
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        with jax.profiler.trace(td):
            for _ in range(repeats):
                run()
        window = time.perf_counter() - t0
        files = glob.glob(os.path.join(td, "**", "*.xplane.pb"), recursive=True)
        res = reduce_trace(files[0], window) if files else {"error": "no trace"}
    res["repeats"] = repeats
    results[label] = res
    head = ", ".join(f"{o['name']} {o['share']:.1%}" for o in res.get("ops", [])[:6])
    print(f"[{label}] window_s={window:.4f} idle_share={res.get('idle_share', float('nan')):.3f} "
          f"op_time_s={res.get('op_time_s', float('nan')):.4f} top: {head}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="chiprun_out/trace_ops.json")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from jefferson_tpu import DEFAULT_CONFIG, synthetic_database
    from jefferson_tpu.bench.sweep import mover_positions
    from jefferson_tpu.cli.main import enable_compilation_cache
    from jefferson_tpu.engine.batch import batched_chunk_fn
    from jefferson_tpu.engine.plan import make_plan
    from jefferson_tpu.engine.renderer import Renderer
    from jefferson_tpu.trajectory.trajectory import AzimuthSweep, CircularOrbit
    from jefferson_tpu.utils.device import device_summary, gpu_devices, power_limit_line

    try:
        devs = gpu_devices()
    except RuntimeError as e:
        print(f"trace_ops: {e}", file=sys.stderr)
        return 1
    results = {"device": device_summary(devs), "nvidia_smi": power_limit_line()}
    print(f"device: {results['device']} | {results['nvidia_smi']}", flush=True)
    enable_compilation_cache()
    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    rng = np.random.default_rng(0)

    s, nb = 256, 64
    plans = [make_plan(CircularOrbit(period_s=0.4 + 0.01 * i, ele=5, r=1.0).sample(nb, cfg), cfg)
             for i in range(s)]
    st = lambda a: jnp.asarray(np.stack([getattr(q, a) for q in plans]))
    xs = (st("idx_new"), st("w_new"), st("idx_old"), st("w_old"),
          st("xfade"), st("u_hi"), st("u_lo"), st("inv_frac"))
    spectra = (jnp.asarray(np.real(db.spectra).astype(np.float32)),
               jnp.asarray(np.imag(db.spectra).astype(np.float32)))
    feds = jnp.asarray((rng.standard_normal((s, nb * cfg.frames_per_buffer)) * 0.2
                        ).astype(np.float32))
    step = jax.jit(batched_chunk_fn(cfg, num_blocks=nb, with_xfade=True))
    state = {"h": jnp.zeros((s, cfg.history_len), jnp.float32)}

    def mover_step():
        _, state["h"] = jax.block_until_ready(step(spectra, state["h"], feds, *xs))

    traced("mover_step", mover_step, 20, results)

    sig = (rng.standard_normal(131072) * 0.2).astype(np.float32)
    mover = mover_positions(4096)
    traj = AzimuthSweep(start_azi=3.0, ele=0.0, r=0.5, step_deg=5.0,
                        blocks_per_step=172, num_steps=72)
    sweep = traj.sample(traj.total_blocks, cfg)
    for backend in ("matmul", "fft"):
        r = Renderer(db, cfg, backend=backend)
        traced(f"mover_{backend}", lambda: r.render(sig, mover), 2, results)
        traced(f"sweep_{backend}", lambda: r.render(sig, sweep), 2, results)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
