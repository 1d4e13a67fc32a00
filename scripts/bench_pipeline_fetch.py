"""A/B the pipelined output fetch (``Renderer(pipeline_fetch=True)``).

The offline chunk loop's fetch (``np.asarray`` of a ~33 MB chunk) and the
next chunk's compute can overlap when fetches are deferred one chunk
(renderer.py ``pipeline_fetch``).

End-to-end wall timing is valid for this A/B (render() returns a fetched
np.ndarray — the host-visible completion IS the quantity of interest):
both arms reuse the same Renderer programs via a warmup render, and arms
are ABBA-interleaved.  Run it on the GPU:

    python scripts/bench_pipeline_fetch.py
"""

from __future__ import annotations

import sys
import time

import numpy as np

import jax


def _render_ms(r, sig, pos, reps=3):
    best = []
    for _ in range(reps):
        t0 = time.time()
        out = r.render(sig, pos)
        best.append((time.time() - t0) * 1e3)
    return min(best), out


def main() -> int:
    sys.path.insert(0, ".")
    from jefferson_tpu import DEFAULT_CONFIG, synthetic_database
    from jefferson_tpu.engine.renderer import Renderer
    from jefferson_tpu.trajectory.trajectory import AzimuthSweep

    from jefferson_tpu.utils.device import power_limit_line

    print("devices:", jax.devices(), power_limit_line(), file=sys.stderr)
    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    nb, cb = 8192, 1024  # 8 chunks -> 8 overlappable fetch/compute pairs
    traj = AzimuthSweep(start_azi=0, ele=0, r=0.5, step_deg=5.0,
                        blocks_per_step=172, num_steps=nb // 172 + 1)
    pos = traj.sample(nb, cfg)
    rng = np.random.default_rng(0)
    sig = (rng.standard_normal(nb * cfg.frames_per_buffer) * 0.2).astype(np.float32)

    sync = Renderer(db, cfg, chunk_blocks=cb)
    pipe = Renderer(db, cfg, chunk_blocks=cb, pipeline_fetch=True)
    # share compiled programs: both instances key programs identically and
    # a pipelined render dispatches the same programs in the same order
    pipe._fd_dedup = sync._fd_dedup
    pipe._fd_complex = sync._fd_complex

    t0 = time.time()
    base = sync.render(sig, pos)  # compile + warm
    print(f"compile+first render: {time.time() - t0:.1f}s", file=sys.stderr)

    a1, _ = _render_ms(sync, sig, pos)
    b1, out_pipe = _render_ms(pipe, sig, pos)
    b2, _ = _render_ms(pipe, sig, pos)
    a2, _ = _render_ms(sync, sig, pos)
    sync_ms, pipe_ms = min(a1, a2), min(b1, b2)

    diff = float(np.max(np.abs(out_pipe - base)))
    print(f"sync {sync_ms:.0f} ms  pipelined {pipe_ms:.0f} ms  "
          f"({sync_ms / pipe_ms:.3f}x)  max|diff| {diff:.2e}", file=sys.stderr)
    import json
    print(json.dumps({
        "metric": "pipeline_fetch_speedup",
        "sync_ms": round(sync_ms, 1), "pipelined_ms": round(pipe_ms, 1),
        "value": round(sync_ms / pipe_ms, 3), "unit": "x",
        "max_abs_diff": diff, "blocks": nb, "chunk_blocks": cb,
    }))
    assert diff == 0.0, "pipelined render must be bit-identical"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
