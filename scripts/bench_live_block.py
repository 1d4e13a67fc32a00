"""Measure the LIVE single-block loop on the ambient jax platform.

The reference meets its 2.9 ms realtime budget on the accelerator (one-block
pipeline latency design, reference: Jefferson/src/Audio.cu:107-115).  The
rebuild's live path (StreamingSpatializer.process_block) needs one device
dispatch and one fetch per block.  This script records the per-block
latency on whatever platform jax booted (--cpu forces the host CPU).
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main() -> int:
    sys.path.insert(0, ".")
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from jefferson_tpu import DEFAULT_CONFIG, synthetic_database
    from jefferson_tpu.engine.stream import StreamingSpatializer

    print("devices:", jax.devices(), file=sys.stderr)
    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    spat = StreamingSpatializer(db, cfg)
    rng = np.random.default_rng(0)
    blk = (rng.standard_normal(cfg.frames_per_buffer) * 0.2).astype(np.float32)

    t0 = time.time()
    spat.prime()
    print(f"prime (compile): {time.time()-t0:.1f}s", file=sys.stderr)

    n = 200
    budget = 1e3 * cfg.block_duration

    def loop(label, move):
        times = np.empty(n)
        for i in range(n):
            if move:
                # orbit: position changes every block (crossfade worst case)
                spat.set_position(azi=(i * 3) % 360, ele=10, r=1.0)
            t0 = time.perf_counter()
            spat.process_block(blk)  # includes the device->host fetch
            times[i] = time.perf_counter() - t0
        ms = times * 1e3
        print(
            f"{jax.devices()[0].platform} {label}: {n} live blocks — "
            f"avg {ms.mean():.3f} ms, "
            f"p50 {np.percentile(ms,50):.3f}, p99 {np.percentile(ms,99):.3f}, "
            f"max {ms.max():.3f} vs {budget:.3f} ms budget "
            f"({(ms > budget).sum()} misses, {100*(ms>budget).mean():.1f}%)",
            file=sys.stderr,
        )

    loop("mover", move=True)
    # steady state: most live blocks hold position -> the no-crossfade
    # block step skips the old-side filter apply entirely
    loop("hold ", move=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
