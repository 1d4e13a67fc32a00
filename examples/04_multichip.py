"""Multi-device scaling: shard 16 concurrent sources over a device mesh.

Runs anywhere: if fewer than 8 devices are visible (e.g. one GPU), it runs
as a CPU dry run on a self-provisioned 8-device virtual CPU mesh — no env
setup needed.

The same mesh is reachable from the CLI: `jefferson --scene
scene.json --devices N` shards the source axis exactly like this example,
and `jefferson -i in.wav --devices N` shards a single render's time-block
axis instead ('sp'-style, GSPMD halo exchange).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root import

import numpy as np

import jax

import jefferson_tpu as jt
from jefferson_tpu.engine.batch import BatchRenderer
from jefferson_tpu.parallel.mesh import ensure_virtual_devices, make_mesh
from jefferson_tpu.trajectory.trajectory import CircularOrbit, StaticPosition

ensure_virtual_devices(8)

cfg = jt.DEFAULT_CONFIG
db = jt.synthetic_database(cfg)
n_dev = len(jax.devices())
print(f"devices: {n_dev} x {jax.devices()[0].platform}")

s, blocks = 2 * n_dev, 32
rng = np.random.default_rng(0)
signals = (rng.standard_normal((s, blocks * cfg.frames_per_buffer)) * 0.1).astype(np.float32)
positions = np.stack(
    [
        CircularOrbit(period_s=0.5 + 0.1 * i, ele=5, r=1.0).sample(blocks, cfg)
        if i % 2
        else StaticPosition(azi=20 * i, ele=0, r=1.0).sample(blocks, cfg)
        for i in range(s)
    ]
)

mesh = make_mesh(n_dev) if n_dev > 1 else None
br = BatchRenderer(db, cfg, chunk_blocks=blocks, mesh=mesh, mix=True)
mix = br.render(signals, positions)
print(f"mixed {s} sources sharded over {n_dev} device(s): {mix.shape}, peak {np.abs(mix).max():.3f}")
