"""Static-segment blend dedup: bit-exact vs the direct path, auto-gating."""

import numpy as np

from jefferson_tpu.engine.plan import dedup_rows
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.trajectory.trajectory import AzimuthSweep, CircularOrbit, StaticPosition


def test_dedup_rows_roundtrip():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 710, size=(64, 4)).astype(np.int32)
    w = rng.random((64, 4), dtype=np.float32)
    # duplicate rows heavily
    idx, w = np.repeat(idx[:5], 13, axis=0)[:64], np.repeat(w[:5], 13, axis=0)[:64]
    u_idx, u_w, inv = dedup_rows(idx, w)
    assert u_idx.shape[0] == 5
    np.testing.assert_array_equal(u_idx[inv], idx)
    np.testing.assert_array_equal(u_w[inv], w)


def test_dedup_render_bit_exact_sweep(db, config, castanets):
    """Sweep workload (positions persist across blocks): dedup path taken and
    bit-identical to the direct blend."""
    traj = AzimuthSweep(start_azi=0, ele=0, r=0.5, step_deg=5, blocks_per_step=16, num_steps=6)
    pos = traj.sample(traj.total_blocks, config)
    on = Renderer(db, config, chunk_blocks=48, dedup=True)
    off = Renderer(db, config, chunk_blocks=48, dedup=False)
    got = on.render(castanets, pos, initial_old=(0.0, 0.0))
    want = off.render(castanets, pos, initial_old=(0.0, 0.0))
    assert on._fd_dedup and not on._fd_complex, "dedup path not exercised"
    np.testing.assert_array_equal(got, want)


def test_dedup_render_bit_exact_static(db, config, castanets):
    """Fully static render: one unique row, non-xfade dedup path."""
    pos = StaticPosition(azi=42, ele=10, r=1.2).sample(40, config)
    on = Renderer(db, config, chunk_blocks=40, dedup=True)
    off = Renderer(db, config, chunk_blocks=40, dedup=False)
    got = on.render(castanets, pos, initial_old=None)
    want = off.render(castanets, pos, initial_old=None)
    assert on._fd_dedup
    np.testing.assert_array_equal(got, want)


def test_batch_dedup_bit_exact(db, config, castanets):
    """Scene-style batch (static + slow sources): dedup == direct, also
    under source sharding."""
    import jax

    from jefferson_tpu.engine.batch import BatchRenderer
    from jefferson_tpu.parallel.mesh import make_mesh

    s, blocks = 4, 24
    signals = np.stack([np.roll(castanets, 700 * i)[:6000] for i in range(s)])
    trajs = [
        StaticPosition(azi=45 * i, ele=5, r=1.0).sample(blocks, config)
        if i % 2
        else AzimuthSweep(start_azi=10 * i, ele=0, r=0.8, step_deg=5,
                          blocks_per_step=8, num_steps=2).sample(blocks, config)
        for i in range(s)
    ]
    positions = np.stack(trajs)
    want = BatchRenderer(db, chunk_blocks=12, dedup=False).render(signals, positions)
    on = BatchRenderer(db, chunk_blocks=12, dedup=True)
    got = on.render(signals, positions)
    assert any(k[1] is not None for k in on._jitted), "dedup path not exercised"
    np.testing.assert_array_equal(got, want)

    mesh = make_mesh(4)
    got_sh = BatchRenderer(db, chunk_blocks=12, mesh=mesh, dedup=True).render(
        signals, positions
    )
    np.testing.assert_allclose(got_sh, want, atol=1e-7)


def test_dedup_falls_back_for_movers(db, config, castanets):
    """A source moving every block has ~B unique rows: direct path used."""
    pos = CircularOrbit(period_s=0.2, ele=5, r=1.0).sample(48, config)
    r = Renderer(db, config, chunk_blocks=48, dedup=True)
    r.render(castanets, pos)
    assert r._fd_complex and not r._fd_dedup


def test_dedup_partial_final_chunk(db, config, castanets):
    """Partial last chunk pads rows consistently (regression guard)."""
    traj = AzimuthSweep(start_azi=0, ele=0, r=0.5, step_deg=5, blocks_per_step=16, num_steps=4)
    pos = traj.sample(traj.total_blocks, config)  # 80 blocks
    on = Renderer(db, config, chunk_blocks=64, dedup=True)
    off = Renderer(db, config, chunk_blocks=64, dedup=False)
    np.testing.assert_array_equal(
        on.render(castanets, pos, initial_old=(0.0, 0.0)),
        off.render(castanets, pos, initial_old=(0.0, 0.0)),
    )


def test_batch_dedup_large_chunk(db, config, castanets):
    """A 512-block chunk of a two-source hold scene takes the batch dedup
    program and is bit-exact against the direct program."""
    from jefferson_tpu.engine.batch import BatchRenderer

    s, blocks = 2, 512
    signals = np.stack([np.roll(castanets, 700 * i)[:20000] for i in range(s)])
    pos = np.zeros((s, blocks, 3))
    pos[:, :, 2] = 1.0
    pos[0, :, 0], pos[1, :, 0] = 40.0, 200.0  # hold scene: dedup applies
    on = BatchRenderer(db, config, chunk_blocks=512, dedup=True)
    got = on.render(signals, pos)
    assert on._jitted and all(k[1] is not None for k in on._jitted), list(on._jitted)
    want = BatchRenderer(db, config, chunk_blocks=512, dedup=False).render(signals, pos)
    np.testing.assert_array_equal(got, want)
