"""Randomized engine-vs-oracle fuzzing over edge-case positions.

Random per-block trajectories including the grid poles (ele 90), the
bottom row (ele -40), azimuth wraparound neighborhoods, and extreme radii —
the corners where the reference's truncation/rounding quirks bite hardest.
"""

import numpy as np
import pytest

from jefferson_tpu import ProcessType
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.oracle.reference import render_oracle
from jefferson_tpu.testing import precision_check

EDGE_AZIS = [0, 1, 179, 180, 181, 354, 355, 356, 359]
EDGE_ELES = [-40, -39, -35, -1, 0, 1, 39, 40, 41, 89, 90]
EDGE_RS = [0.01, 0.1, 0.5, 1.0, 4.9, 9.7]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_trajectory_parity(db, config, castanets, seed):
    rng = np.random.default_rng(seed)
    b = 48
    pos = np.stack(
        [
            rng.uniform(0, 360, b),
            rng.uniform(-40, 90, b),
            rng.uniform(0.05, 5.0, b),
        ],
        axis=-1,
    )
    # splice in edge values
    k = rng.integers(0, b, 12)
    pos[k[:4], 0] = rng.choice(EDGE_AZIS, 4)
    pos[k[4:8], 1] = rng.choice(EDGE_ELES, 4)
    pos[k[8:], 2] = rng.choice(EDGE_RS, 4)
    got = Renderer(db, config, chunk_blocks=16).render(castanets, pos)
    want = render_oracle(castanets, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=1e-6)
    assert rep.ok, str(rep)


def test_pole_and_wraparound_positions(db, config, castanets):
    """Every edge combination rendered in one trajectory."""
    combos = [(a, e, r) for a in EDGE_AZIS[:4] for e in (-40, 0, 90) for r in (0.1, 1.0)]
    pos = np.asarray(combos, dtype=np.float64)
    got = Renderer(db, config, chunk_blocks=8).render(castanets, pos)
    want = render_oracle(castanets, db, combos, config)
    rep = precision_check(got, want, eps=1e-6)
    assert rep.ok, str(rep)
    assert np.isfinite(got).all()


def test_out_of_range_elevation_is_consistent(db, config, castanets):
    """Elevations beyond the grid (e.g. from user cartesian input pointing
    nearly straight up/down) must not crash and must match the oracle."""
    pos = [(10.0, 95.0, 1.0), (10.0, -50.0, 1.0), (200.0, 90.0, 0.5)]
    got = Renderer(db, config, chunk_blocks=4).render(castanets, pos)
    want = render_oracle(castanets, db, pos, config)
    rep = precision_check(got, want, eps=1e-6)
    assert rep.ok, str(rep)


@pytest.mark.parametrize("seed", [10, 11, 12, 13])
def test_fuzz_dispatch_boundaries(db, config, castanets, seed):
    """Randomized geometry x trajectory wideness through the dispatch
    (dedup / direct, crossfade / no-crossfade variants): dedup=True must
    match dedup=False and the oracle for every random (b_total,
    chunk_blocks, mover-speed) combination — the planner boundaries
    (partial chunks, bucket sizing) are where regressions hide."""
    rng = np.random.default_rng(seed)
    b = int(rng.integers(24, 200))
    cb = int(rng.choice([16, 24, 32, 48, 64, 96]))
    speed = float(rng.choice([0.0, 0.3, 2.0, 11.0]))  # deg/block
    i = np.arange(b)
    pos = np.stack([
        (i * speed + rng.uniform(0, 360)) % 360,
        np.clip(20 + 60 * np.sin(i / max(7, b / 5)), -40, 90),
        np.full(b, float(rng.uniform(0.2, 2.0))),
    ], axis=-1)
    sig = castanets[: max(b * 128, 4000)]
    got = Renderer(db, config, chunk_blocks=cb).render(sig, pos)
    direct = Renderer(db, config, chunk_blocks=cb, dedup=False).render(sig, pos)
    assert np.array_equal(got, direct), f"b={b} cb={cb} speed={speed}"
    want = render_oracle(sig, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, f"b={b} cb={cb} speed={speed}: {rep}"
