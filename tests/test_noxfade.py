"""No-crossfade fast path: crossfade-free chunks dispatch to program
variants that skip the old-filter side entirely (half the tail-IDFT MACs,
no old-row blend/gather) and are BIT-IDENTICAL to the crossfade programs on
such chunks (there out = where(False, mixed, y_new) = y_new).

Hold workloads (the reference's benchmark holds each position for 172
blocks; scene sources usually hold theirs) crossfade only at block 0, so
every later chunk runs the fast path.  Reference crossfade trigger:
Jefferson/src/SoundSource.cu:41-54 (old != new position).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from jefferson_tpu.engine.batch import BatchRenderer
from jefferson_tpu.oracle.reference import render_oracle
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.testing import precision_check


def test_renderer_hold_uses_noxfade_programs(db, config):
    """A hold render (crossfade at block 0 only) splits into one crossfade +
    one no-crossfade dedup program and stays on the oracle."""
    rng = np.random.default_rng(3)
    B = 96
    sig = (rng.standard_normal(B * config.frames_per_buffer) * 0.2).astype(np.float32)
    pos = np.stack([np.full(B, 40.0), np.full(B, 10.0), np.full(B, 1.0)], 1)
    r = Renderer(db, config, chunk_blocks=32)
    got = r.render(sig, pos)
    want = render_oracle(sig, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, str(rep)
    xfs = {k[1] for k in r._fd_dedup}
    assert xfs == {True, False}, (
        f"hold render must compile both variants, got keys {list(r._fd_dedup)}"
    )


def test_renderer_noxfade_only_render(db, config):
    """initial_old=None hold render: a single no-crossfade program."""
    rng = np.random.default_rng(4)
    B = 64
    sig = (rng.standard_normal(B * config.frames_per_buffer) * 0.2).astype(np.float32)
    pos = np.stack([np.full(B, 70.0), np.full(B, -20.0), np.full(B, 0.8)], 1)
    r = Renderer(db, config, chunk_blocks=32)
    got = r.render(sig, pos, initial_old=None)
    want = render_oracle(sig, db, [tuple(p) for p in pos], config, initial_old=None)
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, str(rep)
    assert {k[1] for k in r._fd_dedup} == {False}


def test_renderer_gather_noxfade(db, config):
    """dedup=False hold render takes the direct no-crossfade program."""
    rng = np.random.default_rng(5)
    B = 64
    sig = (rng.standard_normal(B * config.frames_per_buffer) * 0.2).astype(np.float32)
    pos = np.stack([np.full(B, 40.0), np.full(B, 10.0), np.full(B, 1.0)], 1)
    r = Renderer(db, config, chunk_blocks=32, dedup=False)
    got = r.render(sig, pos, initial_old=None)
    want = render_oracle(sig, db, [tuple(p) for p in pos], config, initial_old=None)
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, str(rep)
    assert set(r._fd_complex) == {(32, False)}, list(r._fd_complex)


def test_batch_hold_scene_noxfade(db, config):
    """BatchRenderer hold scene: per-chunk variants, parity per source."""
    s, b_total = 4, 96
    fpb = config.frames_per_buffer
    rng = np.random.default_rng(6)
    positions = np.stack([
        np.stack([np.full(b_total, 45.0 * i), np.full(b_total, 5.0),
                  np.full(b_total, 0.9)], 1)
        for i in range(s)
    ])
    signals = (rng.standard_normal((s, b_total * fpb)) * 0.2).astype(np.float32)
    br = BatchRenderer(db, config, chunk_blocks=32, dedup=True)
    out = br.render(signals, positions)
    # block-0 crossfades only: chunk 0 takes the crossfade program, the
    # other two the no-crossfade one, both on the dedup path
    assert set(br._jitted) == {(32, 8, True), (32, 8, False)}, list(br._jitted)
    for i in range(s):
        want = render_oracle(
            signals[i], db, [tuple(p) for p in positions[i]], config
        )
        rep = precision_check(out[i], want, eps=2e-7)
        assert rep.ok, f"source {i}: {rep}"


def test_batch_hold_scene_noxfade_sharded(db, config):
    """Same over a 4-device source mesh: both variants run sharded and
    match the unsharded render."""
    import jax
    from jefferson_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    s, b_total = 8, 96
    fpb = config.frames_per_buffer
    rng = np.random.default_rng(7)
    positions = np.stack([
        np.stack([np.full(b_total, 20.0 * i), np.full(b_total, 5.0),
                  np.full(b_total, 0.9)], 1)
        for i in range(s)
    ])
    signals = (rng.standard_normal((s, b_total * fpb)) * 0.2).astype(np.float32)
    mesh = make_mesh(4, ("src",))
    br_m = BatchRenderer(db, config, chunk_blocks=32, mesh=mesh)
    br_1 = BatchRenderer(db, config, chunk_blocks=32)
    out_m = br_m.render(signals, positions)
    out_1 = br_1.render(signals, positions)
    assert {k[2] for k in br_m._jitted} == {True, False}, list(br_m._jitted)
    # shard-local vs global XLA scheduling may move ulps at most
    assert np.abs(out_m - out_1).max() < 5e-7


def test_reference_cadence_render(db, config):
    """Reference-cadence render (position steps every hold blocks, so EVERY
    chunk crossfades on 1-2 rows): every chunk runs the crossfade dedup
    program and stays on the oracle."""
    rng = np.random.default_rng(9)
    B, hold, cb = 512, 86, 256
    step = np.arange(B) // hold
    pos = np.stack([(5.0 * step) % 360.0, np.full(B, 0.0), np.full(B, 1.0)], 1)
    sig = (rng.standard_normal(B * config.frames_per_buffer) * 0.2).astype(np.float32)
    r = Renderer(db, config, chunk_blocks=cb)
    got = r.render(sig, pos)
    want = render_oracle(sig, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, str(rep)
    assert {k[1] for k in r._fd_dedup} == {True}, list(r._fd_dedup)
    # and the direct program gives the same samples
    direct = Renderer(db, config, chunk_blocks=cb, dedup=False).render(sig, pos)
    assert np.array_equal(got, direct)


def test_reference_cadence_batched(db, config):
    """Batched form of the same cadence: per-source 86-block holds."""
    s, B, cb = 4, 256, 128
    fpb = config.frames_per_buffer
    rng = np.random.default_rng(10)
    step = np.arange(B) // 86
    positions = np.stack([
        np.stack([(30.0 * i + 5.0 * step) % 360.0, np.full(B, 5.0),
                  np.full(B, 1.0)], 1)
        for i in range(s)
    ])
    signals = (rng.standard_normal((s, B * fpb)) * 0.2).astype(np.float32)
    br = BatchRenderer(db, config, chunk_blocks=cb)
    out = br.render(signals, positions)
    assert all(k[1] is not None and k[2] for k in br._jitted), list(br._jitted)
    for i in range(s):
        want = render_oracle(
            signals[i], db, [tuple(p) for p in positions[i]], config
        )
        rep = precision_check(out[i], want, eps=2e-7)
        assert rep.ok, f"source {i}: {rep}"


def test_live_block_step_noxfade_bit_identical(db, config):
    """StreamingSpatializer dispatches the no-crossfade block step on hold
    blocks — bit-identical to always running the crossfade step."""
    from jefferson_tpu.engine import stream as st

    rng = np.random.default_rng(11)
    sp = st.StreamingSpatializer(db, config)
    legacy = st._jitted_block_step(config)
    hist2 = jnp.zeros(config.history_len, jnp.float32)
    old2 = (np.float32(0.0), np.float32(0.0))
    for i in range(20):
        blk = (rng.standard_normal(config.frames_per_buffer) * 0.2).astype(np.float32)
        if i % 7 == 0:
            sp.set_position(azi=15.0 * i % 360)
        azi, ele = sp.azi, sp.ele
        idx_n, w_n = sp._interp(ele, azi)
        idx_o, w_o = sp._interp(old2[1], old2[0])
        xf = bool(old2[0] != azi or old2[1] != ele)
        uh, ul, df = sp._distance_current()
        want, hist2 = legacy(
            sp._spec_r, sp._spec_i, hist2, jnp.asarray(blk),
            idx_n, w_n, idx_o, w_o, jnp.asarray(xf), uh, ul, df,
        )
        old2 = (azi, ele)
        got = sp.process_block(blk)
        assert np.array_equal(got, np.asarray(want)), f"block {i}"
    assert sp.crossfades >= 2


def test_amortization_guard_single_noxf_chunk(db, config):
    """A lone crossfade-free chunk is NOT worth a second compile: a
    2-chunk hold render (one crossfading, one not) rides the crossfade
    program alone."""
    rng = np.random.default_rng(12)
    B = 64
    sig = (rng.standard_normal(B * config.frames_per_buffer) * 0.2).astype(np.float32)
    pos = np.stack([np.full(B, 40.0), np.full(B, 10.0), np.full(B, 1.0)], 1)
    r = Renderer(db, config, chunk_blocks=32)
    got = r.render(sig, pos)
    want = render_oracle(sig, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, str(rep)
    assert {k[1] for k in r._fd_dedup} == {True}, list(r._fd_dedup)


def test_mixed_mover_keeps_crossfade_program(db, config):
    """A scene whose every chunk crossfades compiles ONLY crossfade
    programs (no variant explosion on movers)."""
    from jefferson_tpu.trajectory.trajectory import CircularOrbit

    s, b_total = 2, 64
    fpb = config.frames_per_buffer
    rng = np.random.default_rng(8)
    positions = np.stack([
        CircularOrbit(period_s=0.2 + 0.1 * i, ele=5, r=1.0).sample(b_total, config)
        for i in range(s)
    ])
    signals = (rng.standard_normal((s, b_total * fpb)) * 0.2).astype(np.float32)
    br = BatchRenderer(db, config, chunk_blocks=32)
    br.render(signals, positions)
    assert {k[2] for k in br._jitted} == {True}, list(br._jitted)


@pytest.mark.parametrize("flags,want", [
    ([True, True, True], [True, True, True]),          # movers: one program
    ([True, False], [True, True]),                     # a lone hold chunk rides along
    ([True, False, False], [True, False, False]),      # two hold chunks earn a variant
    ([False, False], [False, False]),                  # all-hold render
])
def test_xfade_amortization_policy(flags, want):
    """The no-crossfade variant is elected only when at least two chunks
    use it (or the whole render is crossfade-free)."""
    from jefferson_tpu.engine.renderer import _apply_xfade_amortization

    assert _apply_xfade_amortization(flags) == want
