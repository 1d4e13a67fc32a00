"""Engine vs NumPy-oracle parity: the framework's core gate.

Mirrors the reference's four-tier strategy (SURVEY.md section 4): stage-level
checks live in test_stages.py; this file covers end-to-end block renders for
all process types, crossfade paths over consecutive blocks, chunk-boundary
state carry, and the wrapping playhead.
"""

import numpy as np
import pytest

from jefferson_tpu import ProcessType
from jefferson_tpu.engine.plan import make_plan
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.oracle.reference import render_oracle
from jefferson_tpu.testing import precision_check
from jefferson_tpu.trajectory.trajectory import CircularOrbit, PositionEvents, StaticPosition

# engine (float32 JAX) vs oracle (float32 NumPy/scipy): both single precision,
# differing only in op order / FFT implementation.  The reference holds 2e-7
# between cuFFT and FFTW (Precision_Check.py); we gate the same way with a
# modest allowance for XLA's FFT.
E2E_EPS = 1e-6


@pytest.fixture(scope="module")
def renderer(db):
    return Renderer(db, chunk_blocks=64)


def _positions(traj, blocks, config):
    return traj.sample(blocks, config)


@pytest.mark.parametrize(
    "ptype",
    [ProcessType.TPU_FD_COMPLEX, ProcessType.TPU_FD_BASIC, ProcessType.TPU_TD],
)
def test_static_source_parity(renderer, db, config, castanets, ptype):
    """BASELINE config 1: static source, file-to-file (+ basic & TD modes)."""
    traj = StaticPosition(azi=30, ele=10, r=1.5)
    pos = _positions(traj, 40, config)
    got = renderer.render(castanets, pos, ptype)
    # the TD engine implements the reference's GPU TD gain semantics
    # (kernels.cu:146); the oracle defaults to its CPU TD gain=1 — pass
    # td_gain to gate against the GPU behavior the engine mirrors
    td_gain = config.source_gain if ptype == ProcessType.TPU_TD else 1.0
    want = render_oracle(castanets, db, [tuple(p) for p in pos], config, ptype,
                         td_gain=td_gain)
    rep = precision_check(got, want, eps=E2E_EPS if ptype != ProcessType.TPU_TD else 5e-6)
    assert rep.ok, f"{ptype.name}: {rep}"


def test_initial_crossfade_matches_reference_default(renderer, db, config, castanets):
    """With initial_old=(0,0) (the constructor state), a static source not at
    (0,0) crossfades on block 0 exactly like the reference."""
    pos = StaticPosition(azi=90, ele=0, r=1.0).sample(6, config)
    got = renderer.render(castanets, pos, ProcessType.TPU_FD_COMPLEX, initial_old=(0.0, 0.0))
    want = render_oracle(
        castanets, db, [tuple(p) for p in pos], config, initial_old=(0.0, 0.0)
    )
    rep = precision_check(got, want, eps=E2E_EPS)
    assert rep.ok, str(rep)
    # and the no-crossfade variant differs on block 0 only
    got2 = renderer.render(castanets, pos, ProcessType.TPU_FD_COMPLEX, initial_old=None)
    assert np.abs(got2[:128] - got[:128]).max() > 1e-4
    np.testing.assert_allclose(got2[128:], got[128:], atol=2e-6)


def test_moving_source_crossfade_parity(renderer, db, config, castanets):
    """BASELINE config 2: orbiting source; crossfade fires on most blocks."""
    traj = CircularOrbit(period_s=0.8, ele=7, r=2.0)
    pos = _positions(traj, 80, config)
    plan = make_plan(pos, config)
    assert plan.xfade[1:].mean() > 0.5  # the orbit really does move per block
    got = renderer.render(castanets, pos, ProcessType.TPU_FD_COMPLEX)
    want = render_oracle(castanets, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=E2E_EPS)
    assert rep.ok, str(rep)


def test_scripted_events_parity(renderer, db, config, castanets):
    """DEBUGMODE-2 style scripted jumps (reference: Jefferson/src/main.cu:101-148)."""
    traj = PositionEvents(
        [
            (0.00, 0, 0, 0.5),
            (0.02, 2, 4, 0.5),
            (0.05, 1, 3, 0.7),
            (0.08, 4, 2, 0.7),
            (0.11, 7, 9, 1.0),
            (0.14, 0, 0, 0.5),
        ]
    )
    pos = _positions(traj, 60, config)
    got = renderer.render(castanets, pos, ProcessType.TPU_FD_COMPLEX)
    want = render_oracle(castanets, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=E2E_EPS)
    assert rep.ok, str(rep)


def test_chunk_boundary_state_carry(db, config, castanets):
    """Identical output regardless of chunk size (overlap-save carry)."""
    pos = CircularOrbit(period_s=1.0).sample(50, config)
    r_small = Renderer(db, chunk_blocks=7)
    r_big = Renderer(db, chunk_blocks=512)
    a = r_small.render(castanets, pos)
    b = r_big.render(castanets, pos)
    rep = precision_check(a, b, eps=1e-7)
    assert rep.ok, str(rep)


def test_wrapping_playhead(renderer, db, config):
    """Input shorter than the render wraps mid-block like the reference
    (reference: Jefferson/src/Audio.cu:121-139)."""
    rng = np.random.default_rng(0)
    short = (rng.standard_normal(1000) * 0.3).astype(np.float32)  # not a multiple of 128
    pos = StaticPosition(azi=15, ele=0, r=0.8).sample(30, config)
    got = renderer.render(short, pos)
    want = render_oracle(short, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=E2E_EPS)
    assert rep.ok, str(rep)


def test_sub_block_playhead_parity(renderer, db, config):
    """A buffer SHORTER than one block tiles modularly on both sides
    (engine fix 97c8a21; the oracle's single-wrap concatenate used to
    crash here, leaving the case untestable against ground truth)."""
    rng = np.random.default_rng(1)
    tiny = (rng.standard_normal(70) * 0.3).astype(np.float32)  # < fpb=128
    pos = CircularOrbit(period_s=0.05, ele=5, r=0.9).sample(12, config)
    got = renderer.render(tiny, pos)
    want = render_oracle(tiny, db, [tuple(p) for p in pos], config)
    rep = precision_check(got, want, eps=E2E_EPS)
    assert rep.ok, str(rep)


def test_matmul_backend_matches_fft(db, config, castanets):
    """The DFT-matmul backend is numerically interchangeable."""
    pos = CircularOrbit(period_s=1.5).sample(40, config)
    a = Renderer(db, chunk_blocks=64, backend="fft").render(castanets, pos)
    b = Renderer(db, chunk_blocks=64, backend="matmul").render(castanets, pos)
    rep = precision_check(a, b, eps=5e-6)
    assert rep.ok, str(rep)


def test_distance_attenuation_behavior(renderer, config, castanets):
    """Farther sources are quieter (1/(1+(fs/vs)r²) rolloff)."""
    near = renderer.render(castanets, StaticPosition(azi=45, r=1.0).sample(20, config))
    far = renderer.render(castanets, StaticPosition(azi=45, r=4.0).sample(20, config))
    assert np.sqrt(np.mean(far**2)) < 0.3 * np.sqrt(np.mean(near**2))


def test_td_equals_fd_basic_static(renderer, db, config, castanets):
    """Independent math cross-check: with the same nearest filter, the naive
    time-domain convolution and the overlap-save FD convolution compute the
    same linear convolution — two disjoint code paths, one answer."""
    pos = StaticPosition(azi=75, ele=-20, r=1.0).sample(24, config)
    td = renderer.render(castanets, pos, ProcessType.TPU_TD)
    fd = renderer.render(castanets, pos, ProcessType.TPU_FD_BASIC)
    # TD applies the GPU-path source gain (kernels.cu:146); FD_BASIC, like
    # the reference's fftConvolve, does not — undo it for the math check
    rep = precision_check(td / np.float32(min(config.source_gain, 1.0)), fd, eps=2e-5)
    assert rep.ok, str(rep)


def test_td_gain_semantics(renderer, db, config, castanets):
    """source_gain is applied by the TD path only, clamped at 1, mirroring
    the reference's GPU TD kernel (kernels.cu:146, GPUSoundSource.cu:418-419)
    — while its CPU TD path (the oracle default) hardcodes gain = 1, a
    reference-side divergence kept as contract (PARITY.md defect list)."""
    pos = StaticPosition(azi=30, ele=0, r=1.0).sample(12, config)
    td = renderer.render(castanets, pos, ProcessType.TPU_TD)
    cpu = render_oracle(castanets, db, [tuple(p) for p in pos], config,
                        ProcessType.CPU_TD)  # td_gain default 1.0
    assert np.abs(cpu).max() > 0
    # engine output == CPU oracle scaled by the (clamped) source gain
    rep = precision_check(td, cpu * np.float32(config.source_gain), eps=5e-6)
    assert rep.ok, str(rep)
    # a gain > 1 clamps to 1 on both sides (GPUSoundSource.cu:418-419)
    import dataclasses

    cfg_hot = dataclasses.replace(config, source_gain=1.7)
    from jefferson_tpu.engine.renderer import Renderer

    td_hot = Renderer(db, cfg_hot, chunk_blocks=16).render(castanets, pos, ProcessType.TPU_TD)
    hot = render_oracle(castanets, db, [tuple(p) for p in pos], cfg_hot,
                        ProcessType.CPU_TD, td_gain=1.7)
    rep = precision_check(td_hot, hot, eps=5e-6)
    assert rep.ok, str(rep)
    rep = precision_check(td_hot, cpu, eps=5e-6)  # clamped == unity gain
    assert rep.ok, str(rep)


def test_empty_signal_rejected(renderer, config):
    with pytest.raises(ValueError, match="empty"):
        renderer.render(np.zeros(0, np.float32), StaticPosition().sample(4, config))


@pytest.mark.parametrize("ptype", [ProcessType.TPU_FD_COMPLEX, ProcessType.TPU_FD_BASIC])
def test_static_source_parity_fft_backend(db, config, castanets, ptype):
    """The complex64 fft backend (cuFFT on the GPU) holds the reference's
    2e-7 gate for a static source on both FD paths."""
    pos = StaticPosition(azi=35, ele=10, r=0.8).sample(40, config)
    got = Renderer(db, chunk_blocks=16, backend="fft").render(castanets, pos, ptype)
    want = render_oracle(castanets, db, [tuple(p) for p in pos], config,
                         ProcessType(ptype.value + 3))
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, str(rep)


def test_fd_basic_fft_backend_parity(db, config, castanets):
    """The nearest-HRTF FD path (-t 1) through the complex/FFT-HLO backend
    (the matmul-backend form is gated by test_static_source_parity; this
    pins _fd_basic_chunk's fft arm, reference CPUSoundSource.cpp:113-142)."""
    pos = CircularOrbit(period_s=0.4, ele=10, r=1.0).sample(40, config)
    got = Renderer(db, chunk_blocks=40, backend="fft").render(
        castanets, pos, ProcessType.TPU_FD_BASIC
    )
    want = render_oracle(
        castanets, db, [tuple(p) for p in pos], config, ProcessType.CPU_FD_BASIC
    )
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, rep


def test_unaligned_geometry_parity():
    """Non-power-of-two block sizes make history_len % fpb != 0, so the
    forward DFT takes explicit windows instead of the sliding sub-block
    form and dedup is off — the direct program must stay inside the oracle
    gate."""
    import jefferson_tpu as jt

    cfg = jt.EngineConfig(frames_per_buffer=100)
    assert cfg.history_len % cfg.frames_per_buffer != 0  # 924 % 100
    db = jt.synthetic_database(cfg)
    nb = 24
    pos = CircularOrbit(period_s=0.1, ele=5, r=1.0).sample(nb, cfg)
    sig = (np.random.default_rng(0).standard_normal(nb * 100) * 0.2).astype(
        np.float32
    )
    r = Renderer(db, cfg, chunk_blocks=nb)
    got = r.render(sig, pos)
    want = render_oracle(sig, db, [tuple(p) for p in pos], cfg)
    rep = precision_check(got, want, eps=5e-7)
    assert rep.ok, rep
    assert r._fd_complex and not r._fd_dedup


def test_program_count_discipline_mixed_render(db, config, castanets):
    """The one-compiled-program-per-render rule: a long mixed hold/move
    render compiles at most TWO variants per path (crossfading +
    crossfade-free), across every program cache."""
    from jefferson_tpu.engine.renderer import Renderer
    from jefferson_tpu.trajectory.trajectory import AzimuthSweep

    traj = AzimuthSweep(start_azi=0, ele=0, r=0.5, step_deg=5,
                        blocks_per_step=24, num_steps=9)
    pos = traj.sample(traj.total_blocks, config)  # 240 blocks, periodic moves
    r = Renderer(db, config, chunk_blocks=48)
    out = r.render(castanets, pos, initial_old=(0.0, 0.0))
    assert np.isfinite(out).all()
    for name in ("_fd_complex", "_fd_dedup"):
        cache = getattr(r, name)
        assert len(cache) <= 2, (name, list(cache))
    total = len(r._fd_complex) + len(r._fd_dedup)
    assert 1 <= total <= 2, total  # one path elected, at most 2 xfade variants
