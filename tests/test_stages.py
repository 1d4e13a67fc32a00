"""Stage-level parity: every pipeline stage checked against the oracle,
mirroring precisionTest / xfadePrecisionCallbackTest / cufftSanityCheck
(reference: Jefferson/src/precision_test.cu:4-453, 1248-2002, 2005-2090)."""

import numpy as np
import pytest
import scipy.fft

import jax.numpy as jnp

from jefferson_tpu import ProcessType
from jefferson_tpu.engine.plan import make_plan
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.ops import fft as fft_ops
from jefferson_tpu.ops.filters import (
    blend_filters,
    crossfade_tails,
    distance_factors,
    distance_phase_split,
)
from jefferson_tpu.oracle.reference import OracleSpatializer, distance_factor
from jefferson_tpu.testing import precision_check
from jefferson_tpu.trajectory.spatial import spherical_to_cartesian


def test_fft_roundtrip_sanity(config):
    """cufftSanityCheck analogue: known sinusoids through both FFT backends."""
    n = config.pad_len
    t = np.arange(n)
    for freq in [1, 7, 128, 511]:
        x = np.sin(2 * np.pi * freq * t / n).astype(np.float32)
        for backend in ["fft", "matmul"]:
            rfft, irfft = fft_ops.get_backend(backend)
            spec = np.asarray(rfft(jnp.asarray(x), n))
            want = scipy.fft.rfft(x)
            # fft backend is bit-exact vs scipy here; the DFT-matmul backend
            # accumulates fp32 rounding over 1024 terms on O(512)-magnitude
            # unnormalized bins (measured worst ~1e-4)
            eps = 2e-4 if backend == "matmul" else 1e-6
            assert precision_check(spec.view(np.float32), want.astype(np.complex64).view(np.float32), eps=eps).ok
            back = np.asarray(irfft(jnp.asarray(spec), n))
            assert precision_check(back, x, eps=1e-5).ok, f"{backend} freq {freq}"


def test_fft_matches_scipy_tight(config):
    """XLA CPU FFT vs scipy on random data — the backend-convention check."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, config.pad_len)).astype(np.float32)
    spec = np.asarray(fft_ops.rfft(jnp.asarray(x)))
    want = scipy.fft.rfft(x).astype(np.complex64)
    rep = precision_check(spec.view(np.float32), want.view(np.float32), eps=1e-4)
    assert rep.ok, str(rep)


def test_distance_factor_stage(config):
    """Device distance factor vs oracle double-precision formula, many radii."""
    radii = np.array([0.1, 0.5, 1.0, 2.5, 4.9, 9.7], dtype=np.float32)
    coords = spherical_to_cartesian(np.zeros_like(radii), np.zeros_like(radii), radii)
    want = np.stack([distance_factor(c, config) for c in coords])
    scaled = (np.sqrt((coords**2).sum(-1)).astype(np.float32) / np.float32(config.distance_scale))
    u_hi, u_lo, inv_frac = distance_phase_split(config.fsvs, scaled, config.num_bins)
    got = np.asarray(
        distance_factors(jnp.asarray(u_hi), jnp.asarray(u_lo), jnp.asarray(inv_frac), config.num_bins)
    )
    rep = precision_check(got.view(np.float32), want.view(np.float32), eps=2e-6)
    assert rep.ok, str(rep)


def test_forward_spectrum_stage(db, config, castanets):
    """rfft of the overlap-save segment matches the oracle's scaled FFTW
    convention (engine folds the 1/N into irfft; compare unnormalized)."""
    sp = OracleSpatializer(db, config)
    sp.buf = castanets
    sp.feed_from_buf()
    want = scipy.fft.rfft(sp.x).astype(np.complex64)
    got = np.asarray(fft_ops.rfft(jnp.asarray(sp.x)))
    rep = precision_check(got.view(np.float32), want.view(np.float32), eps=1e-4)
    assert rep.ok, str(rep)


@pytest.mark.parametrize("ele,azi", [(0, 0), (0, 3), (5, 0), (5, 3), (-35, 7), (43, 119)])
def test_filter_blend_stage(db, config, ele, azi):
    """blend_filters == the oracle's case chains for all four cases."""
    from jefferson_tpu.oracle.reference import interpolate_loops
    from jefferson_tpu.trajectory.interpolation import interpolation_calculations

    rng = np.random.default_rng(2)
    spec = (rng.standard_normal(config.num_bins) + 1j * rng.standard_normal(config.num_bins)).astype(
        np.complex64
    )
    spec2 = np.stack([spec, spec])
    coords = spherical_to_cartesian(azi, ele, 1.3)
    df = distance_factor(coords, config)
    c = interpolation_calculations(float(ele), float(azi))
    want = interpolate_loops(spec2, db, c.indices[0], c.omegas[0], df)

    g = np.asarray(
        blend_filters(jnp.asarray(db.spectra), jnp.asarray(c.indices), jnp.asarray(c.weights))
    )[0]
    got = spec2 * g * df[None, :]
    rep = precision_check(got.view(np.float32), want.view(np.float32), eps=2e-5)
    assert rep.ok, str(rep)


def test_crossfade_stage():
    """crossFade kernel semantics: f[n]=n/(N-1), new ramps in
    (reference: Jefferson/src/kernels.cu:132-137)."""
    b, frames = 3, 128
    rng = np.random.default_rng(3)
    old = rng.standard_normal((b, 2, frames)).astype(np.float32)
    new = rng.standard_normal((b, 2, frames)).astype(np.float32)
    xf = np.array([True, False, True])
    got = np.asarray(crossfade_tails(jnp.asarray(old), jnp.asarray(new), jnp.asarray(xf)))
    fn = np.arange(frames, dtype=np.float32) / np.float32(frames - 1)
    want0 = old[0] * (1 - fn) + new[0] * fn
    np.testing.assert_allclose(got[0], want0, atol=1e-7)
    np.testing.assert_array_equal(got[1], new[1])  # no movement -> new only
    assert got[0, 0, 0] == old[0, 0, 0]  # ramp starts fully old
    np.testing.assert_allclose(got[2, :, -1], new[2, :, -1], atol=1e-7)  # ends fully new


def test_three_block_crossfade_sequence(db, config, castanets):
    """xfadePrecisionCallbackTest analogue: three consecutive moving blocks
    with overlap-save state carried across them, engine vs oracle."""
    positions = [(0.0, 0.0, 0.5), (5.0, 0.0, 0.5), (10.0, 5.0, 0.5)]
    r = Renderer(db, chunk_blocks=1)  # force per-block chunking: worst case
    got = r.render(castanets, positions, ProcessType.TPU_FD_COMPLEX)
    from jefferson_tpu.oracle.reference import render_oracle

    want = render_oracle(castanets, db, positions, config)
    rep = precision_check(got, want, eps=1e-6)
    assert rep.ok, str(rep)


def test_plan_crossfade_flags(config):
    pos = [(0, 0, 0.5), (0, 0, 0.5), (5, 0, 0.5), (5, 0, 0.5), (5, 1, 0.5)]
    plan = make_plan(np.asarray(pos, dtype=np.float64), config)
    # block 0: initial_old=(0,0) equals position -> no crossfade
    np.testing.assert_array_equal(plan.xfade, [False, False, True, False, True])


def test_plan_layer_validation_and_edges():
    """The plan layer's defensive edges: malformed positions, zero-block
    plans, no-op padding, non-mono feeds."""
    import pytest

    from jefferson_tpu import DEFAULT_CONFIG
    from jefferson_tpu.engine.plan import fed_stream, make_plan, pad_plan

    with pytest.raises(ValueError, match=r"positions must be \(B, 3\)"):
        make_plan(np.zeros((4, 2)), DEFAULT_CONFIG)
    with pytest.raises(ValueError, match="at least one block"):
        make_plan(np.zeros((0, 3)), DEFAULT_CONFIG)

    p = make_plan([(30.0, 0.0, 1.0)] * 4, DEFAULT_CONFIG)
    assert pad_plan(p, 0) is p  # no-op padding returns the plan unchanged

    with pytest.raises(ValueError, match="mono"):
        fed_stream(np.zeros((64, 2), np.float32), 1, DEFAULT_CONFIG)


def test_blend_channel_reference_shape_matches_einsum():
    """The kept per-plane blend (ops/filters.blend_channel) equals the
    einsum/gather forms it documents itself against."""
    import jax.numpy as jnp

    from jefferson_tpu.ops.filters import blend_channel

    rng = np.random.default_rng(11)
    table = rng.standard_normal((32, 17)).astype(np.float32)
    idx = rng.integers(0, 32, size=(6, 4)).astype(np.int32)
    w = rng.random((6, 4), dtype=np.float32)
    got = np.asarray(blend_channel(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)))
    want = np.einsum("bk,bkf->bf", w, table[idx])
    np.testing.assert_allclose(got, want, atol=1e-6)
