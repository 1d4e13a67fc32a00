"""Interpolation setup tests: scalar C-port fuzz parity, quirk reproduction,
case-weight equivalence against the oracle's convolution chains."""

import numpy as np

from jefferson_tpu.hrtf import kemar
from jefferson_tpu.trajectory.interpolation import interpolation_calculations


def scalar_interpolation(ele: float, azi: float):
    """Direct loop port of interpolationCalculations
    (Jefferson/src/SoundSource.cu:65-105) with C float/int semantics."""
    ele = np.float32(ele)
    azi = np.float32(azi)
    phi = [0, 0]
    phi[0] = int(int(ele) / 10) * 10 if ele >= 0 else -(int(-int(ele)) // 10) * 10
    # exact C: int(ele)/10*10 with truncation toward zero
    phi[0] = int(np.trunc(np.trunc(ele) / 10) * 10)
    phi[1] = int(np.trunc(np.trunc(ele + np.float32(9)) / 10) * 10)
    omegaE = np.float32((ele - phi[0]) / np.float32(10.0))
    omegaF = np.float32((phi[1] - ele) / np.float32(10.0))
    deltaTheta1 = deltaTheta2 = None
    for i in range(kemar.NUM_ELEV):
        if phi[0] == kemar.ELEVATIONS[i]:
            deltaTheta1 = np.float32(kemar.AZIMUTH_INC[i])
        if phi[1] == kemar.ELEVATIONS[i]:
            deltaTheta2 = np.float32(kemar.AZIMUTH_INC[i])
            break
    theta = [0] * 4
    theta[0] = int(np.trunc(np.float32(np.trunc(azi / deltaTheta1)) * deltaTheta1))
    theta[1] = int(
        np.trunc(np.float32(np.trunc((azi + deltaTheta1 - np.float32(1)) / deltaTheta1)) * deltaTheta1)
    )
    theta[2] = int(np.trunc(np.float32(np.trunc(azi / deltaTheta2)) * deltaTheta2))
    theta[3] = int(
        np.trunc(np.float32(np.trunc((azi + deltaTheta2 - np.float32(1)) / deltaTheta2)) * deltaTheta2)
    )
    omegaA = np.float32((azi - theta[0]) / deltaTheta1)
    omegaB = np.float32((theta[1] - azi) / deltaTheta1)
    omegaC = np.float32((azi - theta[2]) / deltaTheta2)
    omegaD = np.float32((theta[3] - azi) / deltaTheta2)
    idx = [
        kemar.pick_hrtf(phi[0], theta[0]),
        kemar.pick_hrtf(phi[0], theta[1]),
        kemar.pick_hrtf(phi[1], theta[2]),
        kemar.pick_hrtf(phi[1], theta[3]),
    ]
    return np.array(idx), np.array([omegaA, omegaB, omegaC, omegaD, omegaE, omegaF], np.float32)


def test_matches_scalar_port_on_integer_grid():
    eles = np.arange(-40, 91, dtype=np.float32)
    azis = np.arange(0, 360, dtype=np.float32)
    E, A = np.meshgrid(eles, azis, indexing="ij")
    got = interpolation_calculations(E.ravel(), A.ravel())
    # spot-check 400 random positions against the scalar port
    rng = np.random.default_rng(11)
    sel = rng.integers(0, E.size, 400)
    for s in sel:
        idx, omg = scalar_interpolation(E.ravel()[s], A.ravel()[s])
        np.testing.assert_array_equal(got.indices[s], idx)
        np.testing.assert_array_equal(got.omegas[s], omg)


def test_grid_point_is_case_one():
    c = interpolation_calculations(0.0, 0.0)
    assert c.case[0] == 1
    assert list(c.indices[0]) == [260] * 4
    np.testing.assert_array_equal(c.weights[0], [1, 0, 0, 0])


def test_azimuth_interp_case_two():
    # elev on grid (0), azi off grid (3) -> interpolate azimuth only
    c = interpolation_calculations(0.0, 3.0)
    assert c.case[0] == 2
    i0, i1 = c.indices[0, 0], c.indices[0, 1]
    assert i0 == 260 and i1 == 261
    # weights are (omegaB, omegaA): (5-3)/5 and (3-0)/5
    np.testing.assert_allclose(c.weights[0], [0.4, 0.6, 0.0, 0.0], atol=1e-7)


def test_elevation_interp_case_three():
    c = interpolation_calculations(5.0, 0.0)
    assert c.case[0] == 3
    assert c.indices[0, 0] == 260 and c.indices[0, 2] == 332
    np.testing.assert_allclose(c.weights[0], [0.5, 0.0, 0.5, 0.0], atol=1e-7)


def test_full_bilinear_case_four():
    c = interpolation_calculations(5.0, 3.0)
    assert c.case[0] == 4
    # omegaF*omegaB, omegaF*omegaA, omegaE*omegaD, omegaE*omegaC
    np.testing.assert_allclose(c.weights[0], [0.5 * 0.4, 0.5 * 0.6, 0.5 * 0.4, 0.5 * 0.6], atol=1e-6)


def test_fractional_increment_quirk():
    """azi=355 at elev ±40 (inc 6.43): theta0=353, theta1=360, but both snap
    to grid entry i=55 (353.65 deg), and the truncated-degree thetas make
    omegaA+omegaB = (355-353)/6.43 + (360-355)/6.43 ≈ 1.089 — weights that
    don't sum to 1.  The engine must reproduce this, not 'fix' it."""
    c = interpolation_calculations(-40.0, 355.0)
    idx, omg = scalar_interpolation(-40.0, 355.0)
    np.testing.assert_array_equal(c.indices[0], idx)
    np.testing.assert_array_equal(c.omegas[0], omg)
    assert idx[0] == idx[1] == 55  # both azimuth brackets hit the same filter
    assert omg[0] + omg[1] > 1.05  # non-normalized weights preserved


def test_negative_elevation_truncation():
    """ele=-35: C integer division gives phi=(-30,-20), omegaE=-0.5, omegaF=1.5."""
    c = interpolation_calculations(-35.0, 0.0)
    _, omg = scalar_interpolation(-35.0, 0.0)
    np.testing.assert_array_equal(c.omegas[0], omg)
    assert omg[4] == np.float32(-0.5) and omg[5] == np.float32(1.5)


def test_effective_weights_match_case_chains(db):
    """sum_i w_i * H[idx_i] must equal the oracle's per-case chains up to
    float32 reassociation (the engine uses the weighted-sum form)."""
    rng = np.random.default_rng(5)
    spec = (rng.standard_normal(513) + 1j * rng.standard_normal(513)).astype(np.complex64)
    spec2 = np.stack([spec, spec])
    df = np.ones(513, dtype=np.complex64)
    from jefferson_tpu.oracle.reference import interpolate_loops

    for ele, azi in [(0, 0), (0, 3), (5, 0), (5, 3), (-35, 7), (-40, 355), (43, 119)]:
        c = interpolation_calculations(float(ele), float(azi))
        chain = interpolate_loops(spec2, db, c.indices[0], c.omegas[0], df)
        blended = np.einsum("k,kcb->cb", c.weights[0], db.spectra[c.indices[0]]) * spec2
        np.testing.assert_allclose(chain, blended, atol=2e-5, rtol=1e-4)
