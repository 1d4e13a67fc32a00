"""Bilinear HRTF interpolation setup: indices, weights, and case selection.

Vectorized exact port of SoundSource::interpolationCalculations (reference:
Jefferson/src/SoundSource.cu:65-105) plus the 4-way case dispatch of
cpuInterpolateLoops (reference: Jefferson/src/CPUSoundSource.cpp:255-273).

The reference's quirky integer semantics are reproduced deliberately:

  * ``phi``/``theta`` use C truncation-toward-zero on float->int conversion,
    so e.g. azi=354 at increment 6.43 yields theta0 = theta1 = 353 and a
    *negative* omegaB (-0.1555; azi=355 is the benign neighbor with
    omegaB=+0.7776) — the engine must do what the reference does, not what
    textbook bilinear interpolation would do.
  * omegaA+omegaB do not generally sum to 1 for fractional increments
    because theta is truncated to whole degrees before the weight division.

Here the reference's four separately-launched kernel chains (reference:
Jefferson/src/GPUSoundSource.cu:118-317) collapse into one gather of 4
spectra + a per-block 4-weight blend; the case dispatch merely selects the
effective weights, so there is no data-dependent branching on the hot path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..hrtf.kemar import AZIMUTH_INC, ELEVATIONS, pick_hrtf

_F32 = np.float32


def _trunc_i(x: np.ndarray) -> np.ndarray:
    """C float->int conversion: truncate toward zero."""
    return np.trunc(x).astype(np.int32)


@dataclasses.dataclass
class InterpCoeffs:
    """Per-position interpolation data (leading batch dims preserved)."""

    indices: np.ndarray   # (..., 4) int32 — HRTF filter indices
    weights: np.ndarray   # (..., 4) float32 — effective case weights
    omegas: np.ndarray    # (..., 6) float32 — raw omegaA..omegaF
    case: np.ndarray      # (...,) int8 — 1..4, which reference case fired


def interpolation_calculations(ele, azi) -> InterpCoeffs:
    """Compute the 4 filter indices + 6 omegas for (ele, azi) degrees.

    Exact float32 port of reference: Jefferson/src/SoundSource.cu:65-105.
    Accepts scalars or arrays (broadcast together).
    """
    ele = np.atleast_1d(np.asarray(ele, dtype=_F32))
    azi = np.atleast_1d(np.asarray(azi, dtype=_F32))
    ele, azi = np.broadcast_arrays(ele, azi)
    ele = ele.astype(_F32)
    azi = azi.astype(_F32)

    from ..native import HAVE_NATIVE

    if HAVE_NATIVE:
        # C++ port of the same math — BIT-EXACT vs the NumPy path below
        # (asserted in tests/test_native.py) and ~12x faster per position
        from ..native import interp_plan

        shape = ele.shape
        idx, w, om, case = interp_plan(ele.ravel(), azi.ravel())
        return InterpCoeffs(
            indices=idx.reshape(shape + (4,)),
            weights=w.reshape(shape + (4,)),
            omegas=om.reshape(shape + (6,)),
            case=case.reshape(shape),
        )

    # phi[0] = int(ele)/10*10; phi[1] = int(ele+9)/10*10  (C integer division)
    def c_div10_mul10(v):
        # C's truncating integer division: one definition for both phis
        # (and the native interp_one port, which must stay bit-exact)
        return np.where(v < 0, -((-v) // 10 * 10), v // 10 * 10).astype(np.int32)

    phi0 = c_div10_mul10(_trunc_i(ele))
    phi1 = c_div10_mul10(_trunc_i(ele + _F32(9.0)))

    omega_e = ((ele - phi0.astype(_F32)) / _F32(10.0)).astype(_F32)
    omega_f = ((phi1.astype(_F32) - ele) / _F32(10.0)).astype(_F32)

    # deltaTheta lookup by exact elevation-row match; out-of-table phi values
    # are undefined behavior in the reference — we clamp to the table range.
    def row_of(phi):
        r = (np.clip(phi, ELEVATIONS[0], ELEVATIONS[-1]) - ELEVATIONS[0]) // 10
        return r.astype(np.int32)

    dt1 = AZIMUTH_INC[row_of(phi0)].astype(_F32)
    dt2 = AZIMUTH_INC[row_of(phi1)].astype(_F32)

    # theta[j] = int( trunc(azi/dt)*dt ) with C truncation at every int cast
    def thetas(dt):
        t_lo = _trunc_i(_trunc_i(azi / dt).astype(_F32) * dt)
        t_hi = _trunc_i(_trunc_i((azi + dt - _F32(1.0)) / dt).astype(_F32) * dt)
        return t_lo, t_hi

    theta0, theta1 = thetas(dt1)
    theta2, theta3 = thetas(dt2)

    omega_a = ((azi - theta0.astype(_F32)) / dt1).astype(_F32)
    omega_b = ((theta1.astype(_F32) - azi) / dt1).astype(_F32)
    omega_c = ((azi - theta2.astype(_F32)) / dt2).astype(_F32)
    omega_d = ((theta3.astype(_F32) - azi) / dt2).astype(_F32)

    idx = np.stack(
        [
            pick_hrtf(phi0.astype(_F32), theta0.astype(_F32)),
            pick_hrtf(phi0.astype(_F32), theta1.astype(_F32)),
            pick_hrtf(phi1.astype(_F32), theta2.astype(_F32)),
            pick_hrtf(phi1.astype(_F32), theta3.astype(_F32)),
        ],
        axis=-1,
    ).astype(np.int32)

    omegas = np.stack([omega_a, omega_b, omega_c, omega_d, omega_e, omega_f], axis=-1)

    # --- case dispatch (reference: Jefferson/src/CPUSoundSource.cpp:258-272) ---
    i0, i1, i2, i3 = (idx[..., k] for k in range(4))
    case1 = (i0 == i1) & (i1 == i2) & (i2 == i3)
    case2 = ~case1 & (i0 == i2)
    case3 = ~case1 & ~case2 & (i0 == i1)
    case4 = ~(case1 | case2 | case3)
    case = (
        1 * case1.astype(np.int8)
        + 2 * case2.astype(np.int8)
        + 3 * case3.astype(np.int8)
        + 4 * case4.astype(np.int8)
    )

    zeros = np.zeros_like(omega_a)
    ones = np.ones_like(omega_a)
    # effective per-filter weights, float32 products exactly as the reference
    # chains them (caseTwo: omegas[1],omegas[0]; caseThree: omegas[5],omegas[4];
    # caseFour: wF*wB, wF*wA, wE*wD, wE*wC —
    # reference: Jefferson/src/CPUSoundSource.cpp:174-175,202-203,239-242)
    w_c1 = np.stack([ones, zeros, zeros, zeros], axis=-1)
    w_c2 = np.stack([omega_b, omega_a, zeros, zeros], axis=-1)
    w_c3 = np.stack([omega_f, zeros, omega_e, zeros], axis=-1)
    w_c4 = np.stack(
        [
            (omega_f * omega_b).astype(_F32),
            (omega_f * omega_a).astype(_F32),
            (omega_e * omega_d).astype(_F32),
            (omega_e * omega_c).astype(_F32),
        ],
        axis=-1,
    )
    cs = case[..., None]
    weights = np.where(cs == 1, w_c1, np.where(cs == 2, w_c2, np.where(cs == 3, w_c3, w_c4)))

    return InterpCoeffs(
        indices=idx,
        weights=weights.astype(_F32),
        omegas=omegas.astype(_F32),
        case=case,
    )
