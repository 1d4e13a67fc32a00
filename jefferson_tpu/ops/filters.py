"""Frequency-domain filter ops: distance factor, HRTF blend, crossfade.

These are the XLA-native re-designs of the reference's per-block CUDA kernel
chains (reference: Jefferson/src/kernels.cu:44-137,
Jefferson/src/GPUSoundSource.cu:118-317).  Where the reference launches up to
16 tiny 513-element kernels per block across 8 streams, here each op is a
batched tensor expression over all blocks at once and XLA fuses the chain.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

_MASK_LOW12 = np.int32(~0xFFF)


def distance_phase_split(fsvs: float, radii: np.ndarray, num_bins: int):
    """Host-side prep for the distance factor, float64-accurate on device.

    The distance cue's phase ramp is arg[k] = 2π·fsvs·r·k/N (reference:
    Jefferson/src/CPUSoundSource.cpp:46-47, kernels.cu:116-125).  For k up to
    512 a plain float32 product loses ~1e-4 rad of phase, so the per-block
    cycle step u = fsvs·r/N is split into a 12-bit head ``u_hi`` (whose
    product with any k < 4096 is exact in fp32) plus a tail ``u_lo``; the
    device reduces mod 1 after the exact head product, keeping phase error
    below ~1e-7 rad — matching the reference's double-precision cos/sin.

    Returns (u_hi, u_lo, inv_frac) float32 arrays shaped like ``radii``.
    ``radii`` are the *scaled* radii (|coords|/distance_scale) in float32.
    """
    r = np.asarray(radii, dtype=np.float32)
    from ..native import HAVE_NATIVE

    if HAVE_NATIVE and r.ndim == 1:  # bit-exact C++ port (tests/test_native.py)
        from ..native import distance_phase_split as native_dps

        return native_dps(float(fsvs), r, num_bins)
    fsvs32 = np.float32(fsvs)
    u = np.float64(fsvs32) * r.astype(np.float64) / np.float64(num_bins)
    u_hi = np.float32(u)
    u_hi = (u_hi.view(np.int32) & _MASK_LOW12).view(np.float32)
    u_lo = np.float32(u - u_hi)
    # frac = 1 + fsvs * r^2 in float32 like the reference
    frac = np.float32(1.0) + fsvs32 * r * r
    inv_frac = (np.float32(1.0) / frac).astype(np.float32)
    return u_hi, u_lo, inv_frac


def distance_factors(u_hi: jax.Array, u_lo: jax.Array, inv_frac: jax.Array, num_bins: int) -> jax.Array:
    """(B,) phase-split params -> (B, num_bins) complex64 distance factors."""
    k = jnp.arange(num_bins, dtype=jnp.float32)
    head = u_hi[:, None] * k[None, :]            # exact in fp32 (12+12 bits)
    head = head - jnp.floor(head)                # mod 1, exact
    cycles = head + u_lo[:, None] * k[None, :]   # tail product is tiny
    cycles = cycles - jnp.floor(cycles)
    arg = (2.0 * jnp.pi) * cycles
    re = jnp.cos(arg) * inv_frac[:, None]
    im = -jnp.sin(arg) * inv_frac[:, None]
    return jax.lax.complex(re, im)


def blend_filters(spectra: jax.Array, indices: jax.Array, weights: jax.Array) -> jax.Array:
    """Gather + blend the 4 bracketing HRTF pairs per block.

    spectra: (num_hrtf, 2, bins) complex64 — the shared FFTW-convention table
    indices: (B, 4) int32, weights: (B, 4) float32 (effective case weights)
    -> (B, 2, bins) complex64

    This one gather+blend replaces the reference's caseOne..caseFour kernel
    chains (reference: Jefferson/src/GPUSoundSource.cu:118-317): the case
    logic is already folded into the weights host-side.
    """
    # a multiply-add per bracket, not a contraction: an fp32 dot left at
    # DEFAULT precision may run in TF32 on a GPU, far outside the 2e-7 gate
    w = weights.astype(jnp.float32)
    acc = w[:, 0, None, None] * spectra[indices[:, 0]]
    for j in range(1, indices.shape[1]):
        acc = acc + w[:, j, None, None] * spectra[indices[:, j]]
    return acc


# --- split (real/imag plane) variants --------------------------------------
# Used by the matmul-backend engine path (explicit real/imag float32 planes).


def cmul(ar: jax.Array, ai: jax.Array, br: jax.Array, bi: jax.Array):
    """Elementwise complex multiply on explicit planes."""
    return ar * br - ai * bi, ar * bi + ai * br


def distance_factors_split(u_hi, u_lo, inv_frac, num_bins: int):
    """Like distance_factors but returns (re, im) float32 planes."""
    k = jnp.arange(num_bins, dtype=jnp.float32)
    head = u_hi[:, None] * k[None, :]
    head = head - jnp.floor(head)
    cycles = head + u_lo[:, None] * k[None, :]
    cycles = cycles - jnp.floor(cycles)
    arg = (2.0 * jnp.pi) * cycles
    return jnp.cos(arg) * inv_frac[:, None], -jnp.sin(arg) * inv_frac[:, None]


def blend_filters_split(spec_r: jax.Array, spec_i: jax.Array, indices: jax.Array, weights: jax.Array):
    """Gather + blend on (num_hrtf, 2, bins) float32 planes -> (B, 2, bins) x2."""
    w = weights.astype(jnp.float32)
    gr = w[:, 0, None, None] * jnp.take(spec_r, indices[:, 0], axis=0)
    gi = w[:, 0, None, None] * jnp.take(spec_i, indices[:, 0], axis=0)
    for j in range(1, indices.shape[1]):  # multiply-add, as blend_filters
        gr = gr + w[:, j, None, None] * jnp.take(spec_r, indices[:, j], axis=0)
        gi = gi + w[:, j, None, None] * jnp.take(spec_i, indices[:, j], axis=0)
    return gr, gi


def blend_channel(table: jax.Array, indices: jax.Array, weights: jax.Array) -> jax.Array:
    """Weighted 4-row gather from one (num_hrtf, bins) channel plane -> (B, bins).

    Unrolled per bracket: XLA lowers each term to a single row-gather fused
    with the scale/add.

    NOTE: the production engine blends all four planes at once from the
    combined-plane table (engine/renderer.blend_cat); this per-plane form
    is kept as the simple reference shape.
    """
    w = weights.astype(jnp.float32)
    acc = w[:, 0:1] * jnp.take(table, indices[:, 0], axis=0)
    for j in range(1, indices.shape[1]):
        acc = acc + w[:, j : j + 1] * jnp.take(table, indices[:, j], axis=0)
    return acc


def crossfade_tails(y_old: jax.Array, y_new: jax.Array, xfade: jax.Array) -> jax.Array:
    """Linear crossfade of the final block frames when the source moved.

    y_old/y_new: (B, 2, frames); xfade: (B,) bool.
    f[n] = n/(frames-1); out = old*(1-f) + new*f (reference:
    Jefferson/src/kernels.cu:132-137 — the engine ramp, new filter ramps in).
    """
    frames = y_new.shape[-1]
    fn = jnp.arange(frames, dtype=jnp.float32) / jnp.float32(frames - 1)
    mixed = y_old * (1.0 - fn) + y_new * fn
    return jnp.where(xfade[:, None, None], mixed, y_new)
