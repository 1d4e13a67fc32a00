"""FFT ops for the block pipeline.

The reference's cuFFT plans (R2C 1024, batched C2R with interleaved output,
reference: Jefferson/src/GPUSoundSource.cu:44-71) map to XLA's FFT HLO via
``jnp.fft.rfft/irfft`` (cuFFT on the GPU).  A DFT-as-matmul backend is also
provided: at the fixed engine size (1024 -> 513 bins) the transform is two
fp32 matmuls, and its inverse can be truncated to the output tail.  Every
matmul here runs at Precision.HIGHEST: left at DEFAULT, an fp32 product may
run in TF32 on a GPU, far outside the reference's 2e-7 gate.

Convention: ``rfft`` is unnormalized, ``irfft`` carries the 1/N — together
they reproduce the reference's forward-1/N + unnormalized-C2R pipeline
(see jefferson_tpu.oracle.reference module docstring).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


def rfft(x: jax.Array, n: int | None = None) -> jax.Array:
    return jnp.fft.rfft(x, n=n, axis=-1)


def irfft(x: jax.Array, n: int) -> jax.Array:
    """C2R that reads only the real part of the DC and Nyquist bins.

    NumPy/SciPy (the oracle) and the matmul basis ignore those imaginary
    parts; cuFFT's C2R assumes they are zero and answers otherwise when they
    are not.  The distance factor's phase ramp makes the Nyquist bin complex
    (measured 5.4e-3 off the oracle on an H100), so they are zeroed here.
    """
    k = jnp.arange(x.shape[-1])
    edge = (k == 0) | ((k == n // 2) if n % 2 == 0 else False)
    x = jax.lax.complex(jnp.real(x), jnp.where(edge, 0.0, jnp.imag(x)))
    return jnp.fft.irfft(x, n=n, axis=-1)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n: int):
    """Forward real-DFT basis (n, bins) as float32 cos/sin matrices.

    Cached as NumPy (not jax.Array): the first call may happen inside a jit
    trace, and caching a traced constant would leak the tracer.
    """
    bins = n // 2 + 1
    k = np.arange(bins)[None, :]
    t = np.arange(n)[:, None]
    ang = 2.0 * np.pi * t * k / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_matrices(n: int):
    """Inverse basis (bins, n): y = a @ Cr + b @ Ci with the 1/N and the
    2x weight on interior bins folded in (a=Re, b=Im of the half-spectrum)."""
    bins = n // 2 + 1
    k = np.arange(bins)[:, None]
    t = np.arange(n)[None, :]
    ang = 2.0 * np.pi * k * t / n
    w = np.full((bins, 1), 2.0)
    w[0, 0] = 1.0
    if n % 2 == 0:
        w[-1, 0] = 1.0
    cr = (w * np.cos(ang) / n).astype(np.float32)
    ci = (-w * np.sin(ang) / n).astype(np.float32)
    return cr, ci


def rfft_matmul(x: jax.Array, n: int) -> jax.Array:
    """(…, n) real -> (…, n//2+1) complex64 via two matmuls."""
    cr, ci = _dft_matrices(n)
    re = jnp.matmul(x, cr, precision=jax.lax.Precision.HIGHEST)
    im = jnp.matmul(x, ci, precision=jax.lax.Precision.HIGHEST)
    return jax.lax.complex(re, im)


def irfft_matmul(spec: jax.Array, n: int) -> jax.Array:
    """(…, n//2+1) complex -> (…, n) real via two matmuls (includes 1/N)."""
    cr, ci = _idft_matrices(n)
    y = jnp.matmul(jnp.real(spec), cr, precision=jax.lax.Precision.HIGHEST)
    y = y + jnp.matmul(jnp.imag(spec), ci, precision=jax.lax.Precision.HIGHEST)
    return y


def get_backend(name: str):
    """'fft' -> XLA FFT HLO; 'matmul' -> DFT matmuls."""
    if name == "fft":
        return rfft, irfft
    if name == "matmul":
        return rfft_matmul, irfft_matmul
    raise ValueError(f"unknown fft backend {name!r}")


# --- split (real/imag plane) transforms -----------------------------------
# The matmul-backend engine path works on explicit real/imaginary float32
# planes: the R2C DFT is two matmuls, and the C2R inverse only materializes the final
# ``tail`` output samples (the engine discards everything before the last
# frames_per_buffer samples of every block, so the inverse basis is truncated
# to its last ``tail`` columns — an 8x FLOP cut at the default 1024/128).

def rfft_split(x: jax.Array, n: int) -> tuple[jax.Array, jax.Array]:
    """(…, n) real -> ((…, bins) re, (…, bins) im) float32 planes."""
    cr, ci = _dft_matrices(n)
    p = jax.lax.Precision.HIGHEST
    return jnp.matmul(x, cr, precision=p), jnp.matmul(x, ci, precision=p)


@functools.lru_cache(maxsize=8)
def _subblock_dft_matrices(n: int, sub: int):
    """DFT basis of a length-``sub`` block zero-padded to n: (sub, bins)
    planes — exactly the first ``sub`` rows of the full basis, SLICED from
    it so the sliding forward and the direct rfft_split stay numerically
    in lockstep by construction (the tail-association invariant depends on
    these two paths agreeing)."""
    return tuple(np.ascontiguousarray(m[:sub]) for m in _dft_matrices(n))


@functools.lru_cache(maxsize=8)
def _sliding_twiddles(n: int, sub: int):
    """Twiddles e^{-2πi k (sub*m)/n} for m = 0..n/sub-1: (q, bins) planes."""
    q = n // sub
    bins = n // 2 + 1
    k = np.arange(bins)[None, :]
    m = np.arange(q)[:, None]
    ang = 2.0 * np.pi * k * m / q
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def rfft_sliding_split(stream: jax.Array, num_blocks: int, sub: int, n: int):
    """Overlap-save windows' DFTs from the contiguous sample stream.

    stream: (num_blocks*sub + (n - sub),) — history followed by fed samples,
    with history length (n - sub) a multiple of sub (896 = 7x128 by default).

    Window b is stream[b*sub : b*sub + n]; its length-n DFT decomposes into
    the q = n/sub zero-padded sub-block DFTs P[b..b+q-1] combined with
    q-th-root twiddles:  X[b] = sum_m e^{-2πik m/q} P[b+m].

    vs materializing (B, n) windows + a (n, bins) matmul this is a qx FLOP
    and memory-traffic reduction (the windows overlap q-fold); the sub-block
    DFTs are also shallower dots (sub instead of n), so it is *more*
    accurate, not less.
    """
    q = n // sub
    assert stream.shape[-1] == num_blocks * sub + (n - sub)
    subs = stream.reshape(num_blocks + q - 1, sub)
    cr, ci = _subblock_dft_matrices(n, sub)
    p = jax.lax.Precision.HIGHEST
    pr = jnp.matmul(subs, cr, precision=p)  # (B+q-1, bins)
    pi = jnp.matmul(subs, ci, precision=p)
    twr, twi = _sliding_twiddles(n, sub)
    xr = pr[0:num_blocks]  # m = 0: twiddle is 1
    xi = pi[0:num_blocks]
    for m in range(1, q):
        a, b = twr[m][None, :], twi[m][None, :]
        prm = pr[m : m + num_blocks]
        pim = pi[m : m + num_blocks]
        xr = xr + (a * prm - b * pim)
        xi = xi + (a * pim + b * prm)
    return xr, xi


def rfft_sliding_split_batched(streams: jax.Array, num_blocks: int, sub: int, n: int):
    """Batched rfft_sliding_split: streams (S, num_blocks*sub + n - sub) ->
    ((S, num_blocks, bins) re, im).  The sub-block DFT matmul is flattened
    over sources into one tall matrix instead of S short ones."""
    q = n // sub
    s = streams.shape[0]
    rows = num_blocks + q - 1
    subs = streams.reshape(s * rows, sub)
    cr, ci = _subblock_dft_matrices(n, sub)
    p = jax.lax.Precision.HIGHEST
    bins = n // 2 + 1
    pr = jnp.matmul(subs, cr, precision=p).reshape(s, rows, bins)
    pi = jnp.matmul(subs, ci, precision=p).reshape(s, rows, bins)
    twr, twi = _sliding_twiddles(n, sub)
    xr = pr[:, 0:num_blocks]
    xi = pi[:, 0:num_blocks]
    for m in range(1, q):
        a, b = twr[m][None, None, :], twi[m][None, None, :]
        prm = pr[:, m : m + num_blocks]
        pim = pi[:, m : m + num_blocks]
        xr = xr + (a * prm - b * pim)
        xi = xi + (a * pim + b * prm)
    return xr, xi


@functools.lru_cache(maxsize=16)
def _idft_tail_matrices(n: int, tail: int):
    cr, ci = _idft_matrices(n)
    return np.ascontiguousarray(cr[:, n - tail :]), np.ascontiguousarray(ci[:, n - tail :])


def irfft_tail_split(re: jax.Array, im: jax.Array, n: int, tail: int) -> jax.Array:
    """Inverse of rfft_split, returning only the last ``tail`` samples."""
    cr, ci = _idft_tail_matrices(n, tail)
    p = jax.lax.Precision.HIGHEST
    return jnp.matmul(re, cr, precision=p) + jnp.matmul(im, ci, precision=p)
