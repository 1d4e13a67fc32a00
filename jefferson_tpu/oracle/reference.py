"""NumPy float32 oracle: exact port of the reference's CPU/FFTW DSP path.

This is the parity anchor of the framework, in the same role the FFTW
implementation plays for the CUDA engine in the reference (reference:
Jefferson/src/CPUSoundSource.cpp, Jefferson/src/functions.cpp): every accelerator
kernel is validated stage-by-stage and end-to-end against this module.

FFT convention note: FFTW R2C/C2R are unnormalized and the reference scales
the *forward* spectrum by 1/PAD_LEN (reference: Jefferson/src/CPUSoundSource.cpp:119,280).
scipy.fft.rfft is unnormalized like FFTW's R2C, and scipy.fft.irfft includes
a 1/N that FFTW's C2R does not, so the oracle multiplies the inverse by
PAD_LEN.  Net effect, identical to the reference:
``out = irfft_normalized(rfft(x) * H * D)``.

Known reference defects intentionally NOT replicated (SURVEY.md section 7):
  * cpuTDConvolve reads its input 2 floats past the block start because it
    offsets by PAD_LEN+2 instead of PAD_LEN (reference:
    Jefferson/src/CPUSoundSource.cpp:71); we convolve the actual block.
"""

from __future__ import annotations

import numpy as np
import scipy.fft

from ..config import DEFAULT_CONFIG, EngineConfig, ProcessType
from ..hrtf.kemar import HRTFDatabase, pick_hrtf
from ..trajectory.interpolation import interpolation_calculations
from ..trajectory.spatial import radius_from_cartesian, spherical_to_cartesian

_F32 = np.float32
_C64 = np.complex64


def distance_factor(coordinates: np.ndarray, config: EngineConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Frequency-domain distance cue R[k] for one position -> (num_bins,) complex64.

    R[k] = e^{-j 2π (fs/vs) r k / N} / (1 + (fs/vs) r²) with r = |coords|/5 and
    N = num_bins (note: NOT pad_len — the reference uses the half-spectrum
    size in the phase ramp, reference: Jefferson/src/CPUSoundSource.cpp:43-48).
    """
    r = _F32(radius_from_cartesian(coordinates))
    r = _F32(r / _F32(config.distance_scale))
    fsvs = _F32(config.fsvs)
    frac = _F32(1.0 + float(fsvs) * float(r) ** 2)
    n = config.num_bins
    k = np.arange(n, dtype=np.float64)
    arg = 2.0 * np.pi * float(fsvs) * float(r) * k / n
    return ((np.cos(arg) - 1j * np.sin(arg)) / float(frac)).astype(_C64)


def _complex_scale(a: np.ndarray, s: float) -> np.ndarray:
    """complexScaling (reference: Jefferson/src/functions.cpp:34-40), float32."""
    return (a * _F32(s)).astype(_C64)


def case_one_convolve(spec2: np.ndarray, db: HRTFDatabase, indices: np.ndarray, df: np.ndarray):
    """out = spec * H[idx0], each channel * distance factor.
    (reference: Jefferson/src/CPUSoundSource.cpp:143-159)"""
    out = (spec2 * db.spectra[indices[0]]).astype(_C64)
    return (out * df[None, :]).astype(_C64)


def case_two_convolve(spec2, db, indices, omegas, df):
    """Azimuth-only interpolation (reference: Jefferson/src/CPUSoundSource.cpp:161-188)."""
    cb0 = (spec2 * db.spectra[indices[0]]).astype(_C64)
    cb1 = (spec2 * db.spectra[indices[1]]).astype(_C64)
    cb0 = _complex_scale(cb0, omegas[1])
    cb1 = _complex_scale(cb1, omegas[0])
    cb0 = (cb0 * df[None, :]).astype(_C64)
    cb1 = (cb1 * df[None, :]).astype(_C64)
    return (cb0 + cb1).astype(_C64)


def case_three_convolve(spec2, db, indices, omegas, df):
    """Elevation-only interpolation (reference: Jefferson/src/CPUSoundSource.cpp:189-216)."""
    cb0 = (spec2 * db.spectra[indices[0]]).astype(_C64)
    cb1 = (spec2 * db.spectra[indices[2]]).astype(_C64)
    cb0 = _complex_scale(cb0, omegas[5])
    cb1 = _complex_scale(cb1, omegas[4])
    cb0 = (cb0 * df[None, :]).astype(_C64)
    cb1 = (cb1 * df[None, :]).astype(_C64)
    return (cb0 + cb1).astype(_C64)


def case_four_convolve(spec2, db, indices, omegas, df):
    """Full bilinear 4-filter blend (reference: Jefferson/src/CPUSoundSource.cpp:217-254)."""
    cbs = []
    for i in range(4):
        cb = (spec2 * db.spectra[indices[i]]).astype(_C64)
        cb = (cb * df[None, :]).astype(_C64)
        cbs.append(cb)
    w = [
        _F32(omegas[5]) * _F32(omegas[1]),
        _F32(omegas[5]) * _F32(omegas[0]),
        _F32(omegas[4]) * _F32(omegas[3]),
        _F32(omegas[4]) * _F32(omegas[2]),
    ]
    cbs = [_complex_scale(cb, wi) for cb, wi in zip(cbs, w)]
    out = (cbs[0] + cbs[1]).astype(_C64)
    out = (out + cbs[2]).astype(_C64)
    out = (out + cbs[3]).astype(_C64)
    return out


def interpolate_loops(spec2, db, indices, omegas, df):
    """Case dispatch (reference: Jefferson/src/CPUSoundSource.cpp:255-273)."""
    i0, i1, i2, i3 = indices
    if i0 == i1 and i1 == i2 and i2 == i3:
        return case_one_convolve(spec2, db, indices, df)
    if i0 == i2:
        return case_two_convolve(spec2, db, indices, omegas, df)
    if i0 == i1 and i0 != i2:
        return case_three_convolve(spec2, db, indices, omegas, df)
    return case_four_convolve(spec2, db, indices, omegas, df)


class OracleSpatializer:
    """Stateful block processor mirroring CPUSoundSource.

    Holds the overlap-save buffer ``x`` (pad_len floats, new block written to
    the tail), the playhead ``count`` and crossfade state old_azi/old_ele
    (reference: Jefferson/src/SoundSource.cu:3-16, Jefferson/src/Audio.cu:119-157).
    """

    def __init__(self, db: HRTFDatabase, config: EngineConfig = DEFAULT_CONFIG):
        self.db = db
        self.config = config
        self.x = np.zeros(config.pad_len, dtype=_F32)
        self.azi = _F32(0.0)
        self.ele = _F32(0.0)
        self.r = _F32(0.5)
        self.coordinates = np.array([0.0, 0.0, 0.5], dtype=_F32)
        self.old_azi = self.azi
        self.old_ele = self.ele
        self.count = 0
        self.buf: np.ndarray | None = None
        self.td_gain = 1.0  # CPU TD semantics (see td_convolve docstring)

    # --- position updates (reference: Jefferson/src/SoundSource.cu:20-54) ---
    def update_from_spherical(self, ele=None, azi=None, r=None):
        from ..hrtf.kemar import round_half_away

        if ele is not None:
            self.ele = _F32(round_half_away(_F32(ele)))
        if azi is not None:
            self.azi = _F32(round_half_away(_F32(azi)))
        if r is not None:
            self.r = _F32(r)
        self.coordinates = spherical_to_cartesian(self.azi, self.ele, self.r)

    def update_from_cartesian(self, xyz):
        from ..trajectory.spatial import cartesian_to_spherical

        self.coordinates = np.asarray(xyz, dtype=_F32)
        azi, ele, r = cartesian_to_spherical(self.coordinates)
        self.azi, self.ele, self.r = _F32(azi), _F32(ele), _F32(r)

    # --- block feed (reference: Jefferson/src/Audio.cu:119-143) ---
    def feed_block(self, block: np.ndarray) -> None:
        fpb = self.config.frames_per_buffer
        assert block.shape == (fpb,)
        self.x[self.config.history_len :] = block.astype(_F32)

    def feed_from_buf(self) -> None:
        """Pull the next block from the wrapping playback buffer ``self.buf``.

        Buffers shorter than one block tile modularly (the reference's
        ``% length`` playhead, Audio.cu:121-139, generalized like
        engine/stream.StreamingSpatializer.next_block and fed_stream — the
        single-wrap concatenate under-filled the block for len(buf) < fpb)."""
        fpb = self.config.frames_per_buffer
        length = len(self.buf)
        if self.count + fpb < length:
            blk = self.buf[self.count : self.count + fpb]
            self.count += fpb
        else:
            blk = self.buf[(self.count + np.arange(fpb)) % length]
            self.count = (self.count + fpb) % length
        self.feed_block(blk)

    def overlap_save(self) -> None:
        fpb = self.config.frames_per_buffer
        self.x[: self.config.history_len] = self.x[fpb:]

    # --- DSP paths ---
    def _forward_spectrum(self) -> np.ndarray:
        """rfft(x) * (1/pad_len), duplicated for both channels -> (2, bins) c64."""
        spec = scipy.fft.rfft(self.x).astype(_C64)
        spec = _complex_scale(spec, 1.0 / self.config.pad_len)
        return np.stack([spec, spec])

    def _inverse(self, spec2: np.ndarray) -> np.ndarray:
        """Unnormalized C2R of both channels -> (pad_len, 2) float32 interleaved."""
        y = scipy.fft.irfft(spec2, axis=-1).astype(_F32) * _F32(self.config.pad_len)
        return y.T.copy()

    def fd_interpolate(self) -> np.ndarray:
        """Full interpolating path with crossfade -> (frames, 2) float32.
        (reference: Jefferson/src/CPUSoundSource.cpp:274-339)"""
        cfg = self.config
        spec2 = self._forward_spectrum()
        coeffs = interpolation_calculations(self.ele, self.azi)
        idx, omg = coeffs.indices[0], coeffs.omegas[0]
        xfade = (self.old_azi != self.azi) or (self.old_ele != self.ele)
        df = distance_factor(self.coordinates, cfg)
        if not xfade:
            out = interpolate_loops(spec2, self.db, idx, omg, df)
            y = self._inverse(out)[cfg.history_len :]
        else:
            oc = interpolation_calculations(self.old_ele, self.old_azi)
            oidx, oomg = oc.indices[0], oc.omegas[0]
            out_old = interpolate_loops(spec2, self.db, oidx, oomg, df)
            out_new = interpolate_loops(spec2.copy(), self.db, idx, omg, df)
            y_old = self._inverse(out_old)[cfg.history_len :]
            y_new = self._inverse(out_new)[cfg.history_len :]
            fn = (np.arange(cfg.frames_per_buffer, dtype=_F32) / _F32(cfg.frames_per_buffer - 1.0))[
                :, None
            ]
            y = (y_old * (_F32(1.0) - fn) + y_new * fn).astype(_F32)
        self.old_azi = self.azi
        self.old_ele = self.ele
        return y

    def fd_basic(self) -> np.ndarray:
        """Nearest-HRTF FD convolution, no distance/crossfade -> (frames, 2).
        (reference: Jefferson/src/CPUSoundSource.cpp:113-142)"""
        hrtf_idx = pick_hrtf(self.ele, self.azi)
        spec2 = self._forward_spectrum()
        out = (spec2 * self.db.spectra[hrtf_idx]).astype(_C64)
        return self._inverse(out)[self.config.history_len :]

    def td_convolve(self) -> np.ndarray:
        """Naive time-domain convolution of the current block -> (frames, 2).

        Implements the reference's *intended* behavior: each output frame n
        convolves input[n-k] over the hrtf_len taps using the overlap-save
        history (the reference's +2 pointer offset bug is fixed, see module
        docstring).  (reference: Jefferson/src/CPUSoundSource.cpp:66-112)

        ``self.td_gain`` scales the output (clamped <= 1): 1.0 (the default)
        is the reference's CPU TD semantics (gain hardcoded to 1,
        CPUSoundSource.cpp:74); set it to config.source_gain to mirror the
        GPU TD path instead (`value * gain`, kernels.cu:146) — the
        reference's own CPU/GPU TD outputs differ by this factor (PARITY.md
        defect list).
        """
        cfg = self.config
        hrtf_idx = pick_hrtf(self.ele, self.azi)
        h = self.db.hrirs[hrtf_idx, :, : cfg.hrtf_len]  # (2, taps)
        fpb = cfg.frames_per_buffer
        out = np.zeros((fpb, 2), dtype=_F32)
        xbuf = self.x
        start = cfg.history_len
        gain = _F32(min(self.td_gain, 1.0))
        for ch in range(2):
            acc = np.zeros(fpb, dtype=_F32)
            for k in range(cfg.hrtf_len):
                lo = start - k
                acc += xbuf[lo : lo + fpb] * h[ch, k]
            out[:, ch] = acc if gain == _F32(1.0) else acc * gain
        return out

    def process(self, ptype: ProcessType = ProcessType.CPU_FD_COMPLEX) -> np.ndarray:
        self.hrtf_idx = pick_hrtf(self.ele, self.azi)
        if ptype in (ProcessType.CPU_FD_COMPLEX, ProcessType.TPU_FD_COMPLEX):
            return self.fd_interpolate()
        if ptype in (ProcessType.CPU_FD_BASIC, ProcessType.TPU_FD_BASIC):
            return self.fd_basic()
        return self.td_convolve()


def render_oracle(
    signal: np.ndarray,
    db: HRTFDatabase,
    positions,
    config: EngineConfig = DEFAULT_CONFIG,
    ptype: ProcessType = ProcessType.CPU_FD_COMPLEX,
    initial_old: tuple[float, float] | None = (0.0, 0.0),
    td_gain: float = 1.0,
) -> np.ndarray:
    """File-to-file oracle render: block loop like the reference audio callback.

    ``positions``: iterable of per-block (azi_deg, ele_deg, r) applied via
    update_from_spherical before each block; its length sets the number of
    blocks; the input wraps when exhausted (reference: Jefferson/src/Audio.cu:119-157).
    ``initial_old``: the crossfade state before block 0 — (0, 0) mirrors the
    reference's SoundSource constructor; None disables the initial crossfade
    by pre-seeding the first position.
    ``td_gain``: TD-path output gain (clamped <= 1); 1.0 = the reference's
    CPU TD semantics, config.source_gain = its GPU TD semantics (which the
    accelerator engine implements) — see OracleSpatializer.td_convolve.
    """
    positions = list(positions)
    sp = OracleSpatializer(db, config)
    sp.td_gain = td_gain
    sp.buf = np.asarray(signal, dtype=_F32)
    if initial_old is None and positions:
        a0, e0, _ = positions[0]
        from ..hrtf.kemar import round_half_away

        sp.old_azi = _F32(round_half_away(_F32(a0)))
        sp.old_ele = _F32(round_half_away(_F32(e0)))
    else:
        sp.old_azi, sp.old_ele = _F32(initial_old[0]), _F32(initial_old[1])
    out = np.zeros((len(positions) * config.frames_per_buffer, 2), dtype=_F32)
    fpb = config.frames_per_buffer
    for b, (azi, ele, r) in enumerate(positions):
        sp.update_from_spherical(ele=ele, azi=azi, r=r)
        sp.feed_from_buf()
        out[b * fpb : (b + 1) * fpb] = sp.process(ptype)
        sp.overlap_save()
    return out


def render_oracle_many(
    jobs,
    db: HRTFDatabase,
    config: EngineConfig = DEFAULT_CONFIG,
    initial_old: tuple[float, float] | None = (0.0, 0.0),
    workers: int = 1,
) -> list[np.ndarray]:
    """``render_oracle`` of each ``(signal, positions)`` job, in order.

    The oracle is a per-block Python loop (~0.5 ms a block), so a 16-source
    full-length scene gate takes minutes on one core.  ``workers`` > 1
    renders the jobs in that many spawned processes, which hold JAX to the
    CPU: they never open an accelerator the calling process holds.
    """
    jobs = [(np.asarray(s, dtype=_F32), [tuple(p) for p in pos]) for s, pos in jobs]
    workers = min(workers, len(jobs))
    if workers <= 1:
        return [render_oracle(s, db, p, config, initial_old=initial_old) for s, p in jobs]
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"  # inherited by the spawned workers
    try:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = [ex.submit(render_oracle, s, db, p, config, initial_old=initial_old)
                       for s, p in jobs]
            return [f.result() for f in futures]
    finally:
        if saved is None:
            os.environ.pop("JAX_PLATFORMS", None)
        else:
            os.environ["JAX_PLATFORMS"] = saved
