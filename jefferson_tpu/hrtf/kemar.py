"""MIT KEMAR HRTF database: grid tables, nearest-filter picking, loaders.

Rebuild of the reference's HRTF database layer (reference:
Jefferson/src/hrtf_signals.cu).  The nonuniform KEMAR grid — 14 elevations
-40..90 deg step 10, per-elevation azimuth increments — and the
nearest-neighbor ``pick_hrtf`` scan are reproduced exactly, including the
reference's float accumulation when enumerating azimuths
(reference: Jefferson/src/hrtf_signals.cu:7-11,20-51,119-140).

Loaders:
  * ``load_full``    — per-ear mono files ``elev{E}/{L,R}{E}e{AAA}a.wav``
                       (the layout the reference code reads).
  * ``load_compact`` — the shipped stereo compact set ``elev{E}/H{E}e{AAA}a.wav``
                       covering the right hemisphere 0..180 deg; the left
                       hemisphere is synthesized by the L/R-swap mirror the
                       reference documents (reference:
                       Jefferson/src/hrtf_signals.h:7-15 legacy loader notes).
  * ``synthetic_database`` — deterministic fixture filters for tests/benches.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import scipy.fft

from ..config import DEFAULT_CONFIG, EngineConfig
from ..io.wavio import read_wav

NUM_ELEV = 14
ELEVATIONS = np.array(
    [-40, -30, -20, -10, 0, 10, 20, 30, 40, 50, 60, 70, 80, 90], dtype=np.int32
)
# Per-elevation azimuth increments (reference: Jefferson/src/hrtf_signals.cu:9-10).
AZIMUTH_INC = np.array(
    [6.43, 6.00, 5.00, 5.00, 5.00, 5.00, 5.00, 6.00, 6.43, 8.00, 10.00, 15.00, 30.00, 361.0],
    dtype=np.float32,
)


def _enumerate_azimuths(elev_idx: int) -> np.ndarray:
    """Azimuth grid values for one elevation row.

    Reproduces the reference's float32 accumulation loop
    ``for (azi = 0; azi < 360; azi += azimuth_inc[i])``
    (reference: Jefferson/src/hrtf_signals.cu:121).
    """
    inc = np.float32(AZIMUTH_INC[elev_idx])
    vals = []
    azi = np.float32(0.0)
    while azi < np.float32(360.0):
        vals.append(azi)
        azi = np.float32(azi + inc)
    return np.array(vals, dtype=np.float32)


AZIMUTH_GRIDS = [_enumerate_azimuths(i) for i in range(NUM_ELEV)]
AZIMUTH_COUNTS = np.array([len(g) for g in AZIMUTH_GRIDS], dtype=np.int32)
# Prefix sums = hrtf index offset of each elevation row
# (reference: Jefferson/src/hrtf_signals.cu:139 ``azimuth_offset``).
AZIMUTH_OFFSET = np.concatenate([[0], np.cumsum(AZIMUTH_COUNTS)]).astype(np.int32)
NUM_HRTF = int(AZIMUTH_OFFSET[-1])

assert NUM_HRTF == 710, f"KEMAR grid enumeration produced {NUM_HRTF} != 710"
assert list(AZIMUTH_COUNTS) == [56, 60, 72, 72, 72, 72, 72, 60, 56, 45, 36, 24, 12, 1]


def round_half_away(x):
    """C round() semantics: halves round away from zero (NumPy rounds to
    even).  Computed EXACTLY via floor + an exact fractional compare — the
    folk floor(|x|+0.5) trick misrounds float32 inputs within an ulp below
    a .5 boundary (|x|+0.5 itself rounds UP to the tie: e.g. f32
    0.49999997 -> 1.0 instead of the reference round()'s 0.0).  The native
    port uses std::round, which is this function by definition."""
    x = np.asarray(x)
    a = np.abs(x)
    fl = np.floor(a)
    # a - fl is exact in floating point; 0.5 is representable, so the
    # comparison is the true (error-free) half-away tie test
    return np.sign(x) * np.where(a - fl >= 0.5, fl + 1, fl)


def pick_hrtf(obj_ele, obj_azi) -> np.ndarray:
    """Nearest-grid-filter index for (elevation, azimuth) in degrees.

    Vectorized exact port of the reference's two linear scans
    (reference: Jefferson/src/hrtf_signals.cu:20-51): elevation is snapped to
    the nearest multiple of 10 first, then the closest row entry wins; the
    azimuth scan compares against ``i * azimuth_inc[row]`` with
    first-minimum-wins tie-breaking (argmin).  Accepts scalars or arrays.
    """
    ele = np.asarray(obj_ele, dtype=np.float32)
    azi = np.asarray(obj_azi, dtype=np.float32)
    scalar = ele.ndim == 0 and azi.ndim == 0
    ele, azi = np.broadcast_arrays(np.atleast_1d(ele), np.atleast_1d(azi))

    from ..native import HAVE_NATIVE

    if HAVE_NATIVE:  # bit-exact C++ scan, ~10x faster (tests/test_native.py)
        from ..native import pick_hrtf as native_pick

        # .ravel() copies the broadcast views contiguously; the wrapper
        # handles dtype/contiguity
        idx = native_pick(ele.ravel(), azi.ravel()).reshape(ele.shape)
        return idx[0] if scalar else idx

    ele_snap = round_half_away(ele / 10).astype(np.float32) * np.float32(10.0)
    # first-minimum scan over the 14 elevation rows
    d_ele = np.abs(ele_snap[..., None] - ELEVATIONS.astype(np.float32))
    ele_idx = np.argmin(d_ele, axis=-1)

    azi_r = round_half_away(azi).astype(np.float32)
    inc = AZIMUTH_INC[ele_idx]
    n = AZIMUTH_COUNTS[ele_idx]
    max_n = int(AZIMUTH_COUNTS.max())
    i_grid = np.arange(max_n, dtype=np.float32)
    # distance to i*inc for every candidate i; out-of-row candidates -> +inf
    d = np.abs(azi_r[..., None] - i_grid * inc[..., None]).astype(np.float32)
    d = np.where(i_grid < n[..., None], d, np.float32(np.inf))
    best_i = np.argmin(d, axis=-1)
    idx = (AZIMUTH_OFFSET[ele_idx] + best_i).astype(np.int32)
    return idx[0] if scalar else idx


def grid_position(idx: int) -> tuple[int, float]:
    """Inverse lookup: filter index -> (elevation_deg, azimuth_deg)."""
    row = int(np.searchsorted(AZIMUTH_OFFSET, idx, side="right") - 1)
    return int(ELEVATIONS[row]), float(AZIMUTH_GRIDS[row][idx - AZIMUTH_OFFSET[row]])


@dataclasses.dataclass
class HRTFDatabase:
    """All 710 HRIR pairs, zero-padded, plus their precomputed half-spectra.

    ``hrirs``   — (num_hrtf, 2, pad_len) float32, taps then zeros (the
                  reference stores L then R contiguously at stride pad_len,
                  reference: Jefferson/src/hrtf_signals.cu:90,127-135).
    ``spectra`` — (num_hrtf, 2, num_bins) complex64, *unnormalized* R2C FFT of
                  ``hrirs`` — the same batched-FFTW convention the reference
                  uploads to the GPU unchanged (reference:
                  Jefferson/src/hrtf_signals.cu:113-118, :248), so the oracle
                  and the accelerator engine share bit-identical filter spectra.
    """

    hrirs: np.ndarray
    spectra: np.ndarray
    config: EngineConfig = DEFAULT_CONFIG
    source: str = "unknown"

    @property
    def num_hrtf(self) -> int:
        return self.hrirs.shape[0]

    @classmethod
    def from_hrirs(
        cls, taps: np.ndarray, config: EngineConfig = DEFAULT_CONFIG, source: str = "unknown"
    ) -> "HRTFDatabase":
        """Build from raw taps (num_hrtf, 2, n_taps<=pad_len)."""
        n, ch, t = taps.shape
        if ch != 2 or t > config.pad_len:
            raise ValueError(f"bad HRIR shape {taps.shape} for pad_len={config.pad_len}")
        hrirs = np.zeros((n, 2, config.pad_len), dtype=np.float32)
        hrirs[:, :, :t] = taps.astype(np.float32)
        spectra = scipy.fft.rfft(hrirs, axis=-1).astype(np.complex64)
        return cls(hrirs=hrirs, spectra=spectra, config=config, source=source)


def _full_filename(root: Path, ele: int, azi_val: np.float32, ear: str) -> Path:
    # reference: Jefferson/src/hrtf_signals.cu:124,131 — "%s/elev%d/{L,R}%de%03da.wav"
    azi_name = int(round_half_away(float(azi_val)))
    return root / f"elev{ele}" / f"{ear}{ele}e{azi_name:03d}a.wav"


def load_full(root: str | Path, config: EngineConfig = DEFAULT_CONFIG) -> HRTFDatabase:
    """Load the full MIT KEMAR set: 710 x 2 per-ear mono WAVs."""
    root = Path(root)
    taps = None
    j = 0
    for i in range(NUM_ELEV):
        ele = int(ELEVATIONS[i])
        for azi in AZIMUTH_GRIDS[i]:
            for ch, ear in enumerate("LR"):
                x, sr = read_wav(_full_filename(root, ele, azi, ear))
                if sr != config.sample_rate or x.shape[1] != 1:
                    raise ValueError(f"bad HRIR file {_full_filename(root, ele, azi, ear)}")
                if taps is None:
                    taps = np.zeros((NUM_HRTF, 2, x.shape[0]), dtype=np.float32)
                if x.shape[0] != taps.shape[2]:
                    raise ValueError(
                        f"HRIR length mismatch: "
                        f"{_full_filename(root, ele, azi, ear)} has "
                        f"{x.shape[0]} taps, first file had {taps.shape[2]}"
                    )
                taps[j, ch, : x.shape[0]] = x[:, 0]
            j += 1
    return HRTFDatabase.from_hrirs(taps, config, source=f"full:{root}")


def load_compact(root: str | Path, config: EngineConfig = DEFAULT_CONFIG) -> HRTFDatabase:
    """Load the shipped compact KEMAR set (stereo right-hemisphere files).

    Grid azimuths > 180 deg use the mirrored file at (360 - azi) with L/R
    swapped, as documented in the reference's legacy compact loader
    (reference: Jefferson/src/hrtf_signals.h:7-15).
    """
    root = Path(root)
    taps = None
    j = 0
    for i in range(NUM_ELEV):
        ele = int(ELEVATIONS[i])
        for azi in AZIMUTH_GRIDS[i]:
            a = float(azi)
            swap = a > 180.0
            a_file = 360.0 - a if swap else a
            azi_name = int(round_half_away(a_file))
            path = root / f"elev{ele}" / f"H{ele}e{azi_name:03d}a.wav"
            x, sr = read_wav(path)
            if sr != config.sample_rate or x.shape[1] != 2:
                raise ValueError(f"bad compact HRIR file {path}")
            if taps is None:
                taps = np.zeros((NUM_HRTF, 2, x.shape[0]), dtype=np.float32)
            if x.shape[0] != taps.shape[2]:
                raise ValueError(
                    f"HRIR length mismatch: {path} has {x.shape[0]} taps, "
                    f"first file had {taps.shape[2]}"
                )
            if swap:
                taps[j, 0, : x.shape[0]] = x[:, 1]
                taps[j, 1, : x.shape[0]] = x[:, 0]
            else:
                taps[j, 0, : x.shape[0]] = x[:, 0]
                taps[j, 1, : x.shape[0]] = x[:, 1]
            j += 1
    return HRTFDatabase.from_hrirs(taps, config, source=f"compact:{root}")


def load_database(root: str | Path, config: EngineConfig = DEFAULT_CONFIG) -> HRTFDatabase:
    """Auto-detect the database format: a SOFA file, or a full/compact
    KEMAR WAV tree under ``root``.

    SOFA grid mapping defaults to "auto" (nearest for dense sets,
    delay-aligned 3-nearest interpolation for sparse ones — hrtf/sofa.py);
    override with $JEFFERSON_SOFA_MAPPING=nearest|interp3|auto."""
    import os

    root = Path(root)
    if root.is_file() and root.suffix.lower() == ".sofa":
        from .sofa import load_sofa

        mapping = os.environ.get("JEFFERSON_SOFA_MAPPING", "auto")
        return load_sofa(root, config, mapping=mapping)
    if (root / "elev0" / "L0e000a.wav").exists():
        return load_full(root, config)
    if (root / "elev0" / "H0e000a.wav").exists():
        return load_compact(root, config)
    raise FileNotFoundError(
        f"no HRTF database (SOFA file or full/compact KEMAR tree) found at {root}"
    )


def synthetic_database(
    config: EngineConfig = DEFAULT_CONFIG, n_taps: int | None = None, seed: int = 1234
) -> HRTFDatabase:
    """Deterministic synthetic HRIR set with KEMAR-like structure.

    Like real HRTFs, the filters vary *smoothly* with direction: a fixed set
    of decaying bursts is mixed with weights given by the source direction
    vector, each ear gets a fractional interaural delay and a level
    difference proportional to laterality, and normalization is global (not
    per filter) so level cues stay spatially continuous.  Spatial
    smoothness matters: interpolation, crossfade and localization tests all
    assume neighboring grid filters are correlated, as in the real data.
    """
    n_taps = config.hrtf_len if n_taps is None else n_taps
    if n_taps < 1:
        raise ValueError(f"n_taps must be >= 1, got {n_taps}")
    rng = np.random.default_rng(seed)
    t = np.arange(n_taps, dtype=np.float32)
    env = np.exp(-t / 40.0)
    bursts = rng.standard_normal((4, n_taps)).astype(np.float32) * env  # A + x,y,z parts
    tap_grid = np.arange(n_taps, dtype=np.float64)

    taps = np.zeros((NUM_HRTF, 2, n_taps), dtype=np.float32)
    for idx in range(NUM_HRTF):
        ele, azi = grid_position(idx)
        a, e = np.deg2rad(azi), np.deg2rad(ele)
        # direction vector in the reference's convention (+x right, +y up, -z ahead)
        dx, dy, dz = np.sin(a) * np.cos(e), np.sin(e), -np.cos(a) * np.cos(e)
        mix = bursts[0] + 0.5 * dx * bursts[1] + 0.5 * dy * bursts[2] + 0.5 * dz * bursts[3]
        # channel 0 = left ear: delayed and attenuated when the source is right
        for ch, sign in ((0, +1.0), (1, -1.0)):
            delay = 7.5 * (1.0 + sign * dx)      # fractional taps, smooth in angle
            level = 1.0 - sign * 0.45 * dx
            taps[idx, ch] = level * np.interp(
                tap_grid - delay, tap_grid, mix.astype(np.float64), left=0.0, right=0.0
            ).astype(np.float32)
    taps *= 0.25 / max(np.max(np.abs(taps)), 1e-9)
    return HRTFDatabase.from_hrirs(taps, config, source=f"synthetic:{seed}")
