"""Host-side render plan: per-block positions -> gather indices and weights.

The reference computes interpolation state lazily inside each audio callback
(reference: Jefferson/src/GPUSoundSource.cu:325-343).  Offline, every block's
position is known up front, so the whole integer-heavy position pipeline
(degree rounding, pick_hrtf scans, case dispatch, crossfade detection) runs
vectorized in NumPy once, leaving the device step a pure gather/FFT/blend.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from ..hrtf.kemar import pick_hrtf, round_half_away
from ..ops.filters import distance_phase_split
from ..trajectory.interpolation import interpolation_calculations
from ..trajectory.spatial import radius_from_cartesian, spherical_to_cartesian

_F32 = np.float32


@dataclasses.dataclass
class RenderPlan:
    """Everything the device step needs, for B blocks."""

    num_blocks: int
    azi: np.ndarray          # (B,) float32, rounded degrees
    ele: np.ndarray          # (B,) float32, rounded degrees
    radii: np.ndarray        # (B,) float32, |coords| (unscaled)
    idx_new: np.ndarray      # (B, 4) int32
    w_new: np.ndarray        # (B, 4) float32
    idx_old: np.ndarray      # (B, 4) int32
    w_old: np.ndarray        # (B, 4) float32
    xfade: np.ndarray        # (B,) bool
    nearest: np.ndarray      # (B,) int32 — pick_hrtf per block (basic/TD paths)
    u_hi: np.ndarray         # (B,) float32 — distance phase split
    u_lo: np.ndarray         # (B,) float32
    inv_frac: np.ndarray     # (B,) float32


def make_plan(
    positions: np.ndarray,
    config: EngineConfig = DEFAULT_CONFIG,
    initial_old: tuple[float, float] | None = (0.0, 0.0),
) -> RenderPlan:
    """Build a plan from per-block spherical positions.

    positions: (B, 3) array-like of (azi_deg, ele_deg, r) — pre-rounding, the
    plan applies the reference's updateFromSpherical semantics
    (reference: Jefferson/src/SoundSource.cu:41-54).
    initial_old: crossfade state before block 0; (0, 0) mirrors the reference
    constructor (reference: Jefferson/src/SoundSource.cu:11-15); None seeds it
    with block 0's position so a static render never crossfades.
    """
    pos = np.asarray(positions, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions must be (B, 3) of (azi, ele, r), got {pos.shape}")
    b = pos.shape[0]
    if b == 0:
        # a 0-block plan used to come back MALFORMED (idx_old had one row
        # from the initial-old seed while every other field had zero)
        raise ValueError("positions must contain at least one block")
    azi = round_half_away(pos[:, 0].astype(_F32)).astype(_F32)
    ele = round_half_away(pos[:, 1].astype(_F32)).astype(_F32)
    r_in = pos[:, 2].astype(_F32)
    coords = spherical_to_cartesian(azi, ele, r_in)
    radii = radius_from_cartesian(coords)

    if initial_old is None:
        old0_azi, old0_ele = azi[0], ele[0]
    else:
        old0_azi = _F32(round_half_away(_F32(initial_old[0])))
        old0_ele = _F32(round_half_away(_F32(initial_old[1])))
    old_azi = np.concatenate([[old0_azi], azi[:-1]]).astype(_F32)
    old_ele = np.concatenate([[old0_ele], ele[:-1]]).astype(_F32)
    xfade = (old_azi != azi) | (old_ele != ele)

    cn = interpolation_calculations(ele, azi)
    # old rows = [initial_old] + new rows shifted by one: computed AS that
    # shift (one fresh row + reuse), so the chunk kernels' invariant
    # 'old-position arrays equal the previous block's new arrays'
    # (CLAUDE.md) holds by construction — and the dominant host planning
    # cost halves for long renders
    c0 = interpolation_calculations(
        np.asarray([old0_ele], _F32), np.asarray([old0_azi], _F32)
    )
    idx_old = np.concatenate([c0.indices, cn.indices[:-1]]).astype(np.int32)
    w_old = np.concatenate([c0.weights, cn.weights[:-1]]).astype(_F32)
    nearest = pick_hrtf(ele, azi).astype(np.int32)

    scaled_r = (radii / _F32(config.distance_scale)).astype(_F32)
    u_hi, u_lo, inv_frac = distance_phase_split(config.fsvs, scaled_r, config.num_bins)

    return RenderPlan(
        num_blocks=b,
        azi=azi,
        ele=ele,
        radii=radii,
        idx_new=cn.indices.astype(np.int32),
        w_new=cn.weights,
        idx_old=idx_old,
        w_old=w_old,
        xfade=xfade,
        nearest=nearest,
        u_hi=u_hi,
        u_lo=u_lo,
        inv_frac=inv_frac,
    )


def pad_plan(p: RenderPlan, pad_b: int) -> RenderPlan:
    """Extend a plan by ``pad_b`` blocks repeating the final position with
    xfade=False.  The padded region's old rows are the last real block's
    NEW row, so the chunk kernels' roll invariant (old[b+1] == new[b])
    holds across the pad boundary; callers trim the padded output."""
    if pad_b <= 0:
        return p
    rep = lambda a: np.concatenate([a, np.repeat(a[-1:], pad_b, axis=0)])
    return dataclasses.replace(
        p,
        num_blocks=p.num_blocks + pad_b,
        azi=rep(p.azi), ele=rep(p.ele), radii=rep(p.radii),
        idx_new=rep(p.idx_new), w_new=rep(p.w_new),
        idx_old=np.concatenate([p.idx_old, np.repeat(p.idx_new[-1:], pad_b, 0)]),
        w_old=np.concatenate([p.w_old, np.repeat(p.w_new[-1:], pad_b, 0)]),
        xfade=np.concatenate([p.xfade, np.zeros(pad_b, bool)]),
        nearest=rep(p.nearest),
        u_hi=rep(p.u_hi), u_lo=rep(p.u_lo), inv_frac=rep(p.inv_frac),
    )


def dedup_rows(idx: np.ndarray, w: np.ndarray):
    """Unique (indices, weights) rows -> (uniq_idx, uniq_w, inverse).

    Real workloads hold a position for many consecutive blocks (the
    reference's own benchmark holds each position for 172 blocks,
    reference: Jefferson/src/precision_test.cu:2093-2148), so most blend
    rows are duplicates.  Keys are the raw bit patterns (int32 indices +
    float32 weight bits), so deduplication is exact: blending a unique row
    once and broadcasting is bit-identical to blending every copy.
    """
    idx = np.asarray(idx, dtype=np.int32)
    w = np.asarray(w, dtype=np.float32)
    key = np.concatenate([idx, w.view(np.int32)], axis=1)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    k = idx.shape[1]
    return (
        np.ascontiguousarray(uniq[:, :k], dtype=np.int32),
        np.ascontiguousarray(uniq[:, k:]).view(np.float32),
        inverse.astype(np.int32).reshape(-1),
    )


def fed_stream(signal: np.ndarray, num_blocks: int, config: EngineConfig = DEFAULT_CONFIG) -> np.ndarray:
    """The sample stream the engine consumes: the input repeated (wrapping
    playhead, reference: Jefferson/src/Audio.cu:121-139) and truncated to
    num_blocks * frames_per_buffer samples."""
    signal = np.asarray(signal, dtype=_F32)
    if signal.ndim != 1:
        raise ValueError("signal must be mono (1-D)")
    if len(signal) == 0:
        raise ValueError("empty signal")
    total = num_blocks * config.frames_per_buffer
    if len(signal) >= total:
        return signal[:total]
    from ..native import fed_stream as _native_fed

    return _native_fed(signal, num_blocks, config.frames_per_buffer)
