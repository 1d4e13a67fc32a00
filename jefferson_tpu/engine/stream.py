"""Streaming engine: sequential block processing with carried state.

Two forms:

* ``render_scan`` — the whole render as one ``lax.scan`` over blocks inside a
  single jit.  This is the device-resident shape of the reference's realtime loop
  (reference: Jefferson/src/Audio.cu:94-163): the overlap-save buffer is the
  scan carry instead of a mutable pinned-host array.  Used as a cross-check
  of the batched renderer and as the pattern for future feedback effects
  (where output blocks really are sequentially dependent).

* ``StreamingSpatializer`` — a stateful block-at-a-time API, the analogue of
  the PortAudio callback path for live/low-latency use: set the position,
  push 128 samples, get 128 stereo frames.  One jitted single-block step;
  state (history, crossfade old-position) lives on device between calls.
"""

from __future__ import annotations

import functools
import threading

import numpy as np

import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, EngineConfig
from ..hrtf.kemar import HRTFDatabase, round_half_away
from ..ops import fft as fft_ops
from ..ops.filters import blend_filters_split, cmul, distance_factors_split
from ..trajectory.interpolation import interpolation_calculations
from ..trajectory.spatial import radius_from_cartesian, spherical_to_cartesian
from .plan import fed_stream, make_plan

_F32 = np.float32


def _block_step(spec_r, spec_i, hist, block, idx_new, w_new, idx_old, w_old, xfade, u_hi, u_lo, inv_frac, *, config: EngineConfig):
    """One block through the interpolating FD pipeline (split planes).

    hist: (history_len,), block: (fpb,) -> out (fpb, 2), new hist.
    """
    seg = jnp.concatenate([hist, block])
    xr, xi = fft_ops.rfft_split(seg[None, :], config.pad_len)
    dr, di = distance_factors_split(u_hi[None], u_lo[None], inv_frac[None], config.num_bins)
    dr, di = dr[:, None, :], di[:, None, :]

    def filtered(idx, w):
        gr, gi = blend_filters_split(spec_r, spec_i, idx[None], w[None])
        pr, pi = cmul(xr[:, None, :], xi[:, None, :], gr, gi)
        return cmul(pr, pi, dr, di)

    qr_new, qi_new = filtered(idx_new, w_new)
    qr_old, qi_old = filtered(idx_old, w_old)
    qr = jnp.concatenate([qr_old, qr_new], axis=1)
    qi = jnp.concatenate([qi_old, qi_new], axis=1)
    y = fft_ops.irfft_tail_split(qr, qi, config.pad_len, config.frames_per_buffer)[0]
    fn = jnp.arange(config.frames_per_buffer, dtype=jnp.float32) / jnp.float32(
        config.frames_per_buffer - 1
    )
    mixed = y[:2] * (1.0 - fn) + y[2:] * fn
    out = jnp.where(xfade, mixed, y[2:])
    new_hist = seg[config.frames_per_buffer :]
    return jnp.transpose(out, (1, 0)), new_hist


def _block_step_noxf(spec_r, spec_i, hist, block, idx_new, w_new, u_hi, u_lo,
                     inv_frac, *, config: EngineConfig):
    """No-crossfade single-block step (round 5): the live loop knows per
    block whether the position changed BEFORE dispatch, and most live
    blocks hold — this variant computes only the new-side filter apply
    (half the per-block tail/apply FLOPs).  Output is bit-identical to
    _block_step with xfade=False (there out = where(False, ..., y_new))."""
    seg = jnp.concatenate([hist, block])
    xr, xi = fft_ops.rfft_split(seg[None, :], config.pad_len)
    dr, di = distance_factors_split(u_hi[None], u_lo[None], inv_frac[None], config.num_bins)
    dr, di = dr[:, None, :], di[:, None, :]
    gr, gi = blend_filters_split(spec_r, spec_i, idx_new[None], w_new[None])
    pr, pi = cmul(xr[:, None, :], xi[:, None, :], gr, gi)
    qr, qi = cmul(pr, pi, dr, di)
    y = fft_ops.irfft_tail_split(qr, qi, config.pad_len, config.frames_per_buffer)[0]
    new_hist = seg[config.frames_per_buffer :]
    return jnp.transpose(y, (1, 0)), new_hist


_SPECTRA_CACHE: "weakref.WeakValueDictionary | dict" = {}
# One lock for all three serving caches: the daemon's stream_start threads
# construct StreamingSpatializers concurrently and UNLOCKED (by design —
# heavy prep must not stall renders), so an unguarded miss window would let
# two first-ever sessions each upload private spectra planes / retain
# private jitted wrappers — exactly the per-session leak the caches exist
# to prevent (lru_cache returns the LOSING thread's non-cached value on a
# concurrent miss).
_CACHE_LOCK = threading.Lock()


def _device_spectra(db: HRTFDatabase):
    """Shared (spec_r, spec_i) device planes per database object.

    Each StreamingSpatializer used to upload its own 2 x 2.9 MB float32
    copies of the spectra; under the serve daemon's session churn that is
    ~6 MiB of allocator traffic per stream session (round-4 soak) for
    bit-identical data.  Keyed by id(db) with the db held weakly so a
    dropped database releases its planes."""
    import weakref

    with _CACHE_LOCK:
        key = id(db)
        hit = _SPECTRA_CACHE.get(key)
        if hit is not None and hit[0]() is db:
            return hit[1]
        planes = (
            jnp.asarray(np.real(db.spectra).astype(np.float32)),
            jnp.asarray(np.imag(db.spectra).astype(np.float32)),
        )

        def _drop(_ref, _key=key):
            _SPECTRA_CACHE.pop(_key, None)

        _SPECTRA_CACHE[key] = (weakref.ref(db, _drop), planes)
        return planes


@functools.lru_cache(maxsize=None)
def _jitted_block_step_uncached(config: EngineConfig):
    return jax.jit(functools.partial(_block_step, config=config))


@functools.lru_cache(maxsize=None)
def _jitted_block_step_noxf_uncached(config: EngineConfig):
    return jax.jit(functools.partial(_block_step_noxf, config=config))


def _jitted_block_step(config: EngineConfig):
    """One jitted single-block step PER CONFIG, shared by every
    StreamingSpatializer instance.  A per-instance jax.jit(partial(...))
    wrapper compiles (and retains) a fresh executable per instance — under
    the serve daemon's session churn that measured ~30 MiB RSS growth per
    stream session (round-4 soak) and re-pays the block-step compile on
    every stream_start.  EngineConfig is a frozen dataclass (hashable), so
    the memo key is the config itself; distinct configs still get their
    own program.  Locked: see _CACHE_LOCK."""
    with _CACHE_LOCK:
        return _jitted_block_step_uncached(config)


def _jitted_block_step_noxf(config: EngineConfig):
    """Shared no-crossfade block step (see _jitted_block_step — same
    one-program-per-config serving discipline; TWO bounded programs per
    config total, not per session)."""
    with _CACHE_LOCK:
        return _jitted_block_step_noxf_uncached(config)


@functools.partial(jax.jit, static_argnames=("config",))
def _scan_render(spec_r, spec_i, blocks, idx_new, w_new, idx_old, w_old, xfade, u_hi, u_lo, inv_frac, config: EngineConfig):
    hist0 = jnp.zeros(config.history_len, dtype=jnp.float32)

    def body(hist, xs):
        blk, inw, wn, iold, wo, xf, uh, ul, ifr = xs
        out, hist = _block_step(
            spec_r, spec_i, hist, blk, inw, wn, iold, wo, xf, uh, ul, ifr, config=config
        )
        return hist, out

    _, ys = jax.lax.scan(
        body, hist0, (blocks, idx_new, w_new, idx_old, w_old, xfade, u_hi, u_lo, inv_frac)
    )
    return ys  # (B, fpb, 2)


def render_scan(
    signal: np.ndarray,
    db: HRTFDatabase,
    positions,
    config: EngineConfig = DEFAULT_CONFIG,
    initial_old: tuple[float, float] | None = (0.0, 0.0),
) -> np.ndarray:
    """Sequential-scan render (interpolating FD path only)."""
    plan = make_plan(np.asarray(positions), config, initial_old)
    fed = fed_stream(signal, plan.num_blocks, config).reshape(plan.num_blocks, config.frames_per_buffer)
    spec_r, spec_i = _device_spectra(db)  # shared upload per database
    ys = _scan_render(
        spec_r,
        spec_i,
        jnp.asarray(fed),
        jnp.asarray(plan.idx_new),
        jnp.asarray(plan.w_new),
        jnp.asarray(plan.idx_old),
        jnp.asarray(plan.w_old),
        jnp.asarray(plan.xfade),
        jnp.asarray(plan.u_hi),
        jnp.asarray(plan.u_lo),
        jnp.asarray(plan.inv_frac),
        config,
    )
    return np.asarray(ys).reshape(plan.num_blocks * config.frames_per_buffer, 2)


class StreamingSpatializer:
    """Live block-at-a-time spatializer (the PortAudio-callback analogue).

    Mirrors the reference's mutable SoundSource state machine (position,
    old-position crossfade trigger, overlap-save history, wrapping playhead
    when fed from a buffer) with a single jitted device step per block.
    """

    def __init__(
        self,
        db: HRTFDatabase,
        config: EngineConfig | None = None,
        pipeline_latency: int = 0,
    ):
        """``pipeline_latency=1`` reproduces the reference GPU path's timing:
        each call emits the *previous* block's result (silence first) while
        the current block is processed — the callback/enqueue overlap of
        reference: Jefferson/src/Audio.cu:104-117.  0 (default) is the
        synchronous CPU-path timing."""
        self.db = db
        self.config = config or db.config
        self.pipeline_latency = pipeline_latency
        self._pending: list[np.ndarray] = []
        self._spec_r, self._spec_i = _device_spectra(db)  # shared per db
        self._hist = jnp.zeros(self.config.history_len, dtype=jnp.float32)
        self._step = _jitted_block_step(self.config)  # shared across sessions
        self._step_nx = _jitted_block_step_noxf(self.config)
        # reference constructor state (Jefferson/src/SoundSource.cu:3-16)
        self.azi = _F32(0.0)
        self.ele = _F32(0.0)
        self.r = _F32(0.5)
        self.old_azi = self.azi
        self.old_ele = self.ele
        # raw cartesian coordinates, set only by set_position_cartesian:
        # the oracle keeps the raw xyz and derives the distance factor from
        # it (reference update_from_cartesian); reconstructing from the
        # ROUNDED angles would move the radius by an ulp
        self._coords: tuple[float, float, float] | None = None
        self.buf: np.ndarray | None = None
        self.count = 0
        self.clipping = False
        self.crossfades = 0  # blocks whose position changed (xfade fired)
        # host-side per-position caches: live callers hold a position for
        # many consecutive blocks, so the interpolation/distance setup math
        # (pure functions of azi/ele/r) is memoized to keep per-block host
        # overhead inside the realtime budget
        self._interp_cache: dict[tuple, tuple] = {}
        self._dist_cache: dict[float, tuple] = {}

    def set_position(self, azi=None, ele=None, r=None) -> None:
        if azi is not None:
            self.azi = _F32(round_half_away(_F32(azi)))
        if ele is not None:
            self.ele = _F32(round_half_away(_F32(ele)))
        if r is not None:
            self.r = _F32(r)
        self._coords = None  # spherical-driven: radius via the xyz roundtrip

    def set_position_cartesian(self, xyz) -> None:
        from ..trajectory.spatial import cartesian_to_spherical

        xyz = np.asarray(xyz, dtype=_F32)
        azi, ele, r = cartesian_to_spherical(xyz)
        self.azi, self.ele, self.r = _F32(azi), _F32(ele), _F32(r)
        # keep the RAW coordinates for the distance factor, like the oracle
        self._coords = (float(xyz[0]), float(xyz[1]), float(xyz[2]))

    _CACHE_CAP = 4096  # bound the per-position memo for long-lived sessions

    def _interp(self, ele, azi):
        key = (float(ele), float(azi))
        hit = self._interp_cache.get(key)
        if hit is None:
            if len(self._interp_cache) >= self._CACHE_CAP:
                self._interp_cache.clear()
            c = interpolation_calculations(ele, azi)
            hit = (jnp.asarray(c.indices[0]), jnp.asarray(c.weights[0]))
            self._interp_cache[key] = hit
        return hit

    def _distance_current(self):
        """Distance planes for the CURRENT position, memoized.

        Spherical-driven positions reconstruct coordinates from the rounded
        angles (the offline planner's semantics); cartesian-driven positions
        use the raw xyz like the oracle's update_from_cartesian — the keys
        are tagged so the two conventions never collide in the memo."""
        if self._coords is not None:
            key = ("c", *self._coords)
        else:
            key = ("s", float(self.azi), float(self.ele), float(self.r))
        hit = self._dist_cache.get(key)
        if hit is None:
            if len(self._dist_cache) >= self._CACHE_CAP:
                # a continuously-varying radius would otherwise grow this
                # without bound (~6 KB of device arrays per entry)
                self._dist_cache.clear()
            from ..ops.filters import distance_phase_split

            cfg = self.config
            if key[0] == "c":
                coords = np.asarray(key[1:], dtype=_F32)
            else:
                coords = spherical_to_cartesian(self.azi, self.ele, self.r)
            scaled_r = np.float32(
                radius_from_cartesian(coords) / _F32(cfg.distance_scale)
            )
            u_hi, u_lo, inv_frac = distance_phase_split(
                cfg.fsvs, scaled_r[None], cfg.num_bins
            )
            hit = (jnp.asarray(u_hi[0]), jnp.asarray(u_lo[0]), jnp.asarray(inv_frac[0]))
            self._dist_cache[key] = hit
        return hit

    def prime(self) -> None:
        """Compile the block step without mutating streaming state.

        Realtime callers (rt.playout) invoke this before opening the device
        stream so the first audible block doesn't absorb the jit compile —
        the analogue of the reference doing all CUDA/cuFFT setup in the
        constructor before PortAudio starts (Jefferson/src/GPUSoundSource.cu:17-71).
        """
        cfg = self.config
        # warm through the SAME memoized paths process_block uses, so the
        # first audible block pays neither a compile nor a host-cache miss
        idx, w = self._interp(self.ele, self.azi)
        u_hi, u_lo, inv_frac = self._distance_current()
        out, _ = self._step(
            self._spec_r,
            self._spec_i,
            self._hist,
            jnp.zeros(cfg.frames_per_buffer, jnp.float32),
            idx,
            w,
            idx,
            w,
            jnp.asarray(False),
            u_hi,
            u_lo,
            inv_frac,
        )
        np.asarray(out)  # force completion
        out, _ = self._step_nx(  # the steady-state (non-crossfading) program
            self._spec_r,
            self._spec_i,
            self._hist,
            jnp.zeros(cfg.frames_per_buffer, jnp.float32),
            idx,
            w,
            u_hi,
            u_lo,
            inv_frac,
        )
        np.asarray(out)

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """Push frames_per_buffer mono samples -> (fpb, 2) float32 stereo."""
        cfg = self.config
        block = np.asarray(block, dtype=_F32)
        if block.shape != (cfg.frames_per_buffer,):
            raise ValueError(f"block must be ({cfg.frames_per_buffer},), got {block.shape}")
        idx_n, w_n = self._interp(self.ele, self.azi)
        xfade = bool(self.old_azi != self.azi or self.old_ele != self.ele)
        self.crossfades += int(xfade)
        # keyed on the full position: the float32 xyz roundtrip makes the
        # effective radius minutely angle-dependent (reference semantics)
        u_hi, u_lo, inv_frac = self._distance_current()
        if xfade:
            idx_o, w_o = self._interp(self.old_ele, self.old_azi)
            out, self._hist = self._step(
                self._spec_r,
                self._spec_i,
                self._hist,
                jnp.asarray(block),
                idx_n,
                w_n,
                idx_o,
                w_o,
                jnp.asarray(xfade),
                u_hi,
                u_lo,
                inv_frac,
            )
        else:
            # steady state (most live blocks): the no-crossfade step skips
            # the old-side filter apply entirely — bit-identical output
            out, self._hist = self._step_nx(
                self._spec_r,
                self._spec_i,
                self._hist,
                jnp.asarray(block),
                idx_n,
                w_n,
                u_hi,
                u_lo,
                inv_frac,
            )
        self.old_azi, self.old_ele = self.azi, self.ele
        out = np.asarray(out)
        if np.any(np.abs(out) > 1.0):
            self.clipping = True  # reference: clipping alert (Audio.cu:111-113)
        if self.pipeline_latency:
            self._pending.append(out)
            if len(self._pending) > self.pipeline_latency:
                return self._pending.pop(0)
            return np.zeros_like(out)
        return out

    def next_block(self) -> np.ndarray:
        """Advance the wrapping playback buffer (set ``self.buf`` first) and
        return the next raw mono block — THE playhead implementation; the
        daemon stream and rt loop feed through it rather than re-deriving
        the `% length` arithmetic."""
        cfg = self.config
        fpb = cfg.frames_per_buffer
        if self.buf is None:
            raise ValueError(
                "set .buf (the wrapping playback buffer) before pulling blocks"
            )
        length = len(self.buf)
        if length == 0:
            raise ValueError("playback buffer is empty")
        if self.count + fpb < length:
            # copy: the wrap branch's fancy-index below is a copy, and THE
            # playhead API must not hand out live views of the buffer
            blk = self.buf[self.count : self.count + fpb].copy()
            self.count += fpb
        else:
            # modular wrap (the reference's `% length` playhead,
            # Audio.cu:121-139, generalized): buffers shorter than one
            # block tile as many times as needed, like fed_stream
            blk = self.buf[(self.count + np.arange(fpb)) % length]
            self.count = (self.count + fpb) % length
        return blk

    def process_next(self) -> np.ndarray:
        """Pull the next block from the wrapping playback buffer (set
        ``self.buf`` first), like the reference's callback feed."""
        return self.process_block(self.next_block())
