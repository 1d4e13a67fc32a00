"""Offline batched renderer — the flagship accelerator compute path.

Key insight (vs the reference's realtime block loop, reference:
Jefferson/src/Audio.cu:94-163): offline, the overlap-save dependency chain is
on the *input*, which is fully known, so output blocks are independent.  The
whole render becomes one batched pipeline per chunk of blocks:

    sliding sub-block forward DFT over the sample stream -> (B, bins) planes
    -> extended HRTF blend (old set = previous block's new set) per ear
    -> x distance factor (shared), x blended filters -> tail-only inverse DFT
    -> crossfade tails -> (B, 128, 2)

with zero sequential state on the device, all tensors channel-split
(B, bins) float32 planes.  The reference needs ~16 kernel
launches + 3 FFTs per 128-sample block (reference:
Jefferson/src/GPUSoundSource.cu:320-385); here XLA sees the entire chunk as
one fused program, and all FLOPs are batched dense ops.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..config import EngineConfig, ProcessType
from ..hrtf.kemar import HRTFDatabase
from ..ops import fft as fft_ops
from ..ops.filters import (
    blend_filters,
    cmul,
    crossfade_tails,
    distance_factors,
    distance_factors_split,
)
from .plan import RenderPlan, fed_stream, make_plan


def _segments(full: jax.Array, num_blocks: int, config: EngineConfig) -> jax.Array:
    """(hist + B*fpb,) sample stream -> (B, pad_len) overlap-save windows."""
    fpb = config.frames_per_buffer
    starts = jnp.arange(num_blocks) * fpb
    idx = starts[:, None] + jnp.arange(config.pad_len)[None, :]
    return full[idx]


def _forward_split(full: jax.Array, num_blocks: int, config: EngineConfig):
    """Forward DFT planes of all overlap-save windows (matmul backend).

    Uses the sliding sub-block decomposition when the history is a whole
    number of blocks (the default geometry), avoiding the q-fold duplicated
    window materialization; falls back to explicit windows otherwise.
    """
    if config.history_len % config.frames_per_buffer == 0:
        return fft_ops.rfft_sliding_split(
            full, num_blocks, config.frames_per_buffer, config.pad_len
        )
    segs = _segments(full, num_blocks, config)
    return fft_ops.rfft_split(segs, config.pad_len)


def _fd_complex_chunk(
    spectra,
    hist: jax.Array,
    fed: jax.Array,
    idx_new: jax.Array,
    w_new: jax.Array,
    idx_old: jax.Array,
    w_old: jax.Array,
    xfade: jax.Array,
    u_hi: jax.Array,
    u_lo: jax.Array,
    inv_frac: jax.Array,
    *,
    config: EngineConfig,
    num_blocks: int,
    backend: str,
    with_xfade: bool,
):
    """One chunk of the interpolating FD pipeline. Returns ((B, fpb, 2), new_hist).

    backend 'matmul' (default): explicit real/imag planes, DFT as fp32
    HIGHEST-precision matmuls, inverse truncated to the output tail (an 8x
    FLOP cut over the full inverse).  backend 'fft': complex64 through
    XLA's FFT HLO (cuFFT on the GPU), the reference's own formulation.
    """
    full = jnp.concatenate([hist, fed])
    new_hist = full[num_blocks * config.frames_per_buffer :]
    fpb = config.frames_per_buffer

    if backend == "fft":
        spectra_c = spectra
        x_spec = fft_ops.rfft(_segments(full, num_blocks, config), config.pad_len)
        df = distance_factors(u_hi, u_lo, inv_frac, config.num_bins)
        g_new = blend_filters(spectra_c, idx_new, w_new) * df[:, None, :]
        prod_new = x_spec[:, None, :] * g_new
        if with_xfade:
            g_old = blend_filters(spectra_c, idx_old, w_old) * df[:, None, :]
            prod_old = x_spec[:, None, :] * g_old
            stacked = jnp.concatenate([prod_old, prod_new], axis=1)
            y = fft_ops.irfft(stacked, config.pad_len)[..., config.history_len :]
            out = crossfade_tails(y[:, :2], y[:, 2:], xfade)
        else:
            out = fft_ops.irfft(prod_new, config.pad_len)[..., config.history_len :]
        return jnp.transpose(out, (0, 2, 1)), new_hist

    xr, xi = _forward_split(full, num_blocks, config)
    if with_xfade:
        # old filters of block b are new filters of block b-1 by plan
        # construction, so one extended blend of B+1 rows serves both sets.
        idx_ext = jnp.concatenate([idx_old[:1], idx_new], axis=0)
        w_ext = jnp.concatenate([w_old[:1], w_new], axis=0)
        g = blend_channels(spectra, idx_ext, w_ext)
        g_old = tuple(a[:num_blocks] for a in g)
        g_new = tuple(a[1:] for a in g)
    else:
        g_new = blend_channels(spectra, idx_new, w_new)
        g_old = None
    out = apply_filters_core(
        xr, xi, g_old, g_new, xfade, u_hi, u_lo, inv_frac,
        config=config, with_xfade=with_xfade,
    )
    return out, new_hist


def _fd_complex_chunk_dedup(
    spectra,
    hist: jax.Array,
    fed: jax.Array,
    uniq_idx: jax.Array,
    uniq_w: jax.Array,
    inv: jax.Array,
    xfade: jax.Array,
    u_hi: jax.Array,
    u_lo: jax.Array,
    inv_frac: jax.Array,
    *,
    config: EngineConfig,
    num_blocks: int,
    with_xfade: bool,
):
    """Deduplicated variant of the matmul-backend FD chunk.

    Real trajectories hold each position for many blocks, so the (B+1, 4)
    blend rows contain few unique values.  Blend only the U unique rows
    (U << B) and broadcast with one row-gather per plane: 4(B+1) row
    reads per plane become 4U + (B+1).  Bit-identical to the direct path
    (same per-row op order).  ``inv`` maps extended row b -> unique id;
    with_xfade consumes B+1 rows (old[b] == new[b-1] by plan construction),
    otherwise B.
    """
    full = jnp.concatenate([hist, fed])
    new_hist = full[num_blocks * config.frames_per_buffer :]
    xr, xi = _forward_split(full, num_blocks, config)
    g_cat = blend_cat(cat_table(spectra), uniq_idx, uniq_w)  # (U, 4*bins)
    g = split_planes(jnp.take(g_cat, inv, axis=0), config.num_bins)
    if with_xfade:
        g_old = tuple(a[:num_blocks] for a in g)
        g_new = tuple(a[1:] for a in g)
    else:
        g_old, g_new = None, g
    out = apply_filters_core(
        xr, xi, g_old, g_new, xfade, u_hi, u_lo, inv_frac,
        config=config, with_xfade=with_xfade,
    )
    return out, new_hist


def _apply_xfade_amortization(chunk_xfs: list[bool]) -> list[bool]:
    """Amortization guard for the no-crossfade program election: a SECOND
    program variant costs a compile of its own, so the
    no-crossfade variant is only elected when at least two chunks would use
    it (a lone crossfade-free chunk rides the crossfade program; a
    whole-render no-crossfade always qualifies).  THE single policy —
    renderer and BatchRenderer both plan with it (like _sparse_bucket)."""
    if any(chunk_xfs) and 0 < chunk_xfs.count(False) < 2:
        return [True] * len(chunk_xfs)
    return chunk_xfs


def cat_table(spectra) -> jax.Array:
    """Combined-plane filter table (num_hrtf, 4*bins) = [rL | iL | rR | iR].

    One wide row per filter: the blend becomes 4 row-gathers of the combined
    table instead of 16 narrow per-plane gathers, bit-identical.  Built inside the jitted chunk (a (710, 2052) concat)."""
    hr, hi = spectra
    return jnp.concatenate([hr[:, 0, :], hi[:, 0, :], hr[:, 1, :], hi[:, 1, :]], axis=1)


def blend_cat(table_cat: jax.Array, indices: jax.Array, weights: jax.Array) -> jax.Array:
    """Weighted 4-row gather on the combined table -> (rows, 4*bins)."""
    w = weights.astype(jnp.float32)
    acc = w[:, 0:1] * jnp.take(table_cat, indices[:, 0], axis=0)
    for j in range(1, indices.shape[1]):
        acc = acc + w[:, j : j + 1] * jnp.take(table_cat, indices[:, j], axis=0)
    return acc


def split_planes(cat: jax.Array, bins: int):
    """(rows, 4*bins) combined blend -> (grL, giL, grR, giR) column views."""
    return tuple(cat[..., k * bins : (k + 1) * bins] for k in range(4))


def blend_channels(spectra, indices: jax.Array, weights: jax.Array):
    """Per-ear weighted filter blends: (rows, 4) indices/weights ->
    (grL, giL, grR, giR), each (rows, bins).  Combined-plane formulation."""
    hr, hi = spectra
    return split_planes(blend_cat(cat_table(spectra), indices, weights), hr.shape[-1])


def apply_filters_core(
    xr, xi, g_old, g_new, xfade, u_hi, u_lo, inv_frac,
    *, config: EngineConfig, with_xfade: bool,
):
    """Filter application on forward planes -> (B, fpb, 2) stereo tails.

    Channel-split layout: every tensor is (B, bins) — per ear, per plane —
    so nothing carries a (…, 2, bins) second-minor axis of 2.  The distance factor is
    folded into the input spectrum once ((X·D)·G instead of (X·G)·D, a
    float-safe reassociation within the parity gates), shared by all filter
    sets.  Used by the single-source renderer and the flattened batch.
    """
    fpb = config.frames_per_buffer
    dr, di = distance_factors_split(u_hi, u_lo, inv_frac, config.num_bins)
    xdr, xdi = cmul(xr, xi, dr, di)

    def q_set(g):
        grl, gil, grr, gir = g
        return [cmul(xdr, xdi, grl, gil), cmul(xdr, xdi, grr, gir)]

    qs = (q_set(g_old) if with_xfade else []) + q_set(g_new)
    qr = jnp.stack([q[0] for q in qs])  # (2 or 4, B, bins)
    qi = jnp.stack([q[1] for q in qs])
    y = fft_ops.irfft_tail_split(qr, qi, config.pad_len, fpb)  # (S, B, fpb)
    if with_xfade:
        fn = jnp.arange(fpb, dtype=jnp.float32) / jnp.float32(fpb - 1)
        mixed = y[:2] * (1.0 - fn) + y[2:] * fn
        out = jnp.where(xfade[None, :, None], mixed, y[2:])
    else:
        out = y
    return jnp.transpose(out, (1, 2, 0))

def _fd_basic_chunk(spectra, hist, fed, nearest, *, config, num_blocks, backend):
    """Nearest-HRTF FD path: no interpolation/distance/crossfade
    (reference: Jefferson/src/CPUSoundSource.cpp:113-142)."""
    full = jnp.concatenate([hist, fed])
    new_hist = full[num_blocks * config.frames_per_buffer :]
    if backend == "fft":
        x_spec = fft_ops.rfft(_segments(full, num_blocks, config), config.pad_len)
        g = spectra[nearest]  # (B, 2, bins)
        y = fft_ops.irfft(x_spec[:, None, :] * g, config.pad_len)[..., config.history_len :]
        return jnp.transpose(y, (0, 2, 1)), new_hist
    hr, hi = spectra
    xr, xi = _forward_split(full, num_blocks, config)
    qs = []
    for ch in (0, 1):
        gr = jnp.take(hr[:, ch, :], nearest, axis=0)
        gi = jnp.take(hi[:, ch, :], nearest, axis=0)
        qs.append(cmul(xr, xi, gr, gi))
    y = fft_ops.irfft_tail_split(
        jnp.stack([q[0] for q in qs]),
        jnp.stack([q[1] for q in qs]),
        config.pad_len,
        config.frames_per_buffer,
    )
    return jnp.transpose(y, (1, 2, 0)), new_hist


def _td_chunk(hrirs, hist, fed, nearest, *, config, num_blocks):
    """Time-domain path: per-block convolution with the nearest HRIR pair via
    a batched matmul (the dense analogue of the reference's
    naive kernel, reference: Jefferson/src/kernels.cu:139-148).

    The output is scaled by the source gain clamped at 1 — the reference's
    GPU TD semantics (`value * gain`, kernels.cu:146, gain clamp
    GPUSoundSource.cu:418-419).  Its CPU TD path hardcodes gain = 1
    (CPUSoundSource.cpp:74), a CPU/GPU divergence in the reference itself;
    this engine is the GPU analogue, and the oracle takes td_gain to match
    either side (PARITY.md defect list)."""
    fpb = config.frames_per_buffer
    taps = config.hrtf_len
    full = jnp.concatenate([hist, fed])
    starts = jnp.arange(num_blocks) * fpb
    # window needed per block: taps-1 history + fpb new samples
    idx = starts[:, None] + (config.history_len - (taps - 1)) + jnp.arange(taps - 1 + fpb)
    segs = full[idx]  # (B, taps-1+fpb)
    h = hrirs[nearest][:, :, :taps]  # (B, 2, taps)
    y = _td_direct(segs, h, fpb, taps)
    gain = min(config.source_gain, 1.0)
    if gain != 1.0:
        y = y * jnp.float32(gain)
    return jnp.transpose(y, (0, 2, 1)), full[num_blocks * fpb :]


def _td_direct(segs: jax.Array, h: jax.Array, fpb: int, taps: int) -> jax.Array:
    """Per-block TD convolution as one einsum over sliding windows.

    segs: (B, taps-1+fpb); h: (B, 2, taps) -> (B, 2, fpb).
    The window matrix is (B, fpb, taps) with win[b, n, k] = segs[b, n+taps-1-k],
    so y = einsum('bnk,bck->bcn', win, h) — a batched matmul.
    """
    n_idx = jnp.arange(fpb)[:, None]
    k_idx = jnp.arange(taps)[None, :]
    win = segs[:, n_idx + (taps - 1) - k_idx]  # (B, fpb, taps)
    return jnp.einsum(
        "bnk,bck->bcn", win, h, precision=jax.lax.Precision.HIGHEST
    )


class Renderer:
    """Offline file-to-file renderer (the reference's DEBUGMODE-3 manual
    callback mode made primary, reference: Jefferson/src/main.cu:149-154).

    Usage::

        r = Renderer(db)
        out = r.render(signal, positions)          # (B*128, 2) float32
    """

    def __init__(
        self,
        db: HRTFDatabase,
        config: EngineConfig | None = None,
        chunk_blocks: int = 2048,
        backend: str = "matmul",
        dedup: bool = True,
        mesh=None,
        pipeline_fetch: bool = False,
    ):
        """``backend``: 'matmul' (split real/imag planes, DFT as fp32
        matmuls, inverse truncated to the output tail) or 'fft' (complex64
        through XLA's FFT, cuFFT on the GPU).
        ``dedup``: blend only unique (index, weight) rows per chunk and
        broadcast (bit-identical; auto-disabled when a chunk has too many
        unique positions for it to pay). matmul backend only.
        ``mesh``: optional 1-D jax Mesh — one render's TIME-BLOCK axis is
        sharded across it ('sp'-style: offline blocks are independent given
        the input stream, so GSPMD partitions the chunk pipeline and
        inserts the sliding-window halo collectives itself; SURVEY §2's
        parallelism map names this the natural single-source extension).
        ``pipeline_fetch``: overlap the chunk loop — dispatch chunk i+1
        (device work is queued asynchronously) BEFORE fetching chunk i's
        output, so compute and device->host transfer overlap.  Output is
        bit-identical either way; off by default until measured."""
        self.db = db
        self.config = config or db.config
        if chunk_blocks < 1:
            # catch library callers up front — a zero/negative chunk size
            # otherwise fails deep in the chunk loop on the first render
            raise ValueError(f"chunk_blocks ({chunk_blocks}) must be positive")
        self.chunk_blocks = chunk_blocks
        self.backend = backend
        self.mesh = mesh
        self.pipeline_fetch = pipeline_fetch
        if mesh is not None:
            if len(mesh.axis_names) != 1:
                raise ValueError("Renderer mesh must be 1-D (block axis)")
            if chunk_blocks % mesh.size:
                raise ValueError(
                    f"chunk_blocks ({chunk_blocks}) must divide evenly over "
                    f"the {mesh.size}-device mesh"
                )
        self.dedup = dedup and backend != "fft"
        if backend == "fft":
            self._spectra = jnp.asarray(db.spectra)
        else:
            self._spectra = (
                jnp.asarray(np.real(db.spectra).astype(np.float32)),
                jnp.asarray(np.imag(db.spectra).astype(np.float32)),
            )
        self._hrirs = jnp.asarray(db.hrirs)
        cfg = self.config

        def jit_chunk(fn, **kw):
            # the wrapper keeps fn's name, so traces and HLO dumps name
            # the chunk program after its function
            return jax.jit(functools.update_wrapper(functools.partial(fn, **kw), fn))

        self._fd_complex = {}
        self._fd_dedup = {}
        self._fd_basic = {}
        self._td = {}
        self._mk_fd_complex = lambda nb, xf: jit_chunk(
            _fd_complex_chunk, config=cfg, num_blocks=nb, backend=self.backend, with_xfade=xf
        )
        self._mk_fd_dedup = lambda nb, xf: jit_chunk(
            _fd_complex_chunk_dedup, config=cfg, num_blocks=nb, with_xfade=xf
        )
        self._mk_fd_basic = lambda nb: jit_chunk(
            _fd_basic_chunk, config=cfg, num_blocks=nb, backend=self.backend
        )
        self._mk_td = lambda nb: jit_chunk(_td_chunk, config=cfg, num_blocks=nb)

    # --- public API -------------------------------------------------------
    def render(
        self,
        signal: np.ndarray,
        positions: Sequence | np.ndarray,
        ptype: ProcessType = ProcessType.TPU_FD_COMPLEX,
        initial_old: tuple[float, float] | None = (0.0, 0.0),
    ) -> np.ndarray:
        """Render mono ``signal`` along per-block ``positions`` -> (B*fpb, 2)."""
        plan = make_plan(np.asarray(positions), self.config, initial_old)
        return self.render_plan(signal, plan, ptype)

    def render_plan(
        self, signal: np.ndarray, plan: RenderPlan, ptype: ProcessType = ProcessType.TPU_FD_COMPLEX
    ) -> np.ndarray:
        """Render a prepared plan chunk by chunk.

        FD_COMPLEX chunks take the dedup program when positions repeat
        across blocks (few unique blend rows per chunk, the reference
        benchmark's shape) and the direct program otherwise.  Both are
        oracle-gated at the reference's 2e-7 tolerance.
        """
        cfg = self.config
        fd_complex = ptype in (ProcessType.TPU_FD_COMPLEX, ProcessType.CPU_FD_COMPLEX)
        if fd_complex and plan.num_blocks > 1:
            # the chunk kernel derives the old filter set from the previous
            # block's new set (one extended blend); make_plan guarantees this
            if not (
                np.array_equal(plan.idx_old[1:], plan.idx_new[:-1])
                and np.array_equal(plan.w_old[1:], plan.w_new[:-1])
            ):
                raise ValueError(
                    "RenderPlan old-position arrays must equal the previous "
                    "block's new arrays (build plans with make_plan)"
                )
        fpb = cfg.frames_per_buffer
        b_total = plan.num_blocks
        cb = min(self.chunk_blocks, b_total) if b_total else self.chunk_blocks
        if self.mesh is not None and cb % self.mesh.size:
            # short renders (b_total < chunk_blocks) must keep the chunk a
            # mesh multiple, or dev()'s divisibility guard silently drops
            # every per-block operand to P() replication and the N-device
            # sharding is lost; pad up — the constructor guarantees
            # chunk_blocks itself is a mesh multiple, so this never exceeds
            # it, and the padded tail is trimmed like any partial chunk
            cb += self.mesh.size - cb % self.mesh.size
        fed_all = fed_stream(signal, b_total, cfg)
        # block-axis mesh: shard every per-block (and per-sample) chunk
        # argument over the mesh; replicate the small broadcast arrays.
        # Chunks are always padded to cb (divisible by the mesh), so shards
        # stay even; GSPMD inserts the DFT window halo exchange.
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            mesh, blk_ax = self.mesh, self.mesh.axis_names[0]

            def dev(a, shard=True):
                a = jnp.asarray(a)
                spec = (
                    P(blk_ax, *([None] * (a.ndim - 1)))
                    if shard and a.ndim >= 1 and a.shape[0] % mesh.size == 0
                    else P()
                )
                return jax.device_put(a, NamedSharding(mesh, spec))
        else:
            def dev(a, shard=True):
                return jnp.asarray(a)
        hist = dev(np.zeros(cfg.history_len, dtype=np.float32), shard=False)
        out = np.empty((b_total * fpb, 2), dtype=np.float32)

        def pad(a, nb):
            if nb == cb:
                return dev(a)
            return dev(np.concatenate([a, np.repeat(a[-1:], cb - nb, axis=0)]))

        # static-segment dedup: one pass over the chunks to find the unique
        # blend rows per chunk; one Upad bucket per render (single compiled
        # program).  Pays when positions persist across blocks (the common
        # case); falls back to the direct path for every-block movers.
        dedup_chunks = None
        if self.dedup and fd_complex and b_total:
            from .plan import dedup_rows

            dedup_chunks, max_u = [], 1
            for start in range(0, b_total, cb):
                stop = min(start + cb, b_total)
                sl = slice(start, stop)
                # always the extended (cb+1) rows: [old_start, new_0..new_cb-1]
                # serves BOTH chunk variants — [:cb] is the old-aligned set,
                # [1:] the new set (old[b] == new[b-1] by plan construction)
                ext_idx = np.concatenate([plan.idx_old[start : start + 1], plan.idx_new[sl]])
                ext_w = np.concatenate([plan.w_old[start : start + 1], plan.w_new[sl]])
                rows = cb + 1
                if ext_idx.shape[0] < rows:  # final partial chunk
                    reps = rows - ext_idx.shape[0]
                    ext_idx = np.concatenate([ext_idx, np.repeat(ext_idx[-1:], reps, axis=0)])
                    ext_w = np.concatenate([ext_w, np.repeat(ext_w[-1:], reps, axis=0)])
                uniq_idx, uniq_w, inv = dedup_rows(ext_idx, ext_w)
                max_u = max(max_u, uniq_idx.shape[0])
                dedup_chunks.append((uniq_idx, uniq_w, inv))
            u_pad = max(8, 1 << int(np.ceil(np.log2(max_u))))
            if u_pad * 2 > cb:  # not enough duplication to pay off
                dedup_chunks = None

        # program-count discipline: fixed chunk size (last partial chunk
        # padded and trimmed) and AT MOST TWO xfade variants per path —
        # chunks with no crossfading block use the no-crossfade programs
        # (half the tail-IDFT MACs; hold renders spend all but chunk 0
        # there), all others share one crossfade program
        chunk_xfs = _apply_xfade_amortization([
            bool(plan.xfade[start : min(start + cb, b_total)].any())
            for start in range(0, b_total, cb)
        ])

        # pipelined output fetch (opt-in; see __init__): one chunk deep —
        # after dispatching chunk i+1 (async), fetch chunk i's output
        pipelined = bool(self.pipeline_fetch)
        pending: tuple | None = None  # (start, stop, y) awaiting its fetch

        def flush():
            nonlocal pending
            if pending is not None:
                p_start, p_stop, p_y = pending
                pending = None
                out[p_start * fpb : p_stop * fpb] = (
                    np.asarray(p_y).reshape(cb * fpb, 2)[: (p_stop - p_start) * fpb]
                )

        for start in range(0, b_total, cb):
            stop = min(start + cb, b_total)
            nb = stop - start
            sl = slice(start, stop)
            fed_np = fed_all[start * fpb : stop * fpb]
            if nb < cb:
                fed_np = np.concatenate([fed_np, np.zeros((cb - nb) * fpb, np.float32)])
            fed = dev(fed_np)
            # per-chunk crossfade flag: crossfade-free chunks of a
            # crossfading render (hold workloads crossfade only at block 0)
            # dispatch to the no-crossfade program variants — half the
            # tail-IDFT MACs and no old-side blend rows, bit-identical on
            # such chunks
            cxf = chunk_xfs[start // cb]
            if fd_complex and dedup_chunks is not None:
                uniq_idx, uniq_w, inv = dedup_chunks[start // cb]
                if uniq_idx.shape[0] < u_pad:  # pad to the render's bucket
                    reps = u_pad - uniq_idx.shape[0]
                    uniq_idx = np.concatenate([uniq_idx, np.repeat(uniq_idx[-1:], reps, axis=0)])
                    uniq_w = np.concatenate([uniq_w, np.repeat(uniq_w[-1:], reps, axis=0)])
                key = (cb, cxf, u_pad)
                if key not in self._fd_dedup:
                    self._fd_dedup[key] = self._mk_fd_dedup(cb, cxf)
                y, hist = self._fd_dedup[key](
                    self._spectra,
                    hist,
                    fed,
                    dev(uniq_idx, shard=False),
                    dev(uniq_w, shard=False),
                    # extended rows for the crossfade program, the NEW
                    # rows ([1:]) for the no-crossfade one
                    dev(inv if cxf else inv[1:], shard=False),
                    pad(plan.xfade[sl], nb),
                    pad(plan.u_hi[sl], nb),
                    pad(plan.u_lo[sl], nb),
                    pad(plan.inv_frac[sl], nb),
                )
            elif fd_complex:
                key = (cb, cxf)
                if key not in self._fd_complex:
                    self._fd_complex[key] = self._mk_fd_complex(cb, cxf)
                y, hist = self._fd_complex[key](
                    self._spectra,
                    hist,
                    fed,
                    pad(plan.idx_new[sl], nb),
                    pad(plan.w_new[sl], nb),
                    pad(plan.idx_old[sl], nb),
                    pad(plan.w_old[sl], nb),
                    pad(plan.xfade[sl], nb),
                    pad(plan.u_hi[sl], nb),
                    pad(plan.u_lo[sl], nb),
                    pad(plan.inv_frac[sl], nb),
                )
            elif ptype in (ProcessType.TPU_FD_BASIC, ProcessType.CPU_FD_BASIC):
                if cb not in self._fd_basic:
                    self._fd_basic[cb] = self._mk_fd_basic(cb)
                y, hist = self._fd_basic[cb](
                    self._spectra, hist, fed, pad(plan.nearest[sl], nb)
                )
            else:
                if cb not in self._td:
                    self._td[cb] = self._mk_td(cb)
                y, hist = self._td[cb](self._hrirs, hist, fed, pad(plan.nearest[sl], nb))
            flush()
            pending = (start, stop, y)
            if not pipelined:
                flush()
        flush()
        return out
