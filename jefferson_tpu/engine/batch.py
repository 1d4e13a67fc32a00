"""Multi-source batched rendering: vmap over sources, shard over a mesh.

The reference mixes sources serially inside the audio callback (reference:
Jefferson/src/Audio.cu:98-158, one GPUSoundSource per source with its own 8
CUDA streams).  Here sources are a batch axis over the same chunk pipeline,
and the batch shards across devices via a 1-D ``jax.sharding.Mesh`` —
independent streams need no collectives; only the optional mixdown reduces
across the source axis (GSPMD inserts the psum).
"""

from __future__ import annotations

import functools
import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EngineConfig
from ..hrtf.kemar import HRTFDatabase
from .plan import fed_stream, make_plan
from .renderer import _apply_xfade_amortization, _fd_complex_chunk


def batched_chunk_fn(config: EngineConfig, num_blocks: int, with_xfade: bool = True):
    """Source-batched interpolating FD chunk: leading source axis S, shared
    HRTF spectra.

    Signature of the returned function:
      (spectra=(hr, hi), hists (S, hist), feds (S, nb*fpb),
       idx_new (S, nb, 4), w_new, idx_old, w_old, xfade (S, nb),
       u_hi, u_lo, inv_frac (S, nb))
      -> (outs (S, nb, fpb, 2), new_hists (S, hist))

    Not a vmap: after the per-source forward transform, sources x blocks are
    fully independent rows, so the filter core runs on the flattened
    (S*nb, bins) layout — one tall matrix per op instead of S short ones.
    """
    from ..ops import fft as fft_ops
    from .renderer import apply_filters_core, blend_channels

    fpb = config.frames_per_buffer
    if config.history_len % fpb:
        # non-aligned geometry: fall back to the vmapped per-source chunk
        chunk = functools.partial(
            _fd_complex_chunk, config=config, num_blocks=num_blocks,
            backend="matmul", with_xfade=with_xfade,
        )
        return jax.vmap(chunk, in_axes=(None,) + (0,) * 10)

    def fn(spectra, hists, feds, idx_new, w_new, idx_old, w_old, xfade, u_hi, u_lo, inv_frac):
        s = hists.shape[0]
        streams = jnp.concatenate([hists, feds], axis=1)
        new_hists = streams[:, num_blocks * fpb :]
        xr, xi = fft_ops.rfft_sliding_split_batched(
            streams, num_blocks, fpb, config.pad_len
        )
        flat = lambda a: a.reshape((s * num_blocks,) + a.shape[2:])
        if with_xfade:
            # per-source extended blend: old[b] == new[b-1] by construction
            idx_ext = jnp.concatenate([idx_old[:, :1], idx_new], axis=1)
            w_ext = jnp.concatenate([w_old[:, :1], w_new], axis=1)
            rows = s * (num_blocks + 1)
            g = blend_channels(
                spectra, idx_ext.reshape(rows, 4), w_ext.reshape(rows, 4)
            )
            g = tuple(a.reshape(s, num_blocks + 1, -1) for a in g)
            g_old = tuple(flat(a[:, :num_blocks]) for a in g)
            g_new = tuple(flat(a[:, 1:]) for a in g)
        else:
            g_new = blend_channels(spectra, flat(idx_new), flat(w_new))
            g_old = None
        out = apply_filters_core(
            flat(xr),
            flat(xi),
            g_old,
            g_new,
            flat(xfade),
            flat(u_hi),
            flat(u_lo),
            flat(inv_frac),
            config=config,
            with_xfade=with_xfade,
        )
        return out.reshape(s, num_blocks, fpb, 2), new_hists

    return fn


def batched_chunk_fn_dedup(config: EngineConfig, num_blocks: int, with_xfade: bool = True):
    """Dedup variant of batched_chunk_fn: the caller pre-deduplicates the
    extended blend rows across ALL sources (scene sources are often static
    or slow), the device blends only the unique rows and broadcasts with a
    row-gather — bit-identical to the direct path (see plan.dedup_rows).

    Signature: (spectra, hists (S, hist), feds, uniq_idx (U, 4),
    uniq_w (U, 4), inv (S, nb+1|nb) int32, xfade, u_hi, u_lo, inv_frac)
    -> (outs (S, nb, fpb, 2), new_hists).
    """
    from ..ops import fft as fft_ops
    from .renderer import apply_filters_core, blend_cat, cat_table, split_planes

    fpb = config.frames_per_buffer
    assert config.history_len % fpb == 0, "dedup path needs aligned geometry"

    def fn(spectra, hists, feds, uniq_idx, uniq_w, inv, xfade, u_hi, u_lo, inv_frac):
        s = hists.shape[0]
        streams = jnp.concatenate([hists, feds], axis=1)
        new_hists = streams[:, num_blocks * fpb :]
        xr, xi = fft_ops.rfft_sliding_split_batched(
            streams, num_blocks, fpb, config.pad_len
        )
        flat = lambda a: a.reshape((s * num_blocks,) + a.shape[2:])
        g_cat = blend_cat(cat_table(spectra), uniq_idx, uniq_w)  # (U, 4*bins)
        g = split_planes(jnp.take(g_cat, inv.reshape(-1), axis=0), config.num_bins)
        if with_xfade:
            g = tuple(a.reshape(s, num_blocks + 1, -1) for a in g)
            g_old = tuple(flat(a[:, :num_blocks]) for a in g)
            g_new = tuple(flat(a[:, 1:]) for a in g)
        else:
            g_old, g_new = None, g
        out = apply_filters_core(
            flat(xr), flat(xi), g_old, g_new,
            flat(xfade), flat(u_hi), flat(u_lo), flat(inv_frac),
            config=config, with_xfade=with_xfade,
        )
        return out.reshape(s, num_blocks, fpb, 2), new_hists

    return fn


def mix_sources(outs: jax.Array) -> jax.Array:
    """(S, nb, fpb, 2) per-source stereo -> (nb, fpb, 2) mixed (summed, like
    the reference's output accumulation, reference: Jefferson/src/Audio.cu:109)."""
    return jnp.sum(outs, axis=0)


# Blocks per compiled chunk when the caller does not pin one.
DEFAULT_CHUNK_BLOCKS = 512


class BatchRenderer:
    """Render S concurrent independent source streams, optionally sharded.

    signals: (S, n) float32 — one mono stream per source.
    plans: per-source RenderPlans with identical num_blocks.
    mesh: optional 1-D jax Mesh; the source axis is sharded across it.
    """

    def __init__(
        self,
        db: HRTFDatabase,
        config: EngineConfig | None = None,
        chunk_blocks: int | None = None,
        mesh: Mesh | None = None,
        mix: bool = False,
        dedup: bool = True,
        # overlap chunk i+1's dispatch with chunk i's output fetch (see
        # renderer.Renderer pipeline_fetch — same contract: bit-identical
        # output and ordering)
        pipeline_fetch: bool = False,
    ):
        """``chunk_blocks``: blocks per compiled chunk (None = DEFAULT_CHUNK_BLOCKS)."""
        self.db = db
        self.config = config or db.config
        if chunk_blocks is not None and chunk_blocks < 1:
            raise ValueError(f"chunk_blocks ({chunk_blocks}) must be positive")
        self.chunk_blocks = DEFAULT_CHUNK_BLOCKS if chunk_blocks is None else chunk_blocks
        if mesh is not None and len(mesh.axis_names) != 1:
            # the shard planning below uses mesh.size as the SOURCE shard
            # count, which is only the source-axis extent on a 1-D mesh
            raise ValueError(
                f"BatchRenderer needs a 1-D source mesh, got axes {mesh.axis_names}"
            )
        self.mesh = mesh
        self.mix = mix
        self.pipeline_fetch = pipeline_fetch
        aligned = self.config.history_len % self.config.frames_per_buffer == 0
        self.dedup = dedup and aligned
        self._spectra = (
            jnp.asarray(np.real(db.spectra).astype(np.float32)),
            jnp.asarray(np.imag(db.spectra).astype(np.float32)),
        )
        self._jitted = {}

    def _get_fn(self, nb: int, dedup_key=None, xf=True):
        # ``xf``: per-chunk crossfade variant — crossfade-free chunks (hold
        # scenes past chunk 0, steady-state steps) compile the no-crossfade
        # program: half the tail-IDFT MACs, no old-side rows.
        key = (nb, dedup_key, xf)
        if key not in self._jitted:
            if dedup_key is None:
                fn = batched_chunk_fn(self.config, nb, with_xfade=xf)
            else:
                fn = batched_chunk_fn_dedup(self.config, nb, with_xfade=xf)
            if self.mix:
                inner = fn

                def mixed(spectra, *args):
                    outs, hists = inner(spectra, *args)
                    return mix_sources(outs), hists

                fn = mixed
            self._jitted[key] = jax.jit(fn)
        return self._jitted[key]

    def _shard(self, x: np.ndarray) -> jax.Array:
        if self.mesh is None:
            return jnp.asarray(x)
        if np.shape(x)[0] % self.mesh.size:
            # a mesh that does not divide the leading axis cannot shard it
            # evenly (jax rejects the uneven device_put) — replicate
            return jax.device_put(x, NamedSharding(self.mesh, P()))
        axis = self.mesh.axis_names[0]
        spec = P(axis, *([None] * (np.ndim(x) - 1)))
        return jax.device_put(x, NamedSharding(self.mesh, spec))

    def _replicate(self, x: np.ndarray) -> jax.Array:
        if self.mesh is None:
            return jnp.asarray(x)
        return jax.device_put(x, NamedSharding(self.mesh, P()))

    def render(self, signals: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """signals (S, n); positions (S, B, 3) -> (S, B*fpb, 2) or mixed (B*fpb, 2)."""
        cfg = self.config
        fpb = cfg.frames_per_buffer
        signals = np.asarray(signals, dtype=np.float32)
        positions = np.asarray(positions)
        s, b_total = positions.shape[0], positions.shape[1]
        plans = [make_plan(positions[i], cfg) for i in range(s)]
        cb = self.chunk_blocks
        b_real = b_total
        if b_total % cb:
            # pad the final partial chunk to the fixed chunk size (output
            # trimmed at return): every distinct partial size would mint its
            # own programs, retained in self._jitted — in a daemon serving
            # varied durations that is a compile per novel b_total % cb.
            # The single-source Renderer already pads its final chunk.
            from .plan import pad_plan

            pad_b = cb - (b_total % cb)
            plans = [pad_plan(p, pad_b) for p in plans]
            b_total += pad_b
        feds = np.stack([fed_stream(signals[i], b_total, cfg) for i in range(s)])
        hists = self._shard(np.zeros((s, cfg.history_len), np.float32))

        # cross-source static-segment dedup: one Upad bucket per render
        # (see engine/plan.dedup_rows; bit-identical to the direct path)
        dedup_chunks = None
        if self.dedup:
            from .plan import dedup_rows

            dedup_chunks, max_u = [], 1
            for start in range(0, b_total, cb):
                stop = min(start + cb, b_total)
                sl = slice(start, stop)
                ei = np.concatenate(
                    [np.stack([p.idx_old[start : start + 1] for p in plans], 0),
                     np.stack([p.idx_new[sl] for p in plans], 0)], axis=1,
                )  # (S, nb+1, 4)
                ew = np.concatenate(
                    [np.stack([p.w_old[start : start + 1] for p in plans], 0),
                     np.stack([p.w_new[sl] for p in plans], 0)], axis=1,
                )
                rows = ei.shape[0] * ei.shape[1]
                uniq_idx, uniq_w, inv = dedup_rows(
                    ei.reshape(rows, 4), ew.reshape(rows, 4)
                )
                max_u = max(max_u, uniq_idx.shape[0])
                dedup_chunks.append((uniq_idx, uniq_w, inv.reshape(ei.shape[:2])))
            u_pad = max(8, 1 << int(np.ceil(np.log2(max_u))))
            if u_pad * 2 > s * (min(cb, b_total) + 1):
                dedup_chunks = None

        # per-chunk crossfade flags under the renderer's shared amortization
        # guard (a lone crossfade-free chunk is not worth a second compile)
        chunk_xfs = _apply_xfade_amortization([
            bool(any(p.xfade[st : min(st + cb, b_total)].any()
                     for p in plans))
            for st in range(0, b_total, cb)
        ])

        outs = []
        # pipelined output fetch (opt-in): one chunk deep, like
        # renderer.render_plan — `outs` slots are appended at fetch time so
        # ordering is preserved
        pending = None

        def flush():
            nonlocal pending
            if pending is not None:
                outs.append(np.asarray(pending))
                pending = None

        for ci, start in enumerate(range(0, b_total, cb)):
            stop = min(start + cb, b_total)
            nb = stop - start
            sl = slice(start, stop)
            args = dict(
                fed=feds[:, start * fpb : stop * fpb],
                xfade=np.stack([p.xfade[sl] for p in plans]),
                u_hi=np.stack([p.u_hi[sl] for p in plans]),
                u_lo=np.stack([p.u_lo[sl] for p in plans]),
                inv_frac=np.stack([p.inv_frac[sl] for p in plans]),
            )
            cxf = chunk_xfs[ci]
            if dedup_chunks is not None:
                uniq_idx, uniq_w, inv = dedup_chunks[ci]
                if uniq_idx.shape[0] < u_pad:
                    reps = u_pad - uniq_idx.shape[0]
                    uniq_idx = np.concatenate([uniq_idx, np.repeat(uniq_idx[-1:], reps, 0)])
                    uniq_w = np.concatenate([uniq_w, np.repeat(uniq_w[-1:], reps, 0)])
                fn = self._get_fn(nb, dedup_key=u_pad, xf=cxf)
                sharded = {k: self._shard(v) for k, v in args.items()}
                y, hists = fn(
                    self._spectra,
                    hists,
                    sharded["fed"],
                    self._replicate(uniq_idx),
                    self._replicate(uniq_w),
                    # extended rows for the crossfade program, NEW rows
                    # ([:, 1:]) for the no-crossfade one
                    self._shard(inv if cxf else np.ascontiguousarray(inv[:, 1:])),
                    sharded["xfade"],
                    sharded["u_hi"],
                    sharded["u_lo"],
                    sharded["inv_frac"],
                )
            else:
                fn = self._get_fn(nb, xf=cxf)
                args.update(
                    idx_new=np.stack([p.idx_new[sl] for p in plans]),
                    w_new=np.stack([p.w_new[sl] for p in plans]),
                    idx_old=np.stack([p.idx_old[sl] for p in plans]),
                    w_old=np.stack([p.w_old[sl] for p in plans]),
                )
                sharded = {k: self._shard(v) for k, v in args.items()}
                y, hists = fn(
                    self._spectra,
                    hists,
                    sharded["fed"],
                    sharded["idx_new"],
                    sharded["w_new"],
                    sharded["idx_old"],
                    sharded["w_old"],
                    sharded["xfade"],
                    sharded["u_hi"],
                    sharded["u_lo"],
                    sharded["inv_frac"],
                )
            flush()
            pending = y
            if not self.pipeline_fetch:
                flush()
        flush()
        if self.mix:
            return np.concatenate(outs, axis=0).reshape(b_total * fpb, 2)[: b_real * fpb]
        return np.concatenate(outs, axis=1).reshape(s, b_total * fpb, 2)[:, : b_real * fpb]
