"""Precision pins and backend parity: what holds the oracle gate on a GPU.

On a GPU an fp32 product left at ``Precision.DEFAULT`` may run in TF32
(about three decimal digits), far outside the reference's 2e-7 gate
(precision_test.cu:2158).  The jaxpr of every chunk program and of the live
block step must therefore carry ``Precision.HIGHEST`` on each contraction —
checked here without a GPU.  The matmul (split-plane DFT) and fft (cuFFT on
the GPU) formulations must agree through every engine entry point.
"""

import functools

import numpy as np
import pytest

import jax
import jax.extend.core
import jax.numpy as jnp

from jefferson_tpu.engine import batch as batch_mod
from jefferson_tpu.engine import renderer as rmod
from jefferson_tpu.engine import stream as stream_mod
from jefferson_tpu.engine.plan import make_plan
from jefferson_tpu.testing import precision_check
from jefferson_tpu.trajectory.trajectory import AzimuthSweep, CircularOrbit

_CONTRACTIONS = ("dot_general", "conv_general_dilated")
_HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def contraction_precisions(jaxpr) -> list:
    """(primitive, precision, operand dtype) of every contraction in
    ``jaxpr``, nested jaxprs (jit, scan, custom rules) included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _CONTRACTIONS:
            found.append((eqn.primitive.name, eqn.params.get("precision"),
                          str(eqn.invars[0].aval.dtype)))
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                found.extend(contraction_precisions(sub))
    return found


def _is_highest(precision) -> bool:
    if precision is None:
        return False
    if isinstance(precision, (tuple, list)):
        return all(p == _HIGHEST for p in precision)
    return precision == _HIGHEST


@functools.lru_cache(maxsize=None)
def _example(nb: int = 4, s: int = 2):
    from jefferson_tpu import DEFAULT_CONFIG, synthetic_database

    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    plans = [make_plan(CircularOrbit(period_s=0.3 + 0.1 * i, ele=5, r=1.0)
                       .sample(nb, cfg), cfg) for i in range(s)]
    return cfg, db, plans


def _planes(db):
    return (jnp.asarray(np.real(db.spectra).astype(np.float32)),
            jnp.asarray(np.imag(db.spectra).astype(np.float32)))


def _single_args(backend="matmul"):
    cfg, db, plans = _example()
    p = plans[0]
    spectra = jnp.asarray(db.spectra) if backend == "fft" else _planes(db)
    hist = jnp.zeros(cfg.history_len, jnp.float32)
    fed = jnp.zeros(p.num_blocks * cfg.frames_per_buffer, jnp.float32)
    return cfg, spectra, hist, fed, p


def _trace_fd_complex(backend, xf):
    cfg, spectra, hist, fed, p = _single_args(backend)
    fn = functools.partial(rmod._fd_complex_chunk, config=cfg, num_blocks=p.num_blocks,
                           backend=backend, with_xfade=xf)
    return jax.make_jaxpr(fn)(spectra, hist, fed, p.idx_new, p.w_new, p.idx_old,
                              p.w_old, p.xfade, p.u_hi, p.u_lo, p.inv_frac)


def _trace_fd_dedup(xf):
    from jefferson_tpu.engine.plan import dedup_rows

    cfg, spectra, hist, fed, p = _single_args()
    ext_i = np.concatenate([p.idx_old[:1], p.idx_new])
    ext_w = np.concatenate([p.w_old[:1], p.w_new])
    ui, uw, inv = dedup_rows(ext_i, ext_w)
    fn = functools.partial(rmod._fd_complex_chunk_dedup, config=cfg,
                           num_blocks=p.num_blocks, with_xfade=xf)
    return jax.make_jaxpr(fn)(spectra, hist, fed, ui, uw, inv if xf else inv[1:],
                              p.xfade, p.u_hi, p.u_lo, p.inv_frac)


def _trace_fd_basic(backend):
    cfg, spectra, hist, fed, p = _single_args(backend)
    fn = functools.partial(rmod._fd_basic_chunk, config=cfg, num_blocks=p.num_blocks,
                           backend=backend)
    return jax.make_jaxpr(fn)(spectra, hist, fed, p.nearest)


def _trace_td():
    cfg, db, plans = _example()
    p = plans[0]
    fn = functools.partial(rmod._td_chunk, config=cfg, num_blocks=p.num_blocks)
    return jax.make_jaxpr(fn)(jnp.asarray(db.hrirs), jnp.zeros(cfg.history_len),
                              jnp.zeros(p.num_blocks * cfg.frames_per_buffer), p.nearest)


def _trace_batched(xf, dedup):
    from jefferson_tpu.engine.plan import dedup_rows

    cfg, db, plans = _example()
    nb, s = plans[0].num_blocks, len(plans)
    st = lambda a: np.stack([getattr(p, a) for p in plans])
    hists = jnp.zeros((s, cfg.history_len), jnp.float32)
    feds = jnp.zeros((s, nb * cfg.frames_per_buffer), jnp.float32)
    tail = (st("xfade"), st("u_hi"), st("u_lo"), st("inv_frac"))
    if dedup:
        ei = np.concatenate([st("idx_old")[:, :1], st("idx_new")], axis=1)
        ew = np.concatenate([st("w_old")[:, :1], st("w_new")], axis=1)
        ui, uw, inv = dedup_rows(ei.reshape(-1, 4), ew.reshape(-1, 4))
        inv = inv.reshape(s, nb + 1)
        fn = batch_mod.batched_chunk_fn_dedup(cfg, nb, with_xfade=xf)
        args = (ui, uw, inv if xf else inv[:, 1:]) + tail
    else:
        fn = batch_mod.batched_chunk_fn(cfg, nb, with_xfade=xf)
        args = (st("idx_new"), st("w_new"), st("idx_old"), st("w_old")) + tail
    return jax.make_jaxpr(fn)(_planes(db), hists, feds, *args)


def _trace_block_step(xf):
    cfg, db, plans = _example()
    p = plans[0]
    hist = jnp.zeros(cfg.history_len, jnp.float32)
    blk = jnp.zeros(cfg.frames_per_buffer, jnp.float32)
    sr, si = _planes(db)
    if xf:
        fn = functools.partial(stream_mod._block_step, config=cfg)
        return jax.make_jaxpr(fn)(sr, si, hist, blk, p.idx_new[0], p.w_new[0],
                                  p.idx_old[0], p.w_old[0], True, p.u_hi[0],
                                  p.u_lo[0], p.inv_frac[0])
    fn = functools.partial(stream_mod._block_step_noxf, config=cfg)
    return jax.make_jaxpr(fn)(sr, si, hist, blk, p.idx_new[0], p.w_new[0],
                              p.u_hi[0], p.u_lo[0], p.inv_frac[0])


def _trace_scan():
    cfg, db, plans = _example()
    p = plans[0]
    sr, si = _planes(db)
    blocks = jnp.zeros((p.num_blocks, cfg.frames_per_buffer), jnp.float32)
    return jax.make_jaxpr(
        lambda *a: stream_mod._scan_render(*a, config=cfg)
    )(sr, si, blocks, p.idx_new, p.w_new, p.idx_old, p.w_old, p.xfade,
      p.u_hi, p.u_lo, p.inv_frac)


def _trace_reverb_grouped():
    from jefferson_tpu.reverb.convolution import _spectral_conv_grouped

    a = jnp.zeros((8, 5), jnp.float32)
    return jax.make_jaxpr(lambda *x: _spectral_conv_grouped(*x, j_rows=4))(
        a, a, a[:4], a[:4])


def _trace_streaming_convolver():
    from jefferson_tpu.reverb.convolution import StreamingConvolver

    sc = StreamingConvolver(np.ones(64, np.float32) * 0.1, partition=32)
    return jax.make_jaxpr(sc._step_fn)(
        sc._ring_r, sc._ring_i, sc._hr, sc._hi,
        jnp.zeros(sc.fft_size, jnp.float32), sc._overlap)


_PROGRAMS = {
    "fd_complex_matmul_xfade": lambda: _trace_fd_complex("matmul", True),
    "fd_complex_matmul_noxfade": lambda: _trace_fd_complex("matmul", False),
    "fd_complex_fft_xfade": lambda: _trace_fd_complex("fft", True),
    "fd_complex_fft_noxfade": lambda: _trace_fd_complex("fft", False),
    "fd_dedup_xfade": lambda: _trace_fd_dedup(True),
    "fd_dedup_noxfade": lambda: _trace_fd_dedup(False),
    "fd_basic_matmul": lambda: _trace_fd_basic("matmul"),
    "td": _trace_td,
    "batched_xfade": lambda: _trace_batched(True, False),
    "batched_noxfade": lambda: _trace_batched(False, False),
    "batched_dedup_xfade": lambda: _trace_batched(True, True),
    "batched_dedup_noxfade": lambda: _trace_batched(False, True),
    "live_block_step": lambda: _trace_block_step(True),
    "live_block_step_noxfade": lambda: _trace_block_step(False),
    "scan_render": _trace_scan,
    "reverb_grouped_conv": _trace_reverb_grouped,
    "streaming_convolver": _trace_streaming_convolver,
}


# the fft backend's only former contraction (the complex HRTF blend) is a
# multiply-add now, so its programs contract nothing
_NO_CONTRACTION = {"fd_complex_fft_xfade", "fd_complex_fft_noxfade"}


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_every_contraction_is_highest(name):
    """Each chunk program, the live block step and the reverb contract at
    Precision.HIGHEST (no TF32 on a GPU), on real operands only."""
    found = contraction_precisions(_PROGRAMS[name]().jaxpr)
    if name not in _NO_CONTRACTION:
        assert found, f"{name}: no contraction traced — the pin check would be vacuous"
    loose = [f for f in found if not _is_highest(f[1])]
    assert not loose, f"{name}: contractions below HIGHEST: {loose}"
    cplx = [f for f in found if f[2].startswith("complex")]
    assert not cplx, f"{name}: complex contractions: {cplx}"


def test_precision_scan_sees_a_loose_contraction():
    """The jaxpr walk itself: an unpinned product inside a jit is found."""
    inner = jax.jit(lambda a, b: a @ b)
    found = contraction_precisions(
        jax.make_jaxpr(lambda a, b: inner(a, b) + 1)(jnp.ones((2, 2)), jnp.ones((2, 2))).jaxpr)
    assert len(found) == 1 and not _is_highest(found[0][1])


@pytest.mark.parametrize("n", [1024, 15])
def test_irfft_reads_only_the_real_edge_bins(n):
    """The fft backend's C2R ignores the imaginary parts of the DC and
    (even n) Nyquist bins, as the oracle's and the matmul basis do; cuFFT
    would read them.  Every other bin's imaginary part still counts."""
    from jefferson_tpu.ops import fft as fft_ops

    bins = n // 2 + 1
    rng = np.random.default_rng(n)
    spec = (rng.standard_normal((3, bins)) + 1j * rng.standard_normal((3, bins))
            ).astype(np.complex64)
    edges = [0, bins - 1] if n % 2 == 0 else [0]
    base = np.asarray(fft_ops.irfft(jnp.asarray(spec), n))
    bumped = spec.copy()
    bumped[:, edges] += 5j
    np.testing.assert_array_equal(np.asarray(fft_ops.irfft(jnp.asarray(bumped), n)), base)
    np.testing.assert_allclose(base, np.fft.irfft(spec, n), atol=1e-6)
    interior = spec.copy()
    interior[:, 1] += 5j
    assert np.abs(np.asarray(fft_ops.irfft(jnp.asarray(interior), n)) - base).max() > 1e-3


# --- matmul vs fft through every engine ----------------------------------------

def _trajectory(kind, blocks, config):
    if kind == "mover":
        return CircularOrbit(period_s=0.3, ele=5, r=1.0).sample(blocks, config)
    if kind == "hold":
        return np.tile(np.array([40.0, 10.0, 0.8]), (blocks, 1))
    if kind == "cadence":  # the reference benchmark's hold-then-step shape
        return AzimuthSweep(start_azi=3, ele=5, r=0.5, step_deg=5,
                            blocks_per_step=8, num_steps=blocks // 8).sample(blocks, config)
    rng = np.random.default_rng(5)  # "jumps": a new random direction per block
    return np.stack([rng.uniform(0, 360, blocks), rng.uniform(-40, 90, blocks),
                     rng.uniform(0.3, 2.0, blocks)], axis=1)


def _engine_render(engine, db, config, sig, pos):
    from jefferson_tpu.engine.batch import BatchRenderer
    from jefferson_tpu.engine.renderer import Renderer
    from jefferson_tpu.engine.stream import StreamingSpatializer

    if engine == "Renderer":
        return Renderer(db, config, chunk_blocks=16).render(sig, pos)
    if engine == "BatchRenderer":
        return BatchRenderer(db, config, chunk_blocks=16).render(sig[None], pos[None])[0]
    sp = StreamingSpatializer(db, config)
    sp.buf = sig
    outs = []
    for azi, ele, r in pos:
        sp.set_position(azi=azi, ele=ele, r=r)
        outs.append(sp.process_next())
    return np.concatenate(outs)


@pytest.mark.parametrize("kind", ["mover", "hold", "cadence", "jumps"])
@pytest.mark.parametrize("engine", ["Renderer", "BatchRenderer", "StreamingSpatializer"])
def test_matmul_engines_match_fft_backend(db, config, castanets, engine, kind):
    """Each matmul-form engine entry point agrees with the complex64 fft
    backend (cuFFT on the GPU) at the reference's 2e-7 gate."""
    from jefferson_tpu.engine.renderer import Renderer

    blocks = 32
    sig = castanets[: blocks * config.frames_per_buffer]
    pos = _trajectory(kind, blocks, config)
    want = Renderer(db, config, chunk_blocks=16, backend="fft").render(sig, pos)
    got = _engine_render(engine, db, config, sig, pos)
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, f"{engine}/{kind}: {rep}"


# --- the compile cache ------------------------------------------------------------

def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache lands there, nowhere else."""
    from jefferson_tpu.cli.main import COMPILE_CACHE_DIR, enable_compilation_cache

    before = jax.config.jax_compilation_cache_dir
    target = tmp_path / "xla"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    try:
        assert enable_compilation_cache() == str(target)
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir()
        assert str(COMPILE_CACHE_DIR) != str(target)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    """Unset: one fixed directory inside the checkout, listed in .gitignore."""
    from pathlib import Path

    from jefferson_tpu.cli.main import COMPILE_CACHE_DIR, enable_compilation_cache

    repo = Path(__file__).resolve().parents[1]
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert enable_compilation_cache() == str(COMPILE_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == str(COMPILE_CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert COMPILE_CACHE_DIR.parent == repo
    ignored = (repo / ".gitignore").read_text().split()
    assert f"{COMPILE_CACHE_DIR.name}/" in ignored
