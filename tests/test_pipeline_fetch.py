"""Pipelined output fetch (``Renderer(pipeline_fetch=True)``).

The opt-in chunk-loop pipelining dispatches chunk i+1 before fetching chunk
i's output, so compute and device->host transfer overlap.  With the same
programs, call order and operands, pipelined output is BIT-IDENTICAL to
sync output — which is what these tests pin.
"""

import numpy as np
import pytest

from jefferson_tpu import ProcessType
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.trajectory.trajectory import AzimuthSweep, CircularOrbit


def _mover(config, blocks=48):
    return CircularOrbit(period_s=0.3, ele=5, r=1.0).sample(blocks, config)


def _holder(config, blocks=48):
    """Positions persist across blocks -> the dedup path."""
    return AzimuthSweep(
        start_azi=0, ele=0, r=0.5, step_deg=5.0, blocks_per_step=16, num_steps=3
    ).sample(blocks, config)


@pytest.mark.parametrize(
    "kw,pos_fn",
    [
        ({}, _holder),                  # dedup arm
        ({"dedup": False}, _mover),     # direct arm
        ({}, _mover),                   # default on a mover (direct)
        ({"dedup": False}, _holder),    # direct arm, crossfade-free chunks
        ({"backend": "fft"}, _mover),   # complex64 fft arm
        ({"backend": "fft"}, _holder),  # fft arm, crossfade-free chunks
    ],
)
def test_pipelined_bit_identical(db, config, castanets, kw, pos_fn):
    """No-failure pipelining runs the same programs on the same operands in
    the same order as sync mode -> bit-identical, incl. a partial final
    chunk (40 blocks over cb=16)."""
    sig = castanets[:8000]
    pos = pos_fn(config, blocks=40)
    want = Renderer(db, chunk_blocks=16, **kw).render(sig, pos)
    got = Renderer(db, chunk_blocks=16, pipeline_fetch=True, **kw).render(sig, pos)
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "ptype", [ProcessType.TPU_FD_BASIC, ProcessType.TPU_TD]
)
def test_pipelined_bit_identical_basic_td(db, config, castanets, ptype):
    sig = castanets[:8000]
    pos = _mover(config, blocks=40)
    want = Renderer(db, chunk_blocks=16).render(sig, pos, ptype)
    got = Renderer(db, chunk_blocks=16, pipeline_fetch=True).render(sig, pos, ptype)
    assert np.array_equal(got, want)


def test_pipelined_mesh_bit_identical(db, config, castanets):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs >= 2 virtual devices")
    mesh = Mesh(np.array(devs[:2]), ("blk",))
    sig = castanets[:8000]
    pos = _mover(config, blocks=40)
    want = Renderer(db, chunk_blocks=16, mesh=mesh).render(sig, pos)
    got = Renderer(db, chunk_blocks=16, mesh=mesh, pipeline_fetch=True).render(
        sig, pos
    )
    assert np.array_equal(got, want)


def _scene(config, s=4, blocks=40, hold=True):
    if hold:
        pos = np.stack([
            AzimuthSweep(start_azi=10 * i, ele=0, r=0.5, step_deg=5.0,
                         blocks_per_step=16, num_steps=3).sample(blocks, config)
            for i in range(s)
        ])
    else:
        pos = np.stack([
            CircularOrbit(period_s=0.2 + 0.1 * i, ele=5, r=1.0).sample(blocks, config)
            for i in range(s)
        ])
    return pos


@pytest.mark.parametrize(
    "kw,hold",
    [
        ({}, True),                     # dedup batch arm
        ({"dedup": False}, False),      # direct batch arm
        ({}, False),                    # default on movers (direct)
        ({"dedup": False}, True),       # direct batch arm on holds
    ],
)
def test_batch_pipelined_bit_identical(db, config, castanets, kw, hold):
    from jefferson_tpu.engine.batch import BatchRenderer

    s, blocks = 4, 40
    rng = np.random.default_rng(3)
    sigs = np.stack([castanets[:8000]] * s) * rng.uniform(0.5, 1.0, (s, 1))
    pos = _scene(config, s, blocks, hold)
    want = BatchRenderer(db, chunk_blocks=8, **kw).render(sigs, pos)
    got = BatchRenderer(db, chunk_blocks=8, pipeline_fetch=True, **kw).render(
        sigs, pos
    )
    assert np.array_equal(got, want)


def test_batch_pipelined_mesh_bit_identical(db, config, castanets):
    import jax
    from jax.sharding import Mesh

    from jefferson_tpu.engine.batch import BatchRenderer

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs >= 4 virtual devices")
    mesh = Mesh(np.array(devs[:4]), ("src",))
    s = 8
    sigs = np.stack([castanets[:8000]] * s)
    pos = _scene(config, s, 40, hold=True)
    want = BatchRenderer(db, chunk_blocks=8, mesh=mesh, mix=True).render(sigs, pos)
    got = BatchRenderer(
        db, chunk_blocks=8, mesh=mesh, mix=True, pipeline_fetch=True
    ).render(sigs, pos)
    assert np.array_equal(got, want)


def test_cli_pipeline_fetch_bit_identical(tmp_path, castanets):
    """--pipeline-fetch reaches Renderer and changes nothing audible."""
    from jefferson_tpu.cli.main import main as cli_main
    from jefferson_tpu.io.wavio import read_wav, write_wav

    src = tmp_path / "in.wav"
    write_wav(src, castanets[:8000], 44100, bits=24)
    common = ["-i", str(src), "--blocks", "20", "--chunk-blocks", "16",
              "--trajectory", "orbit:period=1,r=1", "--quiet", "--float",
              "--bits", "32"]
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    assert cli_main(["-o", str(a)] + common) == 0
    assert cli_main(["-o", str(b), "--pipeline-fetch"] + common) == 0
    ya, _ = read_wav(a)
    yb, _ = read_wav(b)
    assert np.array_equal(ya, yb)
