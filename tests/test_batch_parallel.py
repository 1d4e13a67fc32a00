"""Multi-source batching + mesh sharding tests (8 virtual CPU devices)."""

import numpy as np
import pytest

import jax

from jefferson_tpu.engine.batch import BatchRenderer
from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.parallel.mesh import make_mesh, source_sharding
from jefferson_tpu.testing import precision_check
from jefferson_tpu.trajectory.trajectory import CircularOrbit, StaticPosition


def _mk_batch(config, castanets, s=4, blocks=24):
    rng = np.random.default_rng(8)
    signals = np.stack([np.roll(castanets, 1000 * i)[:8000] for i in range(s)])
    trajs = [
        StaticPosition(azi=30 * i, ele=5 * i - 10, r=0.8 + 0.2 * i).sample(blocks, config)
        if i % 2
        else CircularOrbit(period_s=0.5 + 0.2 * i, ele=5, r=1.0).sample(blocks, config)
        for i in range(s)
    ]
    return signals, np.stack(trajs)


def test_batch_matches_single_source(db, config, castanets):
    signals, positions = _mk_batch(config, castanets)
    br = BatchRenderer(db, chunk_blocks=16)
    got = br.render(signals, positions)
    single = Renderer(db, chunk_blocks=16)
    for i in range(signals.shape[0]):
        want = single.render(signals[i], positions[i])
        rep = precision_check(got[i], want, eps=1e-6)
        assert rep.ok, f"source {i}: {rep}"


def test_mixdown(db, config, castanets):
    signals, positions = _mk_batch(config, castanets, s=3)
    sep = BatchRenderer(db, chunk_blocks=16).render(signals, positions)
    mixed = BatchRenderer(db, chunk_blocks=16, mix=True).render(signals, positions)
    rep = precision_check(mixed, sep.sum(axis=0), eps=1e-6)
    assert rep.ok, str(rep)


def test_sharded_batch_matches_unsharded(db, config, castanets):
    """8 sources sharded over the 8-device virtual CPU mesh == single device."""
    assert len(jax.devices()) == 8
    signals, positions = _mk_batch(config, castanets, s=8, blocks=16)
    mesh = make_mesh(8)
    got = BatchRenderer(db, chunk_blocks=16, mesh=mesh).render(signals, positions)
    want = BatchRenderer(db, chunk_blocks=16).render(signals, positions)
    rep = precision_check(got, want, eps=1e-7)
    assert rep.ok, str(rep)


def test_sharded_mixdown_collective(db, config, castanets):
    """Mixdown over a sharded source axis exercises the GSPMD reduction."""
    signals, positions = _mk_batch(config, castanets, s=8, blocks=16)
    mesh = make_mesh(8)
    got = BatchRenderer(db, chunk_blocks=16, mesh=mesh, mix=True).render(signals, positions)
    want = BatchRenderer(db, chunk_blocks=16, mix=True).render(signals, positions)
    rep = precision_check(got, want, eps=1e-6)
    assert rep.ok, str(rep)


def test_batch_renderer_rejects_2d_mesh(db):
    """BatchRenderer's shard planning reads mesh.size as the SOURCE shard
    count, which only holds on the documented 1-D mesh — a 2-D mesh must be
    rejected up front, not silently mis-plan sparse cf buckets."""
    import pytest

    mesh2 = make_mesh(8, ("src", "blk"))
    with pytest.raises(ValueError, match="1-D source mesh"):
        BatchRenderer(db, mesh=mesh2)


def test_batch_default_chunk_size(db):
    """chunk_blocks=None takes the module default; an explicit size pins
    every render, and a non-positive one is refused."""
    import pytest

    from jefferson_tpu.engine.batch import DEFAULT_CHUNK_BLOCKS

    assert BatchRenderer(db).chunk_blocks == DEFAULT_CHUNK_BLOCKS == 512
    assert BatchRenderer(db, chunk_blocks=128).chunk_blocks == 128
    with pytest.raises(ValueError, match="positive"):
        BatchRenderer(db, chunk_blocks=0)


def test_mesh_utilities():
    mesh = make_mesh(8)
    assert mesh.shape == {"src": 8}
    mesh2 = make_mesh(8, ("src", "blk"))
    assert mesh2.shape["src"] * mesh2.shape["blk"] == 8
    sh = source_sharding(mesh, 3)
    assert sh.spec == jax.sharding.PartitionSpec("src", None, None)


def test_2d_mesh_src_and_blk_sharding(db, config, castanets):
    """Both mesh axes at once: sources AND time blocks sharded over a 2-D
    ('src','blk') mesh match the unsharded render exactly."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jefferson_tpu.engine.batch import batched_chunk_fn
    from jefferson_tpu.engine.plan import fed_stream, make_plan

    s, nb = 4, 16
    signals, positions = _mk_batch(config, castanets, s=s, blocks=nb)
    plans = [make_plan(positions[i], config) for i in range(s)]
    feds = np.stack([fed_stream(signals[i], nb, config) for i in range(s)])
    spectra = (
        jnp.asarray(np.real(db.spectra).astype(np.float32)),
        jnp.asarray(np.imag(db.spectra).astype(np.float32)),
    )
    hists = np.zeros((s, config.history_len), np.float32)
    stack = lambda attr: np.stack([getattr(p, attr) for p in plans])
    args = [feds, stack("idx_new"), stack("w_new"), stack("idx_old"),
            stack("w_old"), stack("xfade"), stack("u_hi"), stack("u_lo"),
            stack("inv_frac")]

    fn = jax.jit(batched_chunk_fn(config, num_blocks=nb, with_xfade=True))
    want, _ = fn(spectra, jnp.asarray(hists), *[jnp.asarray(a) for a in args])

    mesh = make_mesh(8, ("src", "blk"))
    def shard(x):
        axes = ["src"] + [None] * (x.ndim - 1)
        if x.ndim >= 2:
            axes[1] = "blk"
        return jax.device_put(x, NamedSharding(mesh, P(*axes)))

    got, _ = fn(
        spectra,
        jax.device_put(hists, NamedSharding(mesh, P("src", None))),
        *[shard(np.asarray(a)) for a in args],
    )
    rep = precision_check(np.asarray(got), np.asarray(want), eps=1e-7)
    assert rep.ok, str(rep)


def test_ensure_virtual_devices_noop():
    """With enough devices present, ensure_virtual_devices returns in-process."""
    from jefferson_tpu.parallel.mesh import ensure_virtual_devices

    ensure_virtual_devices(8)  # conftest provisions 8 virtual CPU devices
    assert len(jax.devices()) == 8


def test_xla_flags_device_count_replacement():
    """The shared scrub-and-set helper REPLACES any inherited count flag and
    preserves unrelated flags (an inherited different count must not win)."""
    from jefferson_tpu.parallel.mesh import xla_flags_with_device_count

    out = xla_flags_with_device_count(
        "--xla_foo=1 --xla_force_host_platform_device_count=2 --xla_bar", 8
    )
    parts = out.split()
    assert "--xla_force_host_platform_device_count=8" in parts
    assert "--xla_force_host_platform_device_count=2" not in parts
    assert "--xla_foo=1" in parts and "--xla_bar" in parts
    # count-flag occurrences collapse to exactly one
    assert sum("xla_force_host_platform_device_count" in p for p in parts) == 1
    # empty input yields just the flag
    assert xla_flags_with_device_count("", 4).split() == [
        "--xla_force_host_platform_device_count=4"
    ]


def test_make_mesh_validation_and_factorization():
    """make_mesh rejects bad device counts / axis ranks and factors 2-D
    meshes near-square (6 devices -> 2x3, never 1x6)."""
    import pytest
    from jefferson_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="must be >= 1"):
        make_mesh(0)
    with pytest.raises(ValueError, match="must be >= 1"):
        make_mesh(-2)
    with pytest.raises(ValueError, match="have"):
        make_mesh(len(jax.devices()) + 1)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        make_mesh(8, ("a", "b", "c"))
    mesh = make_mesh(6, ("src", "blk"))
    assert mesh.devices.shape == (2, 3)
    assert make_mesh(8, ("src", "blk")).devices.shape == (2, 4)
    # prime counts degrade to 1 x n rather than failing
    assert make_mesh(7, ("src", "blk")).devices.shape == (1, 7)


def test_replicated_sharding_spec():
    """replicated() replicates every axis; source_sharding shards only the
    leading axis."""
    from jax.sharding import PartitionSpec as P

    from jefferson_tpu.parallel.mesh import make_mesh, replicated, source_sharding

    mesh = make_mesh(8)
    assert replicated(mesh).spec == P()
    assert source_sharding(mesh, 3).spec == P("src", None, None)


def test_block_axis_sharding(db, config, castanets):
    """One render's blocks sharded over the mesh ('sp'-style): GSPMD handles
    the sliding-window halo between block shards; output matches unsharded."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import functools

    from jefferson_tpu.engine.renderer import _fd_complex_chunk
    from jefferson_tpu.engine.plan import fed_stream, make_plan

    nb = 64
    pos = CircularOrbit(period_s=0.7, ele=5, r=1.0).sample(nb, config)
    plan = make_plan(pos, config)
    fed = fed_stream(castanets, nb, config)
    spectra = (
        jnp.asarray(np.real(db.spectra).astype(np.float32)),
        jnp.asarray(np.imag(db.spectra).astype(np.float32)),
    )
    hist = jnp.zeros(config.history_len, jnp.float32)
    fn = jax.jit(
        functools.partial(
            _fd_complex_chunk, config=config, num_blocks=nb, backend="matmul", with_xfade=True
        )
    )
    args = [
        jnp.asarray(fed), jnp.asarray(plan.idx_new), jnp.asarray(plan.w_new),
        jnp.asarray(plan.idx_old), jnp.asarray(plan.w_old), jnp.asarray(plan.xfade),
        jnp.asarray(plan.u_hi), jnp.asarray(plan.u_lo), jnp.asarray(plan.inv_frac),
    ]
    want, _ = fn(spectra, hist, *args)

    mesh = make_mesh(8, ("blk",))
    shard = lambda x: jax.device_put(
        x, NamedSharding(mesh, P("blk", *([None] * (x.ndim - 1))))
    )
    sharded = [shard(a) for a in args]
    got, _ = fn(spectra, hist, *sharded)
    rep = precision_check(np.asarray(got), np.asarray(want), eps=1e-7)
    assert rep.ok, str(rep)


def test_renderer_block_mesh_production_path(db, config, castanets):
    """Round-4 productization: Renderer(mesh=...) shards one render's
    time-block axis over the mesh (the CLI's `--devices N` single-source
    path) and matches the unsharded render; dedup and mover dispatches both
    covered."""
    from jefferson_tpu.engine.renderer import Renderer
    from jefferson_tpu.trajectory.trajectory import AzimuthSweep

    mesh = make_mesh(8, ("blk",))
    for traj in (
        CircularOrbit(period_s=0.4, ele=5, r=1.0),          # mover: direct path
        AzimuthSweep(start_azi=0, ele=0, r=0.5, step_deg=5,
                     blocks_per_step=16, num_steps=2),       # holds: dedup path
    ):
        pos = traj.sample(48, config)
        want = Renderer(db, config, chunk_blocks=16).render(
            castanets, pos
        )
        got = Renderer(db, config, chunk_blocks=16, mesh=mesh).render(
            castanets, pos
        )
        rep = precision_check(got, want, eps=1e-7)
        assert rep.ok, str(rep)
    # invalid geometries are rejected up front
    import pytest

    with pytest.raises(ValueError, match="divide evenly"):
        Renderer(db, config, chunk_blocks=12, mesh=mesh)
    with pytest.raises(ValueError, match="1-D"):
        Renderer(db, config, mesh=make_mesh(8, ("src", "blk")))


def test_cli_devices_flag(db, config, castanets, tmp_path, monkeypatch):
    """`--devices N` reaches the mesh from the CLI for both the scene
    (source axis) and single-source (block axis) forms (round-4 verdict:
    'today a user cannot reach the mesh')."""
    import json

    import jefferson_tpu.cli.main as cli_main
    from jefferson_tpu.io.wavio import read_wav, write_wav

    monkeypatch.setattr(cli_main, "load_hrtf", lambda *a, **k: db)
    wav = tmp_path / "in.wav"
    write_wav(wav, castanets[:4096, None].repeat(2, 1), config.sample_rate)

    scene = {"sources": [
        {"input": str(wav), "trajectory": f"orbit:period=0.5,start={i*45}"}
        for i in range(8)
    ]}
    scene_path = tmp_path / "scene.json"
    scene_path.write_text(json.dumps(scene))
    out = tmp_path / "scene.wav"
    rc = cli_main.main(["--scene", str(scene_path), "-o", str(out),
                        "--blocks", "16", "--chunk-blocks", "16",
                        "--devices", "8", "--quiet", "--float", "--bits", "32"])
    assert rc == 0
    got, _ = read_wav(out)
    # sharded scene mix == unsharded scene mix
    out2 = tmp_path / "scene1.wav"
    rc = cli_main.main(["--scene", str(scene_path), "-o", str(out2),
                        "--blocks", "16", "--chunk-blocks", "16",
                        "--quiet", "--float", "--bits", "32"])
    assert rc == 0
    want, _ = read_wav(out2)
    rep = precision_check(got, want, eps=1e-6)
    assert rep.ok, str(rep)

    out3 = tmp_path / "single.wav"
    rc = cli_main.main(["-i", str(wav), "-o", str(out3), "--blocks", "16",
                        "--chunk-blocks", "16", "--devices", "8",
                        "--trajectory", "orbit:period=0.5", "--quiet", "--float", "--bits", "32"])
    assert rc == 0
    got3, _ = read_wav(out3)
    assert np.isfinite(got3).all() and got3.shape[0] == 16 * 128

    # a non-divisible scene source count auto-shrinks instead of failing
    assert cli_main.scene_mesh(6, 8, quiet=True).size == 6
    assert cli_main.scene_mesh(9, 8, quiet=True).size == 3
    assert cli_main.scene_mesh(8, 1) is None


def _static_batch(config, castanets, s=4, blocks=16):
    """A scene whose sources hold positions (the dedup-friendly common case:
    reference Audio.cu:98-158 drives persistent per-source positions)."""
    signals = np.stack([np.roll(castanets, 500 * i)[:4000] for i in range(s)])
    trajs = [
        StaticPosition(azi=25 * i, ele=10 * (i % 3) - 10, r=0.6 + 0.1 * i).sample(blocks, config)
        for i in range(s)
    ]
    return signals, np.stack(trajs)


def test_batch_dedup_matches_direct(db, config, castanets):
    """The batch dedup program (position-holding sources) matches the
    direct program, and the dedup program is the one that ran."""
    signals, positions = _static_batch(config, castanets)
    dedup = BatchRenderer(db, chunk_blocks=16)
    got = dedup.render(signals, positions)
    want = BatchRenderer(db, chunk_blocks=16, dedup=False).render(signals, positions)
    rep = precision_check(got, want, eps=1e-7)
    assert rep.ok, str(rep)
    assert all(k[1] is not None for k in dedup._jitted), list(dedup._jitted)


def test_batch_dedup_sharded(db, config, castanets):
    """The dedup program over the 8-device source mesh == one device."""
    signals, positions = _static_batch(config, castanets, s=8)
    mesh = make_mesh(8)
    got = BatchRenderer(db, chunk_blocks=16, mesh=mesh).render(signals, positions)
    want = BatchRenderer(db, chunk_blocks=16).render(signals, positions)
    rep = precision_check(got, want, eps=1e-7)
    assert rep.ok, str(rep)


def _wide_scene(config, castanets, s=8, blocks=16, seed=11):
    """Many sources spread over the full sphere, all moving: a wide
    cross-source unique-filter set, so dedup cannot pay."""
    rng = np.random.default_rng(seed)
    signals = np.stack([np.roll(castanets, 300 * i)[:4000] for i in range(s)])
    trajs = []
    for i in range(s):
        azi0 = rng.uniform(0, 360)
        ele = rng.uniform(-40, 85)
        trajs.append(
            CircularOrbit(period_s=1.0 + 0.1 * i, ele=ele, r=1.0, start_azi=azi0
                          ).sample(blocks, config)
        )
    return signals, np.stack(trajs)


def _gate_each_source(db, config, signals, positions, got, eps=2e-7):
    from jefferson_tpu.oracle.reference import render_oracle

    for i in range(signals.shape[0]):
        want = render_oracle(signals[i], db, [tuple(p) for p in positions[i]], config)
        rep = precision_check(got[i], want, eps=eps)
        assert rep.ok, f"source {i}: {rep}"


def test_batch_wide_scene(db, config, castanets):
    """A scene whose sources span the whole sphere takes the direct batch
    program and holds the oracle gate per source."""
    signals, positions = _wide_scene(config, castanets)
    br = BatchRenderer(db, chunk_blocks=16)
    got = br.render(signals, positions)
    assert all(k[1] is None for k in br._jitted), list(br._jitted)
    _gate_each_source(db, config, signals, positions, got)


def test_batch_wide_scene_sharded(db, config, castanets):
    """The wide scene sharded by source over the mesh == one device."""
    signals, positions = _wide_scene(config, castanets, s=16)
    mesh = make_mesh(8)
    got = BatchRenderer(db, chunk_blocks=16, mesh=mesh).render(signals, positions)
    want = BatchRenderer(db, chunk_blocks=16).render(signals, positions)
    rep = precision_check(got, want, eps=1e-7)
    assert rep.ok, str(rep)


def test_batch_nonpow2_chunk(db, config, castanets):
    """A chunk size that is not a power of two (24 blocks) renders a wide
    scene on the oracle."""
    signals, positions = _wide_scene(config, castanets, s=4, blocks=24)
    got = BatchRenderer(db, chunk_blocks=24).render(signals, positions)
    _gate_each_source(db, config, signals, positions, got)


def test_partial_final_chunk_compiles_one_program(db, config, castanets):
    """A render whose length does not divide the chunk size PADS the final
    chunk (output trimmed): distinct partial sizes used to mint a fresh
    program each (the daemon compile/RSS leak class), and the padded
    render must be bit-identical to the unpadded reference."""
    signals, positions = _wide_scene(config, castanets, s=4, blocks=24)
    br = BatchRenderer(db, chunk_blocks=16, dedup=False)
    out = br.render(signals, positions)  # 24 = 16 + 8 -> padded to 32
    assert out.shape == (4, 24 * config.frames_per_buffer, 2)
    # only full-size (nb=16) programs were compiled
    assert all(k[0] == 16 for k in br._jitted), list(br._jitted)
    # bit-identical to manually padding the render to 32 blocks the same
    # way (repeat the final position; the feed continues wrapping) and
    # trimming — i.e. the pad+trim mechanics add nothing of their own
    pos_pad = np.concatenate(
        [positions, np.repeat(positions[:, -1:], 8, axis=1)], axis=1
    )
    ref = BatchRenderer(db, chunk_blocks=16, dedup=False).render(
        signals, pos_pad
    )[:, : 24 * config.frames_per_buffer]
    np.testing.assert_array_equal(out, ref)


def test_explicit_large_chunk(db, config, castanets):
    """An explicit chunk larger than the render (512 over 512 blocks of
    two alternating holds) renders finite, oracle-gated output."""
    s, b = 2, 512
    pos = np.empty((s, b, 3))
    for k in range(s):
        pos[k, :, 0] = np.where((np.arange(b) // 64) % 2 == 0, 30.0 + 5 * k, 35.0 + 5 * k)
        pos[k, :, 1] = 0.0
        pos[k, :, 2] = 1.0
    sigs = np.stack([castanets[: b * 128], np.roll(castanets, 500)[: b * 128]])
    out = BatchRenderer(db, config, chunk_blocks=512).render(sigs, pos)
    assert out.shape == (s, b * 128, 2) and np.isfinite(out).all()
    _gate_each_source(db, config, sigs, pos, out)


def test_sharded_wide_movers(db, config, castanets):
    """Random full-sphere movers sharded over the 8-device mesh == one
    device."""
    rng = np.random.default_rng(11)
    s, nb = 8, 16
    signals = np.stack(
        [castanets[: nb * config.frames_per_buffer] for _ in range(s)]
    )
    positions = np.stack([
        np.stack([rng.uniform(0, 360, nb), rng.uniform(-40, 90, nb),
                  np.full(nb, 1.0)], axis=1)
        for _ in range(s)
    ]).astype(np.float32)
    mesh = make_mesh(8)
    got = BatchRenderer(db, chunk_blocks=nb, mesh=mesh).render(signals, positions)
    want = BatchRenderer(db, chunk_blocks=nb).render(signals, positions)
    rep = precision_check(got, want, eps=1e-7)
    assert rep.ok, str(rep)


def test_ensure_virtual_devices_child_marker(monkeypatch):
    """The re-exec'd child branch: with the marker set and the count already
    satisfiable it forces the CPU platform in place; an unsatisfiable count
    fails loudly instead of silently under-sharding."""
    import os

    import pytest

    from jefferson_tpu.parallel import mesh as m

    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setenv("JT_VIRTUAL_MESH", "1")
    m.ensure_virtual_devices(8)  # conftest's backend already has 8 devices
    assert (
        "--xla_force_host_platform_device_count=8"
        in os.environ["XLA_FLAGS"].split()
    )
    # the backend initialized with 8 devices, so a late 16 must raise
    with pytest.raises(RuntimeError, match="initialized before"):
        m.ensure_virtual_devices(16)


def test_ensure_virtual_devices_reexec_command_and_env(monkeypatch):
    """Too few devices, no marker: the helper re-execs sys.argv in a child
    configured for the virtual mesh — count flag REPLACED, platform forced,
    marker set, `python -m` package context preserved — and exits with the
    child's return code."""
    import sys
    import types

    import __main__
    import pytest

    from jefferson_tpu.parallel import mesh as m

    calls = {}

    def fake_call(cmd, env=None):
        calls["cmd"], calls["env"] = list(cmd), dict(env)
        return 7

    monkeypatch.setattr(m.subprocess, "call", fake_call)
    monkeypatch.delenv("JT_VIRTUAL_MESH", raising=False)
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_foo=1 --xla_force_host_platform_device_count=8"
    )

    monkeypatch.setattr(
        __main__, "__spec__", types.SimpleNamespace(name="some.module"),
        raising=False,
    )
    with pytest.raises(SystemExit) as ei:
        m.ensure_virtual_devices(16)
    assert ei.value.code == 7
    assert calls["cmd"][:3] == [sys.executable, "-m", "some.module"]
    env = calls["env"]
    assert env["JT_VIRTUAL_MESH"] == "1"
    assert env["JAX_PLATFORMS"] == "cpu"
    flags = env["XLA_FLAGS"].split()
    assert "--xla_force_host_platform_device_count=16" in flags
    assert "--xla_force_host_platform_device_count=8" not in flags
    assert "--xla_foo=1" in flags  # unrelated flags survive

    # plain-script invocation (no __spec__): re-exec sys.argv directly
    monkeypatch.setattr(__main__, "__spec__", None, raising=False)
    with pytest.raises(SystemExit):
        m.ensure_virtual_devices(16)
    assert calls["cmd"] == [sys.executable] + sys.argv


def test_batch_unaligned_geometry_vmap_fallback(castanets):
    """history_len % fpb != 0: the batched chunk fn takes the vmapped
    per-source fallback (no shared sliding DFT) and stays exact against the
    single-source renderer on the same geometry."""
    from jefferson_tpu import EngineConfig, synthetic_database

    cfg = EngineConfig(frames_per_buffer=96, hrtf_len=256)  # hist 416 % 96 != 0
    assert cfg.history_len % cfg.frames_per_buffer != 0
    db96 = synthetic_database(cfg, n_taps=256, seed=9)
    s, blocks = 2, 12
    signals = np.stack([np.roll(castanets, 500 * i)[:4000] for i in range(s)])
    positions = np.stack([
        CircularOrbit(period_s=0.4 + 0.1 * i, ele=5, r=1.0).sample(blocks, cfg)
        for i in range(s)
    ])
    got = BatchRenderer(db96, cfg, chunk_blocks=6).render(signals, positions)
    single = Renderer(db96, cfg, chunk_blocks=6)
    for i in range(s):
        want = single.render(signals[i], positions[i])
        rep = precision_check(got[i], want, eps=1e-7)
        assert rep.ok, f"source {i}: {rep}"


def test_batch_render_mesh_not_dividing_sources(db, config, castanets):
    """A 1-D source mesh that does NOT divide the source count degrades to
    the planned XLA path with replicated operands instead of crashing in
    device_put (round-5 review: the uneven shard was a ValueError)."""
    s, blocks = 6, 8
    signals = np.stack([np.roll(castanets, 900 * i)[:4000] for i in range(s)])
    positions = np.stack([
        StaticPosition(azi=15 * i, ele=0, r=1.0).sample(blocks, config)
        for i in range(s)
    ])
    br = BatchRenderer(db, config, chunk_blocks=8, mesh=make_mesh(4, ("src",)))
    got = br.render(signals, positions)
    single = Renderer(db, config, chunk_blocks=8)
    for i in range(s):
        rep = precision_check(got[i], single.render(signals[i], positions[i]),
                              eps=1e-6)
        assert rep.ok, f"source {i}: {rep}"


def test_renderer_short_render_keeps_block_mesh_chunk_even(db, config, castanets):
    """A render shorter than chunk_blocks on a block mesh pads the chunk up
    to a mesh multiple (round-5 review: cb=min(chunk, b_total) silently
    replicated every per-block operand when b_total % mesh != 0) and stays
    within the parity gates."""
    mesh = make_mesh(4, ("blk",))
    pos = CircularOrbit(period_s=0.5, ele=5, r=1.0).sample(13, config)  # 13 % 4 != 0
    got = Renderer(db, config, chunk_blocks=16, mesh=mesh).render(castanets, pos)
    want = Renderer(db, config, chunk_blocks=16).render(castanets, pos)
    rep = precision_check(got, want, eps=1e-7)
    assert rep.ok, str(rep)


def test_bench_step_matches_oracle(db, config):
    """bench.py's step at CI scale: the batched chunk function on orbiting
    sources, source 0 against the oracle."""
    import jax.numpy as jnp

    from jefferson_tpu.engine.batch import batched_chunk_fn
    from jefferson_tpu.engine.plan import make_plan
    from jefferson_tpu.oracle.reference import render_oracle

    s, nb = 4, 16
    rng = np.random.default_rng(7)
    pos = [CircularOrbit(period_s=0.4 + 0.01 * i, ele=5, r=1.0).sample(nb, config)
           for i in range(s)]
    plans = [make_plan(p, config) for p in pos]
    feds = (rng.standard_normal((s, nb * config.frames_per_buffer)) * 0.2
            ).astype(np.float32)
    spectra = (
        jnp.asarray(np.real(db.spectra).astype(np.float32)),
        jnp.asarray(np.imag(db.spectra).astype(np.float32)),
    )
    stack = lambda attr: jnp.asarray(np.stack([getattr(p, attr) for p in plans]))
    step = jax.jit(batched_chunk_fn(config, num_blocks=nb, with_xfade=True))
    out, hists = step(
        spectra, jnp.zeros((s, config.history_len), jnp.float32), jnp.asarray(feds),
        stack("idx_new"), stack("w_new"), stack("idx_old"), stack("w_old"),
        stack("xfade"), stack("u_hi"), stack("u_lo"), stack("inv_frac"),
    )
    got = np.asarray(out[0]).reshape(-1, 2)
    want = render_oracle(feds[0], db, [tuple(p) for p in pos[0]], config)
    rep = precision_check(got, want, eps=2e-7)
    assert rep.ok, str(rep)
    np.testing.assert_array_equal(
        np.asarray(hists), feds[:, -config.history_len:])


def _sharded_program_hlo(br, signals, positions) -> str:
    """Optimized HLO of the first chunk program a render dispatched."""
    captured = []
    get_fn = br._get_fn

    def spy(*a, **k):
        fn = get_fn(*a, **k)

        def call(*args):
            captured.append((fn, args))
            return fn(*args)

        return call

    br._get_fn = spy
    br.render(signals, positions)
    fn, args = captured[0]
    return fn.lower(*args).compile().as_text()


def _collectives(hlo: str) -> dict:
    import re

    counts = {}
    for op in re.findall(r"\b(all-reduce|all-gather|reduce-scatter|collective-permute"
                         r"|all-to-all)(?:-start)?\(", hlo):
        counts[op] = counts.get(op, 0) + 1
    return counts


@pytest.mark.parametrize("hold", [True, False], ids=["dedup", "direct"])
@pytest.mark.parametrize("mix", [True, False], ids=["mixdown", "per_source"])
def test_source_mesh_collectives(db, config, castanets, mix, hold):
    """The source-sharded scene program: the mixdown is exactly one
    all-reduce, and the per-source path moves nothing between devices."""
    s = 8
    if hold:
        signals, positions = _static_batch(config, castanets, s=s)
    else:
        signals, positions = _wide_scene(config, castanets, s=s)
    br = BatchRenderer(db, chunk_blocks=16, mesh=make_mesh(4), mix=mix)
    counts = _collectives(_sharded_program_hlo(br, signals, positions))
    assert counts == ({"all-reduce": 1} if mix else {}), counts
