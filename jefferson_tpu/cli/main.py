"""jefferson — offline/streaming binaural render CLI.

The reference's app surface is ``-t <0-5> -i in.wav -r reverb.wav -o out.wav``
(reference: Jefferson/src/main.cu:22-58) plus a GLUT window moving the
source.  This CLI keeps those flags, replaces the realtime/graphics loop
with trajectory-driven offline rendering, and promotes the reference's
compile-time switches (reverb on/off, HRTF dir, block count) to options.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jefferson",
        description="binaural spatializer (file-to-file)",
    )
    from .. import __version__

    p.add_argument("--version", action="version",
                   version=f"jefferson_tpu {__version__}")
    p.add_argument("-t", "--type", type=int, default=0, choices=range(6),
                   help="process type: 0=accelerator FD interpolating, 1=accelerator "
                        "FD nearest, 2=accelerator time-domain, 3/4/5=CPU oracle "
                        "equivalents (default 0)")
    p.add_argument("-i", "--input", default=None, help="input WAV (mono or stereo; downmixed)")
    p.add_argument("--scene", default=None,
                   help="multi-source scene JSON: {\"sources\": [{\"input\": WAV, "
                        "\"trajectory\": SPEC, \"gain\": 1.0}, …]} — sources are "
                        "rendered concurrently (vmapped) and mixed like the "
                        "reference's per-source accumulation (Audio.cu:98-158)")
    p.add_argument("-r", "--reverb", default=None, help="reverb impulse-response WAV (mono)")
    p.add_argument("-o", "--output", default="ofile.wav", help="output WAV (default ofile.wav)")
    p.add_argument("--reverb-backend", choices=["host", "tpu"], default="host",
                   help="host = one-shot scipy FFT (fast preprocessing default); "
                        "tpu = partitioned accelerator convolution (GPU)")
    p.add_argument("--reverb-mode", choices=["off", "reference", "linear"], default="off",
                   help="off (reference default reverbFlag=false), reference "
                        "(circular wrap + RMS renorm), or linear convolution")
    p.add_argument("--hrtf-dir", default=None,
                   help="HRTF database: a KEMAR dir (full or compact layout) or "
                        "a SOFA (.sofa) file; default: $JEFFERSON_HRTF_DIR, "
                        "else a deterministic synthetic set")
    p.add_argument("--trajectory", default="static:azi=0,ele=0,r=0.5",
                   help="trajectory spec: static:azi=A,ele=E,r=R | "
                        "orbit:period=P,ele=E,r=R[,start=A] | "
                        "sweep:start=A,step=S,blocks=N,steps=K[,ele=E,r=R] | "
                        "path:x0,y0,z0:x1,y1,z1:duration | events:FILE.json")
    p.add_argument("--blocks", type=int, default=None,
                   help="number of 128-sample blocks (default: one pass of the input)")
    p.add_argument("--duration", type=float, default=None, help="render length in seconds")
    p.add_argument("--bits", type=int, default=24, choices=[16, 24, 32],
                   help="output PCM depth (default 24, the reference's format)")
    p.add_argument("--float", action="store_true", help="write float32 WAV instead of PCM")
    p.add_argument("--backend", choices=["matmul", "fft"], default="matmul")
    p.add_argument("--pipeline-fetch", action="store_true",
                   help="overlap chunk compute with output fetch (single-"
                        "source renders; bit-identical output)")
    p.add_argument("--chunk-blocks", type=int, default=None,
                   help="blocks per compiled chunk (default: 2048 single-"
                        "source, 512 for scenes)")
    p.add_argument("--device", choices=["native", "cpu"], default="native",
                   help="'cpu' forces the host CPU platform even where JAX "
                        "would boot an accelerator")
    p.add_argument("--devices", type=int, default=None,
                   help="shard the render over N devices of a jax.sharding.Mesh: "
                        "--scene shards the SOURCE axis (data-parallel streams, "
                        "auto-shrunk to a divisor of the source count); "
                        "single-source renders shard the TIME-BLOCK axis "
                        "('sp'-style, XLA path). Default: one device")
    p.add_argument("--initial-old", default="0,0",
                   help="crossfade state before block 0 as 'azi,ele' (reference "
                        "constructor default 0,0) or 'none' to disable")
    p.add_argument("--viz", action="store_true",
                   help="write <output>.scene.svg and <output>.wave.svg "
                        "(the offline analogue of the reference's GL window)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the render into this dir")
    p.add_argument("--no-resample", action="store_true",
                   help="feed wrong-rate inputs raw (pitch-shifted) like the reference")
    p.add_argument("--selftest", action="store_true",
                   help="run a SCALED engine-vs-oracle smoke gate before rendering "
                        "(all 4 scenarios of the reference's always-on "
                        "benchmarkTesting, main.cu:88, at 8 blocks x 12 steps "
                        "instead of 172 x 72); aborts on mismatch")
    p.add_argument("--selftest-full", action="store_true",
                   help="run the reference's FULL benchmarkTesting workload "
                        "(4 scenarios x 73 positions x 172 blocks) before "
                        "rendering; equivalent to python -m jefferson_tpu.bench.sweep")
    p.add_argument("--quiet", action="store_true")
    return p


def parse_trajectory(spec: str):
    """Trajectory spec string -> Trajectory.

    Raises ValueError on malformed specs — NOT SystemExit: this parser is
    shared with the render daemon (scene sources), whose per-request
    handler catches Exception; a SystemExit would escape it and silently
    drop the client connection with no error reply.  CLI call sites
    convert to SystemExit themselves."""
    from ..trajectory.trajectory import (
        AzimuthSweep,
        CircularOrbit,
        LinearPath,
        PositionEvents,
        StaticPosition,
    )

    kind, _, rest = spec.partition(":")

    def kv(defaults):
        out = dict(defaults)
        if rest:
            for item in rest.split(","):
                k, _, v = item.partition("=")
                if k not in out:
                    raise ValueError(f"unknown trajectory parameter {k!r} for {kind!r}")
                try:
                    out[k] = float(v)
                except ValueError:
                    raise ValueError(
                        f"trajectory parameter {k!r} for {kind!r} needs a "
                        f"number, got {v!r}"
                    ) from None
        return out

    if kind == "static":
        d = kv({"azi": 0.0, "ele": 0.0, "r": 0.5})
        return StaticPosition(d["azi"], d["ele"], d["r"])
    if kind == "orbit":
        d = kv({"period": 8.0, "ele": 0.0, "r": 1.0, "start": 0.0})
        return CircularOrbit(period_s=d["period"], ele=d["ele"], r=d["r"], start_azi=d["start"])
    if kind == "sweep":
        d = kv({"start": 0.0, "step": 5.0, "blocks": 172, "steps": 72, "ele": 0.0, "r": 0.5})
        return AzimuthSweep(
            start_azi=d["start"], ele=d["ele"], r=d["r"], step_deg=d["step"],
            blocks_per_step=int(d["blocks"]), num_steps=int(d["steps"]),
        )
    if kind == "path":
        parts = rest.split(":")
        if len(parts) != 3:
            raise ValueError("path spec: path:x0,y0,z0:x1,y1,z1:duration")
        try:
            a = tuple(float(v) for v in parts[0].split(","))
            b = tuple(float(v) for v in parts[1].split(","))
            return LinearPath(a, b, float(parts[2]))
        except ValueError:
            raise ValueError(
                f"path spec needs numeric x,y,z:x,y,z:duration, got {rest!r}"
            ) from None
    if kind == "events":
        try:
            events = json.loads(Path(rest).read_text())
        except FileNotFoundError:
            raise ValueError(f"events trajectory file {rest!r} not found") from None
        except json.JSONDecodeError as e:
            raise ValueError(f"events trajectory file {rest!r}: bad JSON: {e}") from None
        return PositionEvents([tuple(e) for e in events])
    raise ValueError(f"unknown trajectory kind {kind!r}")


def load_hrtf(hrtf_dir, config, quiet=False):
    import os

    from ..hrtf.kemar import load_database, synthetic_database

    hrtf_dir = hrtf_dir or os.environ.get("JEFFERSON_HRTF_DIR")
    if hrtf_dir:
        if not Path(hrtf_dir).exists():
            raise SystemExit(
                f"HRTF dir {hrtf_dir!r} does not exist — fetch the MIT KEMAR "
                "set with scripts/fetch_kemar.py or point --hrtf-dir/"
                "$JEFFERSON_HRTF_DIR at an existing full/compact tree"
            )
        return load_database(hrtf_dir, config)
    if not quiet:
        print(
            "warning: no HRTF dir given; using the synthetic test set "
            "(real KEMAR data: scripts/fetch_kemar.py, then --hrtf-dir "
            "or $JEFFERSON_HRTF_DIR)",
            file=sys.stderr,
        )
    return synthetic_database(config)


# The checkout's own compile-cache directory (git-ignored), used when
# JAX_COMPILATION_CACHE_DIR does not name one.  A fixed path: the cache key
# includes it, so a directory that moves never hits.
COMPILE_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str | None:
    """Persist XLA compilations across processes; returns the directory
    (None when it cannot be created).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and no other
    directory is set; otherwise the cache is COMPILE_CACHE_DIR.  A process
    that wants a cold cache points the variable at an empty directory."""
    import os

    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(COMPILE_CACHE_DIR)
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError as e:  # an unwritable directory costs compiles, not the run
        print(f"warning: compile cache off ({cache}: {e})", file=sys.stderr)
        return None
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache


def scene_mesh(num_sources: int, devices: int | None, quiet: bool = True):
    """Build the --devices source mesh for a scene, auto-shrunk to the
    largest device count that divides the source count (a lopsided mesh
    cannot shard the source axis evenly and would replicate it)."""
    if not devices or devices <= 1:
        return None
    from ..parallel.mesh import make_mesh

    n = min(devices, num_sources)
    while num_sources % n:
        n -= 1
    if n != devices and not quiet:
        print(
            f"warning: --devices {devices} shrunk to {n} "
            f"(must divide the {num_sources}-source scene)",
            file=sys.stderr,
        )
    return make_mesh(n, ("src",)) if n > 1 else None


# Bound on the daemon-side scene-renderer cache (see render_scene_spec):
# each entry retains a BatchRenderer and its jit programs, so the cache must
# stay small; 8 covers every realistic (chunk, mesh) working set.
_SCENE_RENDERER_CACHE_MAX = 8


def render_scene_spec(
    scene: dict,
    db,
    config,
    num_blocks: int | None = None,
    duration: float | None = None,
    chunk_blocks: int | None = None,
    quiet: bool = True,
    devices: int | None = None,
    renderer_cache: dict | None = None,
):
    """Render a scene dict ({"sources": [{"input", "trajectory", "gain"}…]})
    into one stereo mix — shared by the CLI and the render daemon.
    ``devices``: shard the source axis over an N-device mesh (auto-shrunk
    to a divisor of the source count; the mixdown is the one all-reduce).
    ``renderer_cache``: long-lived callers (the serve daemon) pass a dict
    so BatchRenderers persist across requests — a fresh instance per
    request re-jits (and retains) every program, measured as per-request
    RSS growth and re-paid compiles under the round-4 daemon soak."""
    from ..engine.batch import BatchRenderer
    from ..engine.plan import fed_stream

    from ..io.wavio import read_wav_mono

    sources = scene.get("sources", [])
    if not sources:
        raise ValueError("scene has no sources")
    if chunk_blocks is not None and chunk_blocks < 1:
        # daemon clients reach here unvalidated (the CLI pre-validates);
        # ValueError becomes a clean per-request error response
        raise ValueError(f"chunk_blocks ({chunk_blocks}) must be positive")
    if num_blocks is not None and int(num_blocks) < 1:
        # explicit blocks=0 (a falsy-but-present request field) must error,
        # not silently render nothing or fall back to the input length
        raise ValueError(f"blocks ({num_blocks}) must be positive")
    if duration is not None and not float(duration) > 0:
        raise ValueError(f"duration ({duration}) must be positive")
    signals, trajs = [], []
    for s in sources:
        sig, sr = read_wav_mono(s["input"])
        if sr != config.sample_rate:
            # resample like the single-source paths do (the old behavior —
            # warn and feed the raw signal — rendered a pitch-shifted,
            # wrong-duration source into the mix, silently via the daemon)
            from ..io.resample import resample

            sig = resample(sig, sr, config.sample_rate)
            if not quiet:
                print(f"resampled {s['input']} {sr} -> {config.sample_rate} Hz",
                      file=sys.stderr)
        if len(sig) == 0:
            raise ValueError(f"scene source {s['input']!r} is empty")
        signals.append(sig * np.float32(s.get("gain", 1.0)))
        trajs.append(parse_trajectory(s["trajectory"]))
    if num_blocks is None:
        if duration is not None:
            num_blocks = int(np.ceil(duration / config.block_duration))
        else:
            num_blocks = max(int(np.ceil(len(s) / config.frames_per_buffer)) for s in signals)
    num_blocks = int(num_blocks)
    feds = np.stack([fed_stream(s, num_blocks, config) for s in signals])
    positions = np.stack([t.sample(num_blocks, config) for t in trajs])
    # quantize the effective chunk to the next power of two >= num_blocks
    # (capped at the request): a bare min(chunk_blocks, num_blocks) minted
    # one cache key — one persistent BatchRenderer + compiled program set —
    # per NOVEL short duration, churning the daemon's 8-entry LRU out of
    # warm entries (round-5 review).  The renderer pads the final chunk,
    # so any cb >= num_blocks is one padded chunk; pow2 quantization
    # bounds both the padding (< 2x) and the key space (log2(chunk)).
    cb = (None if chunk_blocks is None
          else min(chunk_blocks, 1 << max(0, int(np.ceil(np.log2(num_blocks))))))
    mesh = scene_mesh(len(sources), devices, quiet=quiet)
    key = (cb, None if mesh is None else mesh.size)
    if renderer_cache is not None and key in renderer_cache:
        # LRU: move to the back so eviction drops the coldest key
        br = renderer_cache.pop(key)
        renderer_cache[key] = br
    else:
        br = BatchRenderer(db, config, chunk_blocks=cb, mix=True, mesh=mesh)
        if renderer_cache is not None:
            renderer_cache[key] = br
            # bound the daemon-side cache: clients varying chunk_blocks per
            # request would otherwise mint an unbounded set of persistent
            # BatchRenderers (+ retained jit programs) — the round-4 soak's
            # RSS-leak class (round-4 advisor).  dict preserves insertion
            # order, so this evicts least-recently-used.
            while len(renderer_cache) > _SCENE_RENDERER_CACHE_MAX:
                renderer_cache.pop(next(iter(renderer_cache)))
    return br.render(feds, positions).reshape(-1, 2), num_blocks


def render_scene(args, config) -> int:
    """Multi-source render: each source spatialized along its trajectory,
    summed into one stereo mix (per-source gain applied pre-render)."""
    from ..io.wavio import write_wav

    try:
        scene = json.loads(Path(args.scene).read_text())
    except FileNotFoundError:
        raise SystemExit(f"scene file {args.scene!r} not found")
    except json.JSONDecodeError as e:
        raise SystemExit(f"scene file {args.scene!r}: bad JSON: {e}")
    db = load_hrtf(args.hrtf_dir, config, args.quiet)
    t0 = time.time()
    try:
        out, num_blocks = render_scene_spec(
            scene, db, config,
            num_blocks=args.blocks, duration=args.duration,
            chunk_blocks=args.chunk_blocks, quiet=args.quiet,
            devices=args.devices,
        )
    except (ValueError, FileNotFoundError) as e:
        # FileNotFoundError: a scene source or events-trajectory WAV/JSON
        # path — a one-line error like every other scene validation failure
        raise SystemExit(str(e))
    sources = scene["sources"]
    dt = time.time() - t0
    if not np.isfinite(out).all():
        raise SystemExit("ERROR: non-finite samples in render output")
    clip = np.abs(out) > 1.0
    if clip.any():
        print(f"ALERT! CLIPPING AUDIO! ({int(clip.sum())} samples)", file=sys.stderr)
    from ..io.wavio import resolve_float_bits

    write_wav(args.output, out, config.sample_rate,
              bits=resolve_float_bits(args.bits, args.float), float_format=args.float)
    if not args.quiet:
        audio_s = num_blocks * config.block_duration
        print(
            f"scene: {len(sources)} sources, {num_blocks} blocks ({audio_s:.2f}s) in "
            f"{dt:.2f}s = {audio_s/dt:.1f}x real time -> {args.output}",
            file=sys.stderr,
        )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.chunk_blocks is not None and args.chunk_blocks < 1:
        raise SystemExit(
            f"--chunk-blocks {args.chunk_blocks} must be a positive block count"
        )
    # explicit-but-invalid rule (same as the scene/daemon validation): a
    # zero/negative length silently wrote a header-only WAV "successfully"
    if args.blocks is not None and args.blocks < 1:
        raise SystemExit(f"--blocks {args.blocks} must be positive")
    if args.duration is not None and not args.duration > 0:
        raise SystemExit(f"--duration {args.duration} must be positive")
    if args.scene is not None:
        # flags the batched scene pipeline does not implement must error,
        # not silently not-apply (a --scene -r render without reverb was a
        # silent lie)
        dropped = []
        if args.reverb is not None or args.reverb_mode != "off":
            dropped.append("-r/--reverb-mode")
        if args.backend != "matmul":
            dropped.append("--backend")
        if args.no_resample:
            dropped.append("--no-resample")
        if args.viz:
            dropped.append("--viz")
        if args.profile_dir is not None:
            dropped.append("--profile-dir")
        if args.initial_old != "0,0":
            dropped.append("--initial-old")
        if args.selftest or args.selftest_full:
            dropped.append("--selftest/--selftest-full")
        if args.type != 0:
            dropped.append("-t/--type")
        if args.input is not None:
            dropped.append("-i/--input")
        if dropped:
            raise SystemExit(
                f"--scene does not support: {', '.join(dropped)} (scene "
                f"sources render through the batched type-0 pipeline; put "
                f"per-source options in the scene JSON)"
            )
    if args.device == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    enable_compilation_cache()
    from ..config import DEFAULT_CONFIG, ProcessType
    from ..io.wavio import read_wav_mono, write_wav

    config = DEFAULT_CONFIG
    ptype = ProcessType(args.type)

    if args.scene is not None:
        return render_scene(args, config)
    if args.input is None:
        raise SystemExit("missing -i/--input (or --scene)")
    signal, sr = read_wav_mono(args.input)
    if len(signal) == 0:
        raise SystemExit(f"input WAV {args.input!r} is empty")
    if sr != config.sample_rate:
        if args.no_resample:
            print(f"warning: input rate {sr} != engine rate {config.sample_rate}; "
                  "rendering raw (pitch-shifted, the reference's behavior)", file=sys.stderr)
        else:
            from ..io.resample import resample

            signal = resample(signal, sr, config.sample_rate)
            if not args.quiet:
                print(f"resampled input {sr} -> {config.sample_rate} Hz", file=sys.stderr)

    if args.reverb_mode != "off":
        if args.reverb is None:
            raise SystemExit("--reverb-mode requires -r/--reverb")
        ir, ir_sr = read_wav_mono(args.reverb)
        if ir_sr != config.sample_rate and not args.no_resample:
            # same rule as the input signal and the rt loop: a foreign-rate
            # IR convolved raw is a pitch-shifted, wrong-length room
            from ..io.resample import resample

            ir = resample(ir, ir_sr, config.sample_rate)
            if not args.quiet:
                print(f"resampled reverb IR {ir_sr} -> {config.sample_rate} Hz",
                      file=sys.stderr)
        from ..reverb.convolution import convolve_linear, reverb_reference

        t0 = time.time()
        if args.reverb_mode == "reference":
            signal = reverb_reference(signal, ir, config, backend=args.reverb_backend)
        else:
            signal = convolve_linear(signal, ir, config, backend=args.reverb_backend)
        if not args.quiet:
            print(f"reverb ({args.reverb_mode}): {len(ir)}-tap IR in {time.time()-t0:.2f}s",
                  file=sys.stderr)

    try:
        traj = parse_trajectory(args.trajectory)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.blocks is not None:
        num_blocks = args.blocks
    elif args.duration is not None:
        num_blocks = int(np.ceil(args.duration / config.block_duration))
    else:
        num_blocks = int(np.ceil(len(signal) / config.frames_per_buffer))
    positions = traj.sample(num_blocks, config)

    if args.initial_old.lower() == "none":
        initial_old = None
    else:
        try:
            initial_old = tuple(float(v) for v in args.initial_old.split(","))
        except ValueError:
            raise SystemExit(
                f"--initial-old needs 'azi,ele' numbers or 'none', got "
                f"{args.initial_old!r}"
            )
        if len(initial_old) != 2:
            # a 1- or 3-tuple dies deep in make_plan with an unpacking
            # traceback far from the flag that caused it
            raise SystemExit(
                f"--initial-old needs exactly 'azi,ele', got {args.initial_old!r}"
            )

    db = load_hrtf(args.hrtf_dir, config, args.quiet)

    if (args.selftest or args.selftest_full) and not ptype.is_oracle:
        from ..bench.sweep import SCENARIOS, run_benchmark_sweep
        from ..engine.renderer import Renderer as _R

        if args.selftest_full:  # the reference's real workload (main.cu:88)
            from ..bench.sweep import run_mover_gate

            renderer = _R(db, config, backend=args.backend)
            reports = run_benchmark_sweep(
                signal, db, config, blocks_per_step=172, num_steps=72, eps=2e-7,
                renderer=renderer,
            )
            # plus the per-block mover (a crossfade every block)
            reports.append(run_mover_gate(signal, db, config, eps=2e-7,
                                          renderer=renderer))
        else:
            reports = run_benchmark_sweep(
                signal[: 8 * config.frames_per_buffer * 16] if len(signal) else signal,
                db, config, blocks_per_step=8, num_steps=12, eps=2e-7,
                renderer=_R(db, config, chunk_blocks=104, backend=args.backend),
            )
        names = [f"({sa},{se})" for sa, se in SCENARIOS] + ["mover"]
        for name, rep in zip(names, reports):
            if not rep.ok:
                raise SystemExit(f"selftest FAILED at scenario {name}: {rep}")
        if not args.quiet:
            kind = "full benchmarkTesting" if args.selftest_full else "scaled smoke"
            print(f"selftest passed (engine-vs-oracle sweep gate, {kind})", file=sys.stderr)

    import contextlib

    from ..utils.profiling import trace

    prof = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    t0 = time.time()
    with prof:
        if ptype.is_oracle:
            from ..oracle.reference import render_oracle

            out = render_oracle(signal, db, [tuple(p) for p in positions], config, ptype,
                                initial_old=initial_old)
        else:
            from ..engine.renderer import Renderer

            mesh = None
            # resolve the effective chunk size up front so diagnostics can
            # name it (a defaulted flag is None — main() already rejected
            # 0/negative values)
            eff_cb = args.chunk_blocks if args.chunk_blocks is not None else 2048
            if args.devices and args.devices > 1:
                from ..parallel.mesh import make_mesh

                mesh = make_mesh(args.devices, ("blk",))
                if eff_cb % args.devices:
                    flag = ("default" if args.chunk_blocks is None
                            else "--chunk-blocks")
                    raise SystemExit(
                        f"{flag} chunk size {eff_cb} must divide evenly "
                        f"over --devices {args.devices}"
                    )
            r = Renderer(db, config, chunk_blocks=eff_cb,
                         backend=args.backend, mesh=mesh,
                         pipeline_fetch=args.pipeline_fetch)
            out = r.render(signal, positions, ptype, initial_old=initial_old)
    dt = time.time() - t0

    if not np.isfinite(out).all():
        raise SystemExit("ERROR: non-finite samples in render output")
    clip = np.abs(out) > 1.0
    if clip.any():
        print(f"ALERT! CLIPPING AUDIO! ({int(clip.sum())} samples)", file=sys.stderr)

    from ..io.wavio import resolve_float_bits

    write_wav(args.output, out, config.sample_rate,
              bits=resolve_float_bits(args.bits, args.float), float_format=args.float)
    if args.viz:
        from ..viz.html import scene_html
        from ..viz.scene import scene_svg, waveform_svg
        from ..viz.scene3d import scene3d_html

        scene_svg(positions, f"{args.output}.scene.svg", config=config)
        waveform_svg(out, f"{args.output}.wave.svg")
        scene_html(positions, out, f"{args.output}.html", config=config,
                   title=f"jefferson_tpu — {Path(args.output).name}")
        scene3d_html(positions, out, f"{args.output}.3d.html", config=config,
                     title=f"jefferson_tpu — {Path(args.output).name} (3-D)")
        if not args.quiet:
            print(f"viz: {args.output}.scene.svg, {args.output}.wave.svg, "
                  f"{args.output}.html, {args.output}.3d.html", file=sys.stderr)
    if not args.quiet:
        audio_s = num_blocks * config.block_duration
        print(
            f"{ptype.name}: {num_blocks} blocks ({audio_s:.2f}s audio) in {dt:.2f}s "
            f"= {audio_s/dt:.1f}x real time -> {args.output}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
