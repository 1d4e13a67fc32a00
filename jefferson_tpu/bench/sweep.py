"""The reference's benchmarkTesting as a library: engine-vs-oracle sweep gate.

Reference semantics (reference: Jefferson/src/precision_test.cu:2093-2201):
four scenarios (azi, ele) in {(0,0),(3,0),(0,5),(3,5)}; each renders
``blocks_per_step`` blocks at the start position, then ``num_steps`` rounds
of azimuth += 5 (wrapping at 360), comparing the interpolating engine
against the CPU oracle at eps=2e-7, with crossfade state starting from
old=(0,0) like the reference's reset.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig, ProcessType
from ..engine.renderer import Renderer
from ..hrtf.kemar import HRTFDatabase
from ..oracle.reference import render_oracle, render_oracle_many
from ..testing import PrecisionReport, precision_check
from ..trajectory.trajectory import AzimuthSweep

SCENARIOS = [(0.0, 0.0), (3.0, 0.0), (0.0, 5.0), (3.0, 5.0)]

# headroom warning threshold: the reference gate is eps=2e-7; once the worst
# scenario uses more than this fraction of it, a contraction-order change is
# one step from failing the gate (PERF.md records the measured margins)
MARGIN_WARN = 0.95


def mover_positions(num_blocks: int, ele_period: int = 997) -> np.ndarray:
    """Per-block mover for the gate's 5th scenario: azimuth orbits ~1.3 deg
    per block (a crossfade EVERY block) while elevation sweeps the full
    -40..90 grid, touching all four interpolation cases and hundreds of
    unique filters per chunk.

    The reference's four benchmarkTesting scenarios hold each position for
    172 blocks, so they exercise only the dedup dispatch; this scenario
    pins the direct (every-block crossfade) chunk program under the same
    full-scale oracle gate."""
    i = np.arange(num_blocks)
    azi = (i * 1.3) % 360.0
    ele = 25.0 + 65.0 * np.sin(i * (2.0 * np.pi / ele_period))
    return np.stack([azi, ele, np.full(num_blocks, 0.5)], axis=1)


def run_mover_gate(
    signal: np.ndarray,
    db: HRTFDatabase,
    config: EngineConfig = DEFAULT_CONFIG,
    num_blocks: int = 12556,
    eps: float = 2e-7,
    renderer: Renderer | None = None,
) -> PrecisionReport:
    """Engine-vs-oracle gate on the per-block mover trajectory."""
    renderer = renderer or Renderer(db, config)
    pos = mover_positions(num_blocks)
    got = renderer.render(signal, pos, ProcessType.TPU_FD_COMPLEX, initial_old=(0.0, 0.0))
    want = render_oracle(
        signal, db, [tuple(p) for p in pos], config, initial_old=(0.0, 0.0)
    )
    return precision_check(got, want, eps=eps)


def scene_hold_positions(
    num_sources: int, num_blocks: int, blocks_per_step: int = 172
) -> np.ndarray:
    """(S, B, 3) multi-source scene whose sources each HOLD positions for
    ``blocks_per_step`` blocks (the reference's benchmarkTesting cadence,
    precision_test.cu:2093-2148) at staggered start azimuths/elevations —
    the production scene shape that forces the batch dedup dispatch
    (engine/batch.batched_chunk_fn_dedup)."""
    i = np.arange(num_blocks)
    step = i // blocks_per_step
    eles = [0.0, 10.0, -20.0, 40.0]
    pos = np.empty((num_sources, num_blocks, 3), np.float64)
    for s in range(num_sources):
        pos[s, :, 0] = (s * (360.0 / num_sources) + 5.0 * step) % 360.0
        pos[s, :, 1] = eles[s % len(eles)]
        pos[s, :, 2] = 0.5 + 0.1 * (s % 3)
    return pos


def scene_mover_positions(num_sources: int, num_blocks: int) -> np.ndarray:
    """(S, B, 3) wide-mover scene: every source orbits EVERY BLOCK at its
    own elevation band, so the cross-source unique-filter set is wide and
    dedup cannot pay — the shape that forces the direct batch dispatch
    (engine/batch.batched_chunk_fn)."""
    i = np.arange(num_blocks)
    pos = np.empty((num_sources, num_blocks, 3), np.float64)
    for s in range(num_sources):
        speed = 2.1 + 0.13 * (s % 7)  # deg/block: crossfade every block
        pos[s, :, 0] = (s * (360.0 / num_sources) + speed * i) % 360.0
        # distinct elevation bands spread the union across the grid's rings
        pos[s, :, 1] = -30.0 + (s % 8) * 15.0
        pos[s, :, 2] = 1.0
    return pos


def _batch_dispatches(br) -> set[str]:
    """Which batched chunk programs a BatchRenderer compiled, from its
    jit-cache keys (see BatchRenderer._get_fn): 'dedup' or 'direct'."""
    return {"direct" if dedup_key is None else "dedup"
            for (_nb, dedup_key, _xf) in br._jitted}


def run_scene_gate(
    signal: np.ndarray,
    db: HRTFDatabase,
    config: EngineConfig = DEFAULT_CONFIG,
    scenario: str = "hold",
    num_sources: int = 16,
    num_blocks: int = 12556,
    eps: float = 2e-7,
    chunk_blocks: int = 256,
    dedup: bool = True,
    oracle_workers: int = 1,
) -> PrecisionReport:
    """Full-scale engine-vs-oracle gate for the BATCHED/scene programs.

    The reference gates its engine end-to-end on every launch
    (precision_test.cu:2154-2201); the four classic scenarios above cover
    the single-source Renderer but the daemon/--scene production paths run
    `engine/batch.py`'s chunk programs.  This gate renders a multi-source
    scene through BatchRenderer and checks EVERY source's stream against
    its own oracle render at the same eps — per-source comparison, because
    a summed-mix comparison would dilute per-stream error into the sum's
    amplitude (the mix is still checked for finiteness by the callers).

    scenario 'hold'   -> sources hold positions  -> batch dedup program
    scenario 'movers' -> every-block wide movers (a crossfade every block;
                         the direct program once the scene is long enough
                         that dedup cannot pay)
    The hold gate asserts that the dedup program actually compiled, so it
    cannot pass against a path it does not exist to pin.
    """
    from ..engine.batch import BatchRenderer

    # whole chunks only: a partial final chunk adds padding, not coverage
    if num_blocks > chunk_blocks:
        num_blocks = (num_blocks // chunk_blocks) * chunk_blocks
    if scenario == "hold":
        positions = scene_hold_positions(num_sources, num_blocks)
        want_dispatch = "dedup"
    elif scenario == "movers":
        positions = scene_mover_positions(num_sources, num_blocks)
        want_dispatch = None
    else:
        raise ValueError(f"unknown scene scenario {scenario!r}")
    fpb = config.frames_per_buffer
    # distinct per-source streams: rotated copies of the input (cheap, and
    # keeps every stream's spectrum realistic)
    n = max(len(signal), num_blocks * fpb)
    base = np.resize(np.asarray(signal, np.float32), n)
    signals = np.stack(
        [np.roll(base, -(s * 7919 * fpb) % n) for s in range(num_sources)]
    )
    br = BatchRenderer(db, config, chunk_blocks=chunk_blocks, mix=False, dedup=dedup)
    outs = br.render(signals, positions)  # (S, B*fpb, 2)
    got_d = _batch_dispatches(br)
    if want_dispatch is not None and want_dispatch not in got_d:
        raise AssertionError(
            f"scene '{scenario}' gate did not exercise the "
            f"{want_dispatch} dispatch (compiled: {sorted(got_d)}) — "
            f"the gate would pin the wrong program"
        )
    wants = render_oracle_many(zip(signals, positions), db, config,
                               workers=oracle_workers)
    reports = [precision_check(o, w, eps=eps) for o, w in zip(outs, wants)]
    return max(reports, key=lambda rep: rep.max_abs_diff)


def run_benchmark_sweep(
    signal: np.ndarray,
    db: HRTFDatabase,
    config: EngineConfig = DEFAULT_CONFIG,
    blocks_per_step: int = 172,
    num_steps: int = 72,
    eps: float = 2e-7,
    r: float = 0.5,
    renderer: Renderer | None = None,
    scenarios=None,
    oracle_workers: int = 1,
) -> list[PrecisionReport]:
    """Run the 4-scenario sweep; returns one PrecisionReport per scenario.
    ``oracle_workers`` > 1 renders the oracles in that many CPU processes."""
    renderer = renderer or Renderer(db, config)
    gots, jobs = [], []
    for azi, ele in scenarios or SCENARIOS:
        traj = AzimuthSweep(
            start_azi=azi, ele=ele, r=r, step_deg=5.0,
            blocks_per_step=blocks_per_step, num_steps=num_steps,
        )
        pos = traj.sample(traj.total_blocks, config)
        gots.append(renderer.render(signal, pos, ProcessType.TPU_FD_COMPLEX,
                                    initial_old=(0.0, 0.0)))
        jobs.append((signal, pos))
    wants = render_oracle_many(jobs, db, config, workers=oracle_workers)
    return [precision_check(g, w, eps=eps) for g, w in zip(gots, wants)]


def main(argv=None) -> int:
    """CLI: full-scale sweep gate (the reference's always-on startup check).

    Emits one JSON line with the per-scenario max|diff| and its margin
    (max|diff| / eps) so headroom is tracked as a first-class regression
    metric — PERF.md records the ladder; the gate WARNS above MARGIN_WARN.
    """
    import argparse
    import json
    import sys
    import time

    p = argparse.ArgumentParser(prog="jefferson-sweep")
    p.add_argument("-i", "--input", default=None, help="input WAV (default: noise)")
    p.add_argument("--blocks", type=int, default=172)
    p.add_argument("--steps", type=int, default=72)
    p.add_argument("--eps", type=float, default=2e-7)
    p.add_argument("--no-mover", action="store_true",
                   help="skip the per-block mover scenario (the 4 "
                        "reference scenarios only exercise the dedup "
                        "dispatch)")
    p.add_argument("--no-scene", action="store_true",
                   help="skip the two multi-source scene scenarios (batch "
                        "dedup and direct gates — the daemon/--scene "
                        "production programs)")
    p.add_argument("--scene-sources", type=int, default=16,
                   help="sources per scene scenario (default 16)")
    p.add_argument("--write-dir", default=None,
                   help="also write each scenario's engine render as a WAV "
                        "(the reference's waveFileTesting, "
                        "precision_test.cu:2203-2250)")
    p.add_argument("--hrtf-dir", default=None,
                   help="compact KEMAR directory (same as the main CLI's "
                        "flag; default: $JEFFERSON_HRTF_DIR, else the "
                        "synthetic test set)")
    args = p.parse_args(argv)

    config = DEFAULT_CONFIG
    if args.input:
        from ..io.wavio import read_wav_mono

        signal, _ = read_wav_mono(args.input)
    else:
        signal = (np.random.default_rng(0).standard_normal(131072) * 0.2).astype(np.float32)
    from ..cli.main import load_hrtf

    db = load_hrtf(args.hrtf_dir, config, quiet=False)
    t0 = time.time()
    # ONE renderer across the sweep and mover gates (and --write-dir): its
    # jit caches are per-instance, so a second instance re-pays identical
    # chunk-program compiles (cli --selftest-full shares one likewise)
    renderer = Renderer(db, config)
    reports = run_benchmark_sweep(
        signal, db, config, blocks_per_step=args.blocks, num_steps=args.steps,
        eps=args.eps, renderer=renderer,
    )
    names = [f"azi{int(a)}_ele{int(e)}" for a, e in SCENARIOS]
    if not args.no_mover:
        reports.append(
            run_mover_gate(
                signal, db, config,
                num_blocks=args.blocks * (args.steps + 1), eps=args.eps,
                renderer=renderer,
            )
        )
        names.append("mover")
    if not args.no_scene:
        nb_scene = args.blocks * (args.steps + 1)
        for scenario in ("hold", "movers"):
            reports.append(run_scene_gate(
                signal, db, config, scenario=scenario,
                num_sources=args.scene_sources, num_blocks=nb_scene,
                eps=args.eps,
            ))
            names.append(f"scene_{scenario}")
    ok = True
    for name, rep in zip(names, reports):
        print(f"scenario {name}: {rep}")
        ok &= rep.ok
    margins = {
        n: {"max_abs": rep.max_abs_diff, "margin": round(rep.max_abs_diff / args.eps, 4)}
        for n, rep in zip(names, reports)
    }
    worst = max(margins.values(), key=lambda m: m["margin"])["margin"]
    print(json.dumps({
        "gate": "benchmark_sweep", "eps": args.eps, "ok": ok,
        "worst_margin": worst, "scenarios": margins,
    }))
    if worst > MARGIN_WARN and ok:
        print(
            f"WARNING: worst margin {worst:.2f} of the eps={args.eps:g} budget "
            f"exceeds the {MARGIN_WARN} safety factor — the next "
            f"contraction-order change may fail the gate (see PERF.md margin "
            f"ladder)",
            file=sys.stderr,
        )
    if args.write_dir:
        import pathlib

        from ..io.wavio import write_wav
        from ..trajectory.trajectory import AzimuthSweep

        outdir = pathlib.Path(args.write_dir)
        outdir.mkdir(parents=True, exist_ok=True)
        for azi, ele in SCENARIOS:
            traj = AzimuthSweep(
                start_azi=azi, ele=ele, r=0.5, step_deg=5.0,
                blocks_per_step=args.blocks, num_steps=args.steps,
            )
            pos = traj.sample(traj.total_blocks, config)
            out = renderer.render(signal, pos, initial_old=(0.0, 0.0))
            path = outdir / f"sweep_azi{int(azi)}_ele{int(ele)}.wav"
            write_wav(path, out, config.sample_rate)
            print(f"wrote {path}")
    print(f"sweep {'PASSED' if ok else 'FAILED'} in {time.time()-t0:.1f}s")
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
