"""jefferson-rt — realtime block-loop demo (the reference's live mode).

Drives StreamingSpatializer block-by-block through the AudioPlayout callback
loop along a trajectory, like the reference's PortAudio + GLUT run
(reference: Jefferson/src/main.cu:93-99), writing the output WAV per block
and reporting per-block deadline statistics.  --live plays through an audio
device (needs the optional sounddevice package); the default fake-device
mode runs anywhere.  --keys replaces the trajectory with live keyboard
control — WASD/arrows move the source while the audio follows, the
reference's GLUT interaction loop (reference: Jefferson/src/graphics.cu:487-601)
without the GL window.

    python -m jefferson_tpu.rt -i in.wav --trajectory orbit:period=4 \
        --seconds 5 -o live.wav [--live] [--paced] [--keys]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="jefferson-rt",
        description=(__doc__ or "jefferson-rt").splitlines()[0],
    )
    p.add_argument("-i", "--input", required=True, help="input WAV (mono/stereo)")
    p.add_argument("-o", "--output", default="live.wav")
    p.add_argument("--trajectory", default="orbit:period=4,ele=10,r=1.0")
    p.add_argument("--seconds", type=float, default=None,
                   help="session length (default 3.0; with --keys the "
                        "default is one hour — interactive sessions end on "
                        "q/ESC, not on a 3 s timer)")
    p.add_argument("--hrtf-dir", default=None)
    p.add_argument("--reverb", default=None,
                   help="impulse-response WAV: live partitioned convolution "
                        "of the dry signal before spatialization (one-block "
                        "latency)")
    p.add_argument("--live", action="store_true",
                   help="play through an audio device (sounddevice backend)")
    p.add_argument("--paced", action="store_true",
                   help="fake-device mode: sleep to the realtime block cadence")
    p.add_argument("--keys", action="store_true",
                   help="interactive source control: w/s up-down, a/d and "
                        "left/right arrows sideways, up/down arrows "
                        "away/toward, r reset, q/ESC quit (the reference's "
                        "GLUT key loop, graphics.cu:487-601; elevation "
                        "guarded above -40 deg)")
    p.add_argument("--device", choices=("auto", "cpu"), default="auto",
                   help="jax backend for the per-block step: auto (default) "
                        "keeps the platform JAX booted; cpu forces the host "
                        "CPU")
    args = p.parse_args(argv)

    if args.device == "cpu":
        # must happen before the first backend use
        import jax

        jax.config.update("jax_platforms", "cpu")

    from ..cli.main import load_hrtf, parse_trajectory
    from ..config import DEFAULT_CONFIG
    from ..engine.stream import StreamingSpatializer
    from ..io.resample import read_wav_mono_at
    from ..io.wavio import StreamingWavWriter
    from .playout import AudioPlayout

    cfg = DEFAULT_CONFIG
    # interactive sessions run until q/ESC (one-hour safety cap), not a 3 s
    # timer; a fixed --seconds wins either way
    seconds = args.seconds if args.seconds is not None else (3600.0 if args.keys else 3.0)
    if seconds <= 0:
        # same rule as the daemon's stream_start: a 0-block session would
        # exit silently here but crash the --live callback on positions[-1]
        raise SystemExit(f"--seconds must be > 0, got {seconds}")
    signal = read_wav_mono_at(args.input, cfg.sample_rate)
    if len(signal) == 0:
        # the wrapping playhead does `% n_sig` — fail cleanly up front
        raise SystemExit(f"input WAV {args.input!r} is empty")
    db = load_hrtf(args.hrtf_dir, cfg)
    num_blocks = int(np.ceil(seconds / cfg.block_duration))
    try:
        positions = parse_trajectory(args.trajectory).sample(num_blocks, cfg)
    except ValueError as e:
        raise SystemExit(str(e))

    conv = None
    if args.reverb is not None:
        from ..reverb.convolution import StreamingConvolver

        ir = read_wav_mono_at(args.reverb, cfg.sample_rate)
        conv = StreamingConvolver(ir, partition=cfg.frames_per_buffer)

    spat = StreamingSpatializer(db, cfg)
    spat.buf = signal  # wrapping playhead lives in the spatializer
    state = {"b": 0}
    fpb = cfg.frames_per_buffer

    control = None
    key_thread = None
    if args.keys:
        from ..trajectory.spatial import cartesian_to_spherical
        from .control import SourceControl, start_key_thread

        control = SourceControl()

        def readout(key, xyz):
            a, e, r = (float(v) for v in cartesian_to_spherical(np.asarray(xyz)))
            print(f"\r[{key:>5}] azi {a:5.0f}  ele {e:4.0f}  r {r:5.2f}  ",
                  end="", file=sys.stderr, flush=True)

        key_thread = start_key_thread(control, on_key=readout)
        if key_thread is None:
            print("jefferson-rt --keys: stdin is not a TTY; position is "
                  "controllable programmatically only", file=sys.stderr)

    def source():
        b = min(state["b"], num_blocks - 1)
        state["b"] += 1
        if control is not None:
            # live control: the audio loop reads whatever position the key
            # thread last wrote (reference graphics.cu:376-386 split)
            spat.set_position_cartesian(control.coordinates())
        else:
            azi, ele, r = positions[b]
            spat.set_position(azi=azi, ele=ele, r=r)
        # wrapping playhead (the reference's callback feed) — shared
        # implementation in StreamingSpatializer.next_block
        blk = spat.next_block()
        if conv is not None:  # live reverb ahead of the spatializer
            blk = np.asarray(conv.process(blk), dtype=np.float32)[:fpb]
        return spat.process_block(blk)

    def prime():
        spat.prime()
        if conv is not None:
            conv.prime()

    source.prime = prime  # AudioPlayout primes through the wrapper

    writer = StreamingWavWriter(args.output, cfg.sample_rate)
    play = AudioPlayout([source], cfg, writer=writer)
    stop = (lambda: control.quit) if control is not None else None
    try:
        if args.live:
            stats = play.play(num_blocks=num_blocks, stop=stop)
        else:
            # interactive fake-device mode paces to the block cadence so key
            # presses land between blocks like a real device clock
            stats = play.run_offline(num_blocks, paced=args.paced or args.keys, stop=stop)
    finally:
        if key_thread is not None:
            key_thread.close()  # restore the terminal even on early exit
        # close INSIDE the finally: an exception mid-playout must still
        # patch the streaming header, or the partial render reads as a
        # 0-data-byte WAV (the writer's whole purpose — round-5 review)
        writer.close()
    if play.clipping:
        print("ALERT! CLIPPING AUDIO!", file=sys.stderr)
    print(f"{args.output}: {stats.summary()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
