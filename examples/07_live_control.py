"""Live interactive source control, programmatically.

Three ways to move the source while audio renders (the reference's GLUT
interaction loop, reference: Jefferson/src/graphics.cu:487-601, headless):

1. In-process: SourceControl + AudioPlayout (shown here).
2. Terminal:   python -m jefferson_tpu.rt -i in.wav --keys
3. Daemon:     {"cmd": "stream_start"} / {"cmd": "move"} / {"cmd": "stream_stop"}
               over the jefferson-serve Unix socket.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root import

import os

if not os.environ.get("JEFFERSON_EXAMPLES_ACCELERATOR"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import jefferson_tpu as jt
from jefferson_tpu.engine.stream import StreamingSpatializer
from jefferson_tpu.rt.control import SourceControl, spherical_to_control_xyz
from jefferson_tpu.rt.playout import AudioPlayout

cfg = jt.DEFAULT_CONFIG
db = jt.synthetic_database(cfg)  # swap for load_hrtf(...) with real KEMAR data

sr = cfg.sample_rate
t = np.arange(2 * sr) / sr
signal = (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)

control = SourceControl()
spat = StreamingSpatializer(db, cfg)
fpb = cfg.frames_per_buffer
state = {"i": 0, "b": 0}

# a scripted "user": orbit by key presses, then jump via explicit moves
script = {20: ["d"] * 3, 60: ["w", "w"], 100: ["up"], 140: ["r"]}


def source():
    for key in script.get(state["b"], []):
        control.apply_key(key)
    if state["b"] == 180:  # programmatic spherical move (daemon 'move' form)
        control.move_to(*spherical_to_control_xyz(azi_deg=270, ele_deg=20, r=1.0))
    state["b"] += 1
    spat.set_position_cartesian(control.coordinates())
    idx = (np.arange(fpb) + state["i"]) % len(signal)
    state["i"] += fpb
    return spat.process_block(signal[idx])


source.prime = spat.prime

writer = jt.StreamingWavWriter("live_control.wav", sr)
play = AudioPlayout([source], cfg, writer=writer)
stats = play.run_offline(num_blocks=240, stop=lambda: control.quit)
writer.close()

print(f"wrote live_control.wav — {stats.summary()}")
print(f"crossfades fired: {spat.crossfades}")
