"""Live streaming: push 128-sample blocks, steer the source in real time.

This is the PortAudio-callback analogue — wire ``process_block`` into any
audio callback. Runs on CPU by default (JEFFERSON_EXAMPLES_ACCELERATOR=1 for the GPU).
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
from jefferson_tpu.utils.profiling import RTFMeter

cfg = jt.DEFAULT_CONFIG
db = jt.synthetic_database(cfg)
sp = StreamingSpatializer(db, cfg)
sp.buf = (np.random.default_rng(0).standard_normal(cfg.sample_rate) * 0.1).astype(np.float32)

meter = RTFMeter(cfg.sample_rate, cfg.frames_per_buffer)
outs = []
for k in range(200):  # ~0.6 s of audio
    sp.set_position(azi=(k * 2) % 360, ele=10, r=1.0)  # steer per block
    with meter.measure():
        outs.append(sp.process_next())
meter.report("streaming")
if sp.clipping:
    print("ALERT! CLIPPING AUDIO!")
jt.write_wav("stream.wav", np.concatenate(outs), cfg.sample_rate)
print("wrote stream.wav")
