"""Render daemon end-to-end: serve, stream, move, WATCH the scene live.

The reference draws the listener + source in a GLUT window at ~100 Hz
while audio plays (reference: Jefferson/src/graphics.cu:352-453).  The
headless equivalent is three cooperating pieces, all shown here in one
process (in production each is its own):

1. jefferson-serve          — the resident render daemon (Unix socket)
2. a client                 — starts a live stream and moves the source
3. jefferson-live-viz       — polls stream_status, rewrites live.svg
                              (+ a self-refreshing live.html for a browser)
"""

import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root import

import os

if not os.environ.get("JEFFERSON_EXAMPLES_ACCELERATOR"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import jefferson_tpu as jt
from jefferson_tpu.serve import RenderService, request, serve
from jefferson_tpu.viz.live import watch

cfg = jt.DEFAULT_CONFIG
td = Path(tempfile.mkdtemp(prefix="jt_ex08_"))
sock = td / "jt.sock"

# a test tone to spatialize
sr = cfg.sample_rate
tone = (0.3 * np.sin(2 * np.pi * 440 * np.arange(2 * sr) / sr)).astype(np.float32)
jt.write_wav(td / "in.wav", np.stack([tone, tone], 1), sr)

# 1) the daemon (in production: `python -m jefferson_tpu.serve --socket …`)
service = RenderService(hrtf_dir=None, chunk_blocks=256)
threading.Thread(target=serve, args=(sock, service), daemon=True).start()
# bounded startup wait: a daemon that dies before binding (unwritable
# socket dir, sun_path overflow) must fail loudly, not spin forever
for _ in range(1200):
    try:
        if request(sock, {"cmd": "ping"}).get("pong"):
            break
    except OSError:
        time.sleep(0.05)
else:
    raise SystemExit(f"daemon did not come up on {sock} within 60 s")

# 2) a live stream session + a scripted "user" moving the source
resp = request(sock, {"cmd": "stream_start", "input": str(td / "in.wav"),
                      "output": str(td / "live.wav"), "seconds": 4, "paced": True})
assert resp["ok"], resp
print("stream session:", resp["session"])


def mover():
    for azi in range(0, 360, 30):
        time.sleep(0.3)
        request(sock, {"cmd": "move", "azi": azi, "ele": 10, "r": 1.0})


threading.Thread(target=mover, daemon=True).start()

# 3) the live scene view: polls stream_status at ~20 Hz until the stream
#    ends, rewriting live.svg atomically (open live.html in a browser to
#    watch it move — production: `jefferson-live-viz --socket … -o live.svg`)
final = watch(sock, td / "live.svg", interval_s=0.05)
print("stream ended:", final.get("blocks"), "blocks,",
      "final position azi", final.get("azi"))
print("artifacts:", td / "live.svg", td / "live.html", td / "live.wav")

stats = request(sock, {"cmd": "stream_stop"})
print("deadline stats:", {k: stats[k] for k in ("blocks", "avg_ms", "misses")})
request(sock, {"cmd": "shutdown"})
