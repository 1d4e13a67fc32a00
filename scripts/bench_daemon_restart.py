"""Daemon restart warm-start: does the compile cache survive a restart?

The CLI and daemon keep a persistent XLA compilation cache
(cli/main.enable_compilation_cache).  This script measures what a restart
gets from it, on whatever platform jax boots:

  cold     — fresh daemon process, first render (compiles)
  warm     — same process, same-shape render (jit cache hit)
  restart  — NEW daemon process, same-shape render: what survives in the
             on-disk XLA cache shows up here

The daemons run one after another, and this parent process never opens a
device, so at most one process holds the card at a time.

Emits one JSON line: {"cold_s": ..., "warm_s": ..., "restart_s": ...}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _start_daemon(sock: str, env: dict, blocks: int = 512) -> subprocess.Popen:
    p = subprocess.Popen(
        [sys.executable, "-m", "jefferson_tpu.serve", "--socket", sock,
         "--chunk-blocks", str(blocks)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )
    from jefferson_tpu.serve import request

    for _ in range(600):
        try:
            r = request(sock, {"cmd": "ping"})
            if r.get("pong"):
                return p
        except Exception:
            pass
        time.sleep(0.2)
    p.kill()
    raise RuntimeError("daemon did not come up")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=512)
    args = ap.parse_args()

    from jefferson_tpu import DEFAULT_CONFIG
    from jefferson_tpu.io.wavio import write_wav
    from jefferson_tpu.serve import request

    cfg = DEFAULT_CONFIG
    td = tempfile.mkdtemp(prefix="jt_restart_")
    wav = os.path.join(td, "in.wav")
    rng = np.random.default_rng(0)
    sig = (rng.standard_normal(args.blocks * cfg.frames_per_buffer) * 0.2).astype(np.float32)
    write_wav(wav, np.stack([sig, sig], 1), cfg.sample_rate)

    env = dict(os.environ)
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # fresh on-disk cache so 'cold' is honest; 'restart' then exercises it
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(td, "xla_cache")
    sock = os.path.join(td, "d.sock")

    def render(tag):
        t0 = time.time()
        r = request(sock, {
            "cmd": "render", "input": wav,
            "output": os.path.join(td, f"{tag}.wav"),
            "trajectory": "orbit:period=0.7", "blocks": args.blocks,
        }, timeout=1800)
        dt = time.time() - t0
        assert r.get("ok"), r
        log(f"{tag}: {dt:.1f}s")
        return dt

    def stop(p: subprocess.Popen):
        # teardown must not mask the try-body's error: if the shutdown
        # request was never sent (a render assert fired first), the daemon
        # is still up — kill it rather than raise TimeoutExpired and leak
        # a process holding the socket and the device client
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()

    p1 = _start_daemon(sock, env, args.blocks)
    try:
        cold = render("cold")
        warm = render("warm")
        request(sock, {"cmd": "shutdown"})
    finally:
        stop(p1)

    p2 = _start_daemon(sock, env, args.blocks)
    try:
        restart = render("restart")
        request(sock, {"cmd": "shutdown"})
    finally:
        stop(p2)

    ncache = sum(len(fs) for _, _, fs in os.walk(env["JAX_COMPILATION_CACHE_DIR"]))
    print(json.dumps({
        "cold_s": round(cold, 2), "warm_s": round(warm, 2),
        "restart_s": round(restart, 2), "cache_files": ncache,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
