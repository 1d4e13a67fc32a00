#!/usr/bin/env python3
"""Sanitizer-instrumented fuzz of the native C++ host extension.

The plain-build mutation fuzz (tests/test_native.py) only catches
out-of-bounds accesses violent enough to kill the process; a heap
over-READ inside a malloc bucket decodes garbage silently.  This script
rebuilds ``_native.cpp`` with ``-fsanitize=address,undefined``
(non-recovering) and drives every exported entry point under the
instrumented build in a subprocess with ``libasan`` preloaded, so any
out-of-bounds access, use-after-free, signed overflow, or misaligned
load aborts loudly.

Coverage per run:
  - ``decode_wav``: N byte-mutated / truncated / chunk-spliced WAVs
    (both the 16/24/32-bit PCM and float32 encodings, EXTENSIBLE too),
  - ``encode_pcm`` on edge shapes (0 frames, 1 frame, odd channel
    counts, non-finite samples),
  - ``fed_stream`` / ``build_segments`` on boundary block geometries,
  - ``pick_hrtf`` / ``interp_plan`` on extreme, NaN and inf angles,
  - ``distance_phase_split`` on denormal/huge radii.

Usage:  python scripts/asan_fuzz_native.py [--trials N]  (default 3000)

Exit 0 = survived; any sanitizer report exits non-zero with the ASAN/
UBSAN diagnostic on stderr.  Run by ``tests/test_native.py``'s
sanitizer gate with a reduced trial count.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

DRIVER = r"""
import importlib.util
import sys

import numpy as np

spec = importlib.util.spec_from_file_location("_jefferson_native", sys.argv[1])
nat = importlib.util.module_from_spec(spec)
spec.loader.exec_module(nat)

sys.path.insert(0, sys.argv[3])
from jefferson_tpu.io import wavio  # pure-Python encoder side only

trials = int(sys.argv[2])
rng = np.random.default_rng(20260820)

# --- corpus: one well-formed WAV per encoding the decoder supports ---
bases = []
x = (rng.random((64, 2), dtype=np.float32) - 0.5).astype(np.float32)
for bits, as_float in ((16, False), (24, False), (32, False), (32, True)):
    body = wavio._encode(x, bits, as_float)
    bases.append(wavio._header(44100, 2, bits, as_float, len(body)) + body)
mono = wavio._encode(x[:, :1], 16, False)
bases.append(wavio._header(8000, 1, 16, False, len(mono)) + mono)

# --- decode_wav: mutate, truncate, splice ---
for trial in range(trials):
    b = bytearray(bases[trial % len(bases)])
    for _ in range(int(rng.integers(1, 6))):
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
    r = rng.random()
    if r < 0.25:
        b = b[: int(rng.integers(0, len(b)))]
    elif r < 0.35:  # splice a random tail from another corpus entry
        other = bases[int(rng.integers(0, len(bases)))]
        cut = int(rng.integers(0, min(len(b), len(other))))
        b = b[:cut] + other[cut:]
    try:
        nat.decode_wav(bytes(b))
    except Exception:
        pass

# --- encode_pcm edge shapes ---
for shape in ((0, 2), (1, 1), (3, 7), (64, 2)):
    arr = (rng.random(shape, dtype=np.float32) - 0.5).astype(np.float32)
    if arr.size:
        arr.flat[0] = np.nan
        arr.flat[-1] = np.inf
    for bits in (16, 24, 32):
        try:
            nat.encode_pcm(np.ascontiguousarray(arr), bits)
        except Exception:
            pass

# --- fed_stream / build_segments boundary geometries ---
sig = (rng.random(1000, dtype=np.float32) - 0.5).astype(np.float32)
for nb, fpb in ((1, 1), (1, 128), (7, 128), (3, 1024), (2, 999)):
    try:
        st = nat.fed_stream(sig, nb, fpb)
        hist = np.zeros(max(fpb, 8), np.float32)
        for pad in (fpb, fpb + 1, 2 * fpb, len(hist) + fpb):
            try:
                nat.build_segments(st, hist, fpb, pad)
            except Exception:
                pass
    except Exception:
        pass

# --- angle paths: extreme / non-finite inputs ---
ang = np.array([-1e9, -361.0, -40.0, -0.0, 0.0, 13.7, 89.9, 90.0,
                361.0, 1e9, np.nan, np.inf, -np.inf], np.float32)
ele = np.repeat(ang, len(ang))
azi = np.tile(ang, len(ang))
for fn in (nat.pick_hrtf, nat.interp_plan):
    try:
        fn(ele, azi)
    except Exception:
        pass

# --- distance phase split on denormal / huge radii ---
radii = np.array([0.0, 1e-38, 1e-3, 1.0, 3e8, np.inf, np.nan], np.float32)
for fsvs in (0.0, 128.6, 1e30):
    try:
        nat.distance_phase_split(fsvs, radii, 513)
    except Exception:
        pass

print("SANITIZED-SURVIVED")
"""


def build_instrumented(out_dir: Path) -> Path:
    import numpy as np

    src = ROOT / "jefferson_tpu" / "native" / "_native.cpp"
    out = out_dir / "_jefferson_native_asan.so"
    cmd = [
        "g++", "-O1", "-g", "-fno-omit-frame-pointer",
        "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
        "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
        f"-I{sysconfig.get_paths()['include']}",
        f"-I{np.get_include()}",
        str(src), "-o", str(out),
    ]
    subprocess.run(cmd, check=True)
    return out


def libasan_path() -> str:
    return subprocess.run(
        ["g++", "-print-file-name=libasan.so"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def run_fuzz(trials: int) -> int:
    asan = libasan_path()
    if "/" not in asan:  # g++ echoes the bare name when the lib is absent
        print("libasan not available; cannot run", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as td:
        so = build_instrumented(Path(td))
        env = dict(os.environ)
        # Python itself is uninstrumented: preload the runtime and drop
        # leak checking (the interpreter "leaks" by design at exit).
        env["LD_PRELOAD"] = asan
        env["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
        r = subprocess.run(
            [sys.executable, "-c", DRIVER, str(so), str(trials), str(ROOT)],
            capture_output=True, text=True, timeout=600, env=env,
        )
        ok = r.returncode == 0 and "SANITIZED-SURVIVED" in r.stdout
        if not ok:
            print(f"rc={r.returncode}", file=sys.stderr)
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        print(f"asan+ubsan fuzz survived ({trials} decode trials + "
              "codec/stream/angle/distance edge sweeps)")
        return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3000)
    args = ap.parse_args()
    return run_fuzz(args.trials)


if __name__ == "__main__":
    sys.exit(main())
