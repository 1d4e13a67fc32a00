#!/bin/sh
# Full acceptance pass: the complete user journey on real assets where
# available, synthetic otherwise.  Exits nonzero on any failure.
#
# usage: scripts/acceptance.sh [WORKDIR]
set -e
cd "$(dirname "$0")/.."
WORK="${1:-$(mktemp -d)}"
mkdir -p "$WORK"
echo "== workdir $WORK"

IN=/root/reference/Jefferson/media/Castanets-441.wav
IR=/root/reference/Jefferson/media/s1_r1_b_441_mono.wav
if [ ! -f "$IN" ]; then
    echo "== reference media absent; generating synthetic input"
    python - "$WORK" <<'EOF'
import sys

import numpy as np

from jefferson_tpu.io.wavio import write_wav

rng = np.random.default_rng(0)
sr = 44100
t = np.arange(3 * sr) / sr
sig = 0.4 * np.sin(2 * np.pi * 440 * t) * (1 + 0.4 * np.sin(2 * np.pi * 2 * t))
write_wav(f"{sys.argv[1]}/in.wav", sig.astype(np.float32), sr, bits=24)
ir = rng.standard_normal(20000) * np.exp(-np.arange(20000) / 4000) * 0.05
write_wav(f"{sys.argv[1]}/ir.wav", ir.astype(np.float32), sr, bits=24)
EOF
    IN="$WORK/in.wav"; IR="$WORK/ir.wav"
fi

echo "== 1. test suite"
python -m pytest tests/ -q

# JEFFERSON_ACCEPT_DEVICE=cpu runs the CLI steps on the host CPU (the
# full-scale gate on the GPU is chip_smoke.py)
DEV="${JEFFERSON_ACCEPT_DEVICE:-native}"

echo "== 2. render with reverb + trajectory + viz (engine on $DEV)"
python -m jefferson_tpu.cli.main -i "$IN" -r "$IR" --reverb-mode reference \
    --trajectory "orbit:period=3,ele=10,r=1.5" --blocks 512 --chunk-blocks 512 \
    -o "$WORK/orbit.wav" --viz --device "$DEV"
test -s "$WORK/orbit.wav.scene.svg"
test -s "$WORK/orbit.wav.3d.html"

echo "== 3. engine-vs-oracle WAV gate"
python -m jefferson_tpu.cli.main -i "$IN" -t 0 --blocks 300 --chunk-blocks 512 \
    --trajectory "sweep:start=0,step=5,blocks=12,steps=24" -o "$WORK/engine.wav" --quiet --device "$DEV"
python -m jefferson_tpu.cli.main -i "$IN" -t 3 --blocks 300 \
    --trajectory "sweep:start=0,step=5,blocks=12,steps=24" -o "$WORK/cpu.wav" --quiet --device "$DEV"
python -m jefferson_tpu.cli.check "$WORK/engine.wav" "$WORK/cpu.wav" --eps 5e-7

echo "== 4. graft entry (single device + CPU mesh dry run)"
python __graft_entry__.py

echo "== ACCEPTANCE PASSED"
