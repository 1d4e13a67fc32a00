#!/bin/sh
# External file-level gate: render the same scene with the engine (-t 0)
# and the CPU oracle (-t 3), then compare the WAVs — the equivalent of the
# reference's Precision.ps1 + Precision_Check.py chain.
#
# usage: scripts/precision_check.sh INPUT.wav [TRAJECTORY] [BLOCKS]
set -e
INPUT="${1:?usage: precision_check.sh INPUT.wav [TRAJECTORY] [BLOCKS]}"
TRAJ="${2:-sweep:start=0,step=5,blocks=32,steps=24}"
BLOCKS="${3:-800}"
OUT=$(mktemp -d)
trap 'rm -rf "$OUT"' EXIT

# float32 WAVs so the gate measures the engines, not 24-bit quantization,
# at the reference's own 2e-7 tolerance
python -m jefferson_tpu.cli.main -i "$INPUT" -t 0 --trajectory "$TRAJ" \
    --blocks "$BLOCKS" -o "$OUT/engine.wav" --bits 32 --float --quiet
python -m jefferson_tpu.cli.main -i "$INPUT" -t 3 --trajectory "$TRAJ" \
    --blocks "$BLOCKS" -o "$OUT/cpu.wav" --bits 32 --float --quiet
python -m jefferson_tpu.cli.check "$OUT/engine.wav" "$OUT/cpu.wav" --eps 2e-7
