"""Realtime audio playout adapter — the PortAudio analogue.

The reference opens a PortAudio stereo float32 output stream at 44.1 kHz
with 128-frame buffers and registers a callback that, per block: waits for
the previous block's GPU work, adds its result into the device buffer,
warns on clipping, enqueues the next block, and appends the block to the
output WAV (reference: Jefferson/src/Audio.cu:7-58 ``initializePA``,
94-163 ``callback_func``, 164-176 ``paCallback``).

The split: the DSP lives in ``StreamingSpatializer.process_block``
(the callback seam); this module supplies the device loop around it with
two interchangeable backends:

* ``sounddevice`` — live playout on hosts that have an audio device and the
  optional ``sounddevice`` package.  Degrades gracefully (clear error,
  ``have_output_device()`` probe) when either is absent — accelerator
  servers normally have neither.
* fake device — drives the identical callback from a host loop (optionally
  paced to the real-time block deadline), recording per-block compute time
  against the 128/44100 s = 2.9 ms budget.  This is both the CI test
  backend and the measured-latency budget tool; it mirrors the reference's
  DEBUGMODE=3 manual-callback mode (Jefferson/src/main.cu:149-154).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from ..engine.stream import StreamingSpatializer
from ..io.wavio import StreamingWavWriter


def _sounddevice():
    try:
        import sounddevice  # optional; not in the base image

        return sounddevice
    except Exception:
        return None


def have_output_device() -> bool:
    """True if live playout is possible (sounddevice + an output device)."""
    sd = _sounddevice()
    if sd is None:
        return False
    try:
        # probe the DEFAULT output device — play() opens device=None, so a
        # stereo device existing elsewhere in the list is not enough
        return sd.query_devices(kind="output")["max_output_channels"] >= 2
    except Exception:
        return False


@dataclass
class BlockStats:
    """Per-block deadline accounting for a playout run.

    ``budget_ms`` is the hard realtime deadline (block duration); a *miss*
    is a callback whose compute exceeded it — the condition under which a
    real device would underrun (the reference's equivalent failure is an
    audible glitch; it has no counter for it).
    """

    budget_ms: float
    compute_ms: list[float] = field(default_factory=list)

    @property
    def blocks(self) -> int:
        return len(self.compute_ms)

    @property
    def misses(self) -> int:
        return sum(1 for t in self.compute_ms if t > self.budget_ms)

    @property
    def miss_rate(self) -> float:
        return self.misses / self.blocks if self.blocks else 0.0

    @property
    def avg_ms(self) -> float:
        return float(np.mean(self.compute_ms)) if self.compute_ms else 0.0

    @property
    def max_ms(self) -> float:
        return float(np.max(self.compute_ms)) if self.compute_ms else 0.0

    @property
    def p99_ms(self) -> float:
        return float(np.percentile(self.compute_ms, 99)) if self.compute_ms else 0.0

    def summary(self) -> str:
        return (
            f"{self.blocks} blocks: avg {self.avg_ms:.3f} ms, p99 {self.p99_ms:.3f} ms, "
            f"max {self.max_ms:.3f} ms vs {self.budget_ms:.3f} ms budget "
            f"({self.misses} deadline misses, {100*self.miss_rate:.1f}%)"
        )


class AudioPlayout:
    """Drive one or more spatializer sources through a block callback.

    sources: ``StreamingSpatializer``s with their ``buf`` playback buffers
    set (wrapping playhead feed, like the reference), or zero-arg callables
    returning one (fpb, 2) stereo block.
    writer: optional ``StreamingWavWriter`` — every emitted block is
    appended, exactly like the reference's per-callback ``sf_writef_float``
    (Jefferson/src/Audio.cu:161).
    """

    def __init__(
        self,
        sources: Sequence[StreamingSpatializer | Callable[[], np.ndarray]],
        config: EngineConfig | None = None,
        writer: StreamingWavWriter | None = None,
    ):
        if not sources:
            raise ValueError("need at least one source")
        first = sources[0]
        self.config = config or (
            first.config if isinstance(first, StreamingSpatializer) else DEFAULT_CONFIG
        )
        self.sources = list(sources)
        self.writer = writer
        self.clipping = False
        self.stats = BlockStats(budget_ms=1e3 * self.config.block_duration)

    def prime(self) -> None:
        """Compile every source's device step before the stream opens.

        Duck-typed: any source exposing ``prime()`` (StreamingSpatializer, or
        a wrapper callable carrying one) is primed so the first audible block
        doesn't absorb a jit compile."""
        for s in self.sources:
            prime = getattr(s, "prime", None)
            if callable(prime):
                prime()

    def _pull(self, s) -> np.ndarray:
        if isinstance(s, StreamingSpatializer):
            if s.buf is None:
                raise ValueError("StreamingSpatializer source needs .buf set")
            return s.process_next()
        return s()

    def callback(self) -> np.ndarray:
        """One device callback: mix all sources into one stereo block.

        Mirrors reference callback_func: zero the output, accumulate each
        source's block (Audio.cu:98-158), clip-check, append to the WAV.
        """
        t0 = time.perf_counter()
        out = np.zeros((self.config.frames_per_buffer, 2), np.float32)
        for s in self.sources:
            out += self._pull(s)
        if np.any(np.abs(out) > 1.0):
            self.clipping = True  # reference: "ALERT! CLIPPING AUDIO!" (Audio.cu:111-113)
        self.stats.compute_ms.append(1e3 * (time.perf_counter() - t0))
        if self.writer is not None:
            self.writer.write(out)
        return out

    # -- fake-device backend ------------------------------------------------

    def run_offline(self, num_blocks: int, paced: bool = False, stop=None) -> BlockStats:
        """Drive the callback from a host loop (no audio device).

        paced=True sleeps to the realtime block cadence, emulating a device
        clock; False runs flat out (deadline stats are identical either way
        since only compute time is measured).  ``stop`` (optional zero-arg
        callable) ends the loop early when it returns True — the live
        interactive quit (the reference's ESC handler, graphics.cu:526-535).
        """
        self.prime()
        deadline = time.perf_counter()
        for _ in range(num_blocks):
            if stop is not None and stop():
                break
            self.callback()
            if paced:
                deadline += self.config.block_duration
                delay = deadline - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
        if self.writer is not None:
            self.writer.flush()
        return self.stats

    # -- live sounddevice backend --------------------------------------------

    def play(self, num_blocks: int | None = None, device=None, stop=None) -> BlockStats:
        """Live playout through ``sounddevice`` (blocking until done).

        Raises RuntimeError with a clear message when the optional package
        or an output device is missing — use ``run_offline`` there.
        ``stop``: optional zero-arg callable checked per block (live quit).
        """
        sd = _sounddevice()
        if sd is None:
            raise RuntimeError(
                "live playout needs the optional 'sounddevice' package "
                "(pip install sounddevice); use run_offline() for file output"
            )
        cfg = self.config
        self.prime()
        done = {"blocks": 0, "exc": None}
        finished = threading.Event()

        def cb(outdata, frames, time_info, status):
            try:
                if frames != cfg.frames_per_buffer:
                    raise RuntimeError(
                        f"device blocksize {frames} != {cfg.frames_per_buffer}"
                    )
                if (stop is not None and stop()) or (
                    num_blocks is not None and done["blocks"] >= num_blocks
                ):
                    # checked BEFORE emitting so num_blocks=0 plays zero
                    # blocks (run_offline(0) already does); sounddevice
                    # still plays this buffer out and it arrives
                    # uninitialized, so zero it or the stop emits a
                    # garbage burst
                    outdata.fill(0)
                    raise sd.CallbackStop
                outdata[:] = self.callback()
                done["blocks"] += 1
            except sd.CallbackStop:
                raise
            except Exception as e:  # surface errors instead of glitching forever
                done["exc"] = e
                raise sd.CallbackAbort

        stream = sd.OutputStream(
            samplerate=cfg.sample_rate,
            blocksize=cfg.frames_per_buffer,
            channels=2,
            dtype="float32",
            callback=cb,
            finished_callback=finished.set,
            device=device,
        )
        with stream:
            finished.wait()
        if done["exc"] is not None:
            raise done["exc"]
        if self.writer is not None:
            self.writer.flush()
        return self.stats
