"""Profiling and observability.

Equivalents of the reference's instrumentation (SURVEY.md section 5):
cudaProfilerStart/Stop brackets -> ``trace()`` (jax.profiler); the
sum_ms/avg_ms/num_calls counters on SoundSource (reference:
Jefferson/src/SoundSource.cuh:42-44) -> ``RTFMeter``; the GPU memory report
printSize() (reference: Jefferson/src/main.cu:7-11) -> ``device_memory_report``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time


@dataclasses.dataclass
class RTFMeter:
    """Per-block wall-clock counters: average ms/block and real-time factor."""

    sample_rate: int = 44_100
    frames_per_buffer: int = 128
    num_calls: int = 0
    sum_s: float = 0.0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, blocks: int = 1) -> float:
        if self._t0 is None:
            # stop-without-start (or a double stop) must not TypeError or
            # silently attribute the intervening gap to sum_s
            raise RuntimeError("RTFMeter.stop() without a matching start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.sum_s += dt
        self.num_calls += blocks
        return dt

    @contextlib.contextmanager
    def measure(self, blocks: int = 1):
        # exception-neutral: a raising body must still close the interval,
        # or a later stop() attributes the whole intervening gap
        self.start()
        try:
            yield
        finally:
            self.stop(blocks)

    @property
    def avg_ms(self) -> float:
        return 1e3 * self.sum_s / max(self.num_calls, 1)

    @property
    def rtf(self) -> float:
        """Real-time factor: >1 means faster than real time."""
        audio_s = self.num_calls * self.frames_per_buffer / self.sample_rate
        return audio_s / self.sum_s if self.sum_s else float("inf")

    def report(self, label: str = "engine", file=sys.stderr) -> None:
        print(
            f"{label}: {self.num_calls} blocks, avg {self.avg_ms:.4f} ms/block, "
            f"{self.rtf:,.1f}x real time",
            file=file,
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace bracket (the cudaProfilerStart/Stop analogue).

    View with TensorBoard or xprof; safe no-op if the profiler is
    unavailable on the current backend.
    """
    import jax

    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception as e:  # profiling must never break a render
        print(f"profiler unavailable: {e}", file=sys.stderr)
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def device_memory_report(file=sys.stderr) -> dict:
    """Per-device live-buffer byte counts (printSize analogue)."""
    import jax

    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if stats:
            used = stats.get("bytes_in_use", 0)
            limit = stats.get("bytes_limit", 0)
            out[str(d)] = stats
            print(
                f"{d}: {used/2**20:.1f} MiB in use"
                + (f" / {limit/2**20:.1f} MiB" if limit else ""),
                file=file,
            )
        else:
            live = sum(
                b.nbytes for b in jax.live_arrays() if d in getattr(b, "devices", lambda: set())()
            )
            out[str(d)] = {"live_array_bytes": live}
            print(f"{d}: {live/2**20:.1f} MiB live arrays (no allocator stats)", file=file)
    return out
