"""jefferson_tpu — binaural spatialization framework on JAX/XLA.

A from-scratch JAX/XLA rebuild of the capabilities of the CUDA
binaural spatializer Cindytb/Jefferson-2.0: block-streaming overlap-save FFT
convolution with azimuth/elevation-interpolated KEMAR HRTF pairs,
crossfading on source movement, frequency-domain distance cues, convolution
reverb, WAV file I/O, trajectory-driven offline/streaming rendering, and a
CPU-oracle parity test methodology.  See SURVEY.md for the structural map of
the reference this framework re-implements.
"""

from .config import DEFAULT_CONFIG, EngineConfig, ProcessType
from .hrtf.kemar import (
    HRTFDatabase,
    load_compact,
    load_database,
    load_full,
    pick_hrtf,
    synthetic_database,
)
from .io.wavio import StreamingWavWriter, read_wav, read_wav_mono, write_wav
from .testing import precision_check, rms_error

__version__ = "0.2.0"

# heavyweight surfaces resolve lazily so `import jefferson_tpu` stays cheap
# (and jax platform selection can still happen after import, see conftest)
_LAZY = {
    "Renderer": "jefferson_tpu.engine.renderer",
    "BatchRenderer": "jefferson_tpu.engine.batch",
    "StreamingSpatializer": "jefferson_tpu.engine.stream",
    "AudioPlayout": "jefferson_tpu.rt.playout",
    "DifferentiableRenderer": "jefferson_tpu.diff.render",
    "render_oracle": "jefferson_tpu.oracle.reference",
    "load_sofa": "jefferson_tpu.hrtf.sofa",
    "fit_database": "jefferson_tpu.diff.personalize",
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


__all__ = [
    *_LAZY,
    "DEFAULT_CONFIG",
    "EngineConfig",
    "ProcessType",
    "HRTFDatabase",
    "load_compact",
    "load_database",
    "load_full",
    "pick_hrtf",
    "synthetic_database",
    "StreamingWavWriter",
    "read_wav",
    "read_wav_mono",
    "write_wav",
    "precision_check",
    "rms_error",
]
