"""Reverb tests: partitioned accelerator convolution vs whole-signal oracle,
reference circular-wrap semantics, RMS normalization, streaming convolver."""

import numpy as np
import pytest

from jefferson_tpu.reverb.convolution import (
    StreamingConvolver,
    convolve_linear,
    reverb_oracle,
    reverb_reference,
)


@pytest.fixture(scope="module")
def dry():
    rng = np.random.default_rng(10)
    return (rng.standard_normal(20_000) * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def ir():
    rng = np.random.default_rng(11)
    n = 4_500  # not a multiple of the partition
    env = np.exp(-np.arange(n) / 600.0)
    return (rng.standard_normal(n) * env * 0.1).astype(np.float32)


import pytest as _pytest


@_pytest.mark.parametrize("backend", ["host", "tpu"])
def test_linear_convolution_matches_numpy(dry, ir, backend):
    want = np.convolve(dry.astype(np.float64), ir.astype(np.float64))
    got = convolve_linear(dry, ir, backend=backend)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err < 5e-5, err


def test_short_ir_and_short_signal():
    sig = np.ones(100, np.float32)
    ir = np.array([1.0, 0.5], np.float32)
    got = convolve_linear(sig, ir)
    want = np.convolve(sig, ir)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_reference_reverb_matches_oracle(dry, ir):
    got = reverb_reference(dry, ir, normalize=False)
    want = reverb_oracle(dry, ir, normalize=False)
    assert got.shape == want.shape == (len(dry) + len(ir) - len(ir) // 2,)
    assert np.max(np.abs(got - want)) < 5e-5


def test_circular_wrap_semantics(dry, ir):
    """The tail beyond new_size must wrap onto the start (PadData sizing)."""
    lin = np.convolve(dry.astype(np.float64), ir.astype(np.float64))
    new_size = len(dry) + len(ir) - len(ir) // 2
    want = lin[:new_size].copy()
    want[: len(lin) - new_size] += lin[new_size:]
    got = reverb_reference(dry, ir, normalize=False)
    assert np.max(np.abs(got - want)) < 5e-5


def test_rms_normalization(dry, ir):
    out = reverb_reference(dry, ir, normalize=True)
    rms_in = np.sqrt(np.mean(dry.astype(np.float64) ** 2))
    rms_out = np.sqrt(np.mean(out.astype(np.float64) ** 2))
    np.testing.assert_allclose(rms_out, rms_in, rtol=1e-4)


def test_streaming_convolver_matches_offline(dry, ir):
    part = 1024
    conv = StreamingConvolver(ir, partition=part)
    n_chunks = len(dry) // part
    outs = [conv.process(dry[i * part : (i + 1) * part]) for i in range(n_chunks)]
    # flush the tail
    for _ in range(len(ir) // part + 2):
        outs.append(conv.process(np.zeros(part, np.float32)))
    got = np.concatenate(outs)
    want = np.convolve(dry[: n_chunks * part].astype(np.float64), ir.astype(np.float64))
    m = min(len(got), len(want))
    assert np.max(np.abs(got[:m] - want[:m])) < 5e-5


def test_streaming_convolver_rejects_oversized_chunk():
    """A chunk longer than the partition corrupts the delay line silently
    if accepted — it must raise instead."""
    import pytest

    ir = np.ones(64, np.float32)
    conv = StreamingConvolver(ir, partition=32)
    with pytest.raises(ValueError):
        conv.process(np.zeros(33, np.float32))


def test_one_tap_ir_matches_oracle():
    """A 1-tap (pure gain) IR must work in both reference forms (review
    finding: the circular-wrap copy used to crash on the off-by-one)."""
    rng = np.random.default_rng(2)
    dry = rng.standard_normal(300).astype(np.float32) * 0.3
    ir1 = np.array([0.7], np.float32)
    got = reverb_reference(dry, ir1, normalize=False)
    want = reverb_oracle(dry, ir1, normalize=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_empty_ir_rejected():
    dry = np.ones(100, np.float32)
    with pytest.raises(ValueError, match="empty"):
        convolve_linear(dry, np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="empty"):
        StreamingConvolver(np.zeros(0, np.float32), partition=64)


def test_streaming_state_stays_on_device(dry, ir):
    """The hot-path contract: constant spectra and ring/overlap state are
    device arrays (uploaded once), not host arrays re-uploaded per block."""
    import jax

    conv = StreamingConvolver(ir, partition=256)
    conv.process(dry[:256])
    for name in ("_hr", "_hi", "_ring_r", "_ring_i", "_overlap"):
        assert isinstance(getattr(conv, name), jax.Array), name


def test_reverb_oracle_normalize_restores_input_rms(dry, ir):
    """normalize=True (the reference's intended RMS renorm) scales the wet
    output back to the dry signal's RMS; normalize=False leaves it raw."""
    wet = reverb_oracle(dry, ir, normalize=True)
    rms_in = float(np.sqrt(np.mean(np.asarray(dry, np.float64) ** 2)))
    rms_wet = float(np.sqrt(np.mean(np.asarray(wet, np.float64) ** 2)))
    assert abs(rms_wet - rms_in) < 1e-4 * max(rms_in, 1e-9)
    raw = reverb_oracle(dry, ir, normalize=False)
    assert not np.allclose(raw, wet)
