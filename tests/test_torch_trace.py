"""The port's ``runtime/trace.py`` on the CPU: every ``DecodeTrace`` stage
against the JAX package's ``pipeline_trace`` on seeded and extreme
coefficients, ``recon`` against the port's decode datapath (K2's plain
version), and ``profile`` writing a Chrome trace. Tolerance: exact
equality. ``pipeline_trace`` runs on the card unless asked for the CPU,
as the other entry points do."""

import json
import os

import numpy as np
import pytest
import torch

from video_coding_tpu.runtime.trace import pipeline_trace as jax_trace
from video_coding_tpu_torch.ops import datapath
from video_coding_tpu_torch.runtime import trace

FIELDS = ["coefs_zigzag", "dequant_zigzag", "dequant_natural",
          "after_row_pass", "after_col_pass", "clipped", "recon"]


def _inputs(case: str, n: int = 40):
    rng = np.random.default_rng(len(case) + n)
    if case == "seeded":
        coefs = rng.integers(-200, 200, (n, 64)) * (rng.random((n, 64)) < .3)
        quant = rng.integers(1, 100, (n, 64))
    elif case == "extreme_2047":
        coefs = rng.choice([-2047, 2047, 0], (n, 64))
        quant = rng.integers(1, 256, (n, 64))
    elif case == "extreme_32767_q255":
        coefs = rng.choice([-32767, 32767], (n, 64))
        quant = np.full((n, 64), 255)
    else:  # one quant row for every block
        coefs = rng.integers(-1024, 1024, (n, 64))
        quant = rng.integers(1, 256, 64)
    return coefs.astype(np.int32), quant.astype(np.int32)


CASES = ["seeded", "extreme_2047", "extreme_32767_q255", "one_quant_row"]


@pytest.mark.parametrize("case", CASES)
def test_pipeline_trace_matches_jax(case):
    coefs, quant = _inputs(case)
    got = trace.pipeline_trace(coefs, quant, device="cpu")
    want = jax_trace(coefs, quant)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_pipeline_trace_recon_is_the_datapath(case):
    coefs, quant = _inputs(case)
    q = np.broadcast_to(quant, coefs.shape).copy()
    pix = datapath.decode_datapath(torch.from_numpy(coefs),
                                   torch.from_numpy(q))
    np.testing.assert_array_equal(
        trace.pipeline_trace(coefs, quant, device="cpu").recon,
                                  pix.numpy().astype(np.int32))


def test_profile_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with trace.profile(str(log_dir)) as prof:
        trace.pipeline_trace(*_inputs("seeded", 8), device="cpu")
    assert prof is not None
    (name,) = os.listdir(log_dir)
    data = json.loads((log_dir / name).read_text())
    assert data["traceEvents"]


def test_pipeline_trace_defaults_to_the_card():
    """No device means the card: without one it raises rather than fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the default without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace.pipeline_trace(*_inputs("seeded", 4))
