"""Port K2/K3 (plain versions, CPU) against the reference Pallas datapath
kernels in interpret mode. Tolerance: exact equality — the codec is
bit-exact by contract."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.model.zigzag import INVERSE
from video_coding_tpu.ops import chen_jax
from video_coding_tpu.ops import datapath as jdp
from video_coding_tpu_torch.ops import chen, datapath

CSRC = pathlib.Path(__file__).resolve().parent.parent / \
    "video_coding_tpu_torch" / "csrc"


def _inputs(seed: int, n: int, p: int):
    rng = np.random.default_rng(seed)
    coefs = rng.integers(-300, 301, (n, 64)).astype(np.int32)
    coefs[:, 20:] //= 8                       # realistic high-band decay
    quant = rng.integers(1, 256, (p, 64)).astype(np.int32)
    pixels = rng.integers(0, 256, (n, 8, 8)).astype(np.uint8)
    return coefs, quant, pixels


@pytest.mark.parametrize("n,p", [(300, 300), (384, 6)])
def test_decode_datapath_matches_pallas(n, p):
    coefs, quant, _ = _inputs(n + p, n, p)
    qfull = np.tile(quant, (-(-n // p), 1))[:n]
    ref = np.asarray(jdp.decode_datapath_pallas(
        jnp.asarray(coefs), jnp.asarray(qfull), interpret=True))
    got = datapath.decode_datapath(torch.from_numpy(coefs),
                                   torch.from_numpy(quant))
    assert got.dtype == torch.uint8 and got.shape == (n, 8, 8)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), ref)


@pytest.mark.parametrize("n,p", [(300, 300), (384, 6)])
def test_encode_datapath_matches_pallas(n, p):
    _, quant, pixels = _inputs(2 * n + p, n, p)
    qfull = np.tile(quant, (-(-n // p), 1))[:n]
    ref = np.asarray(jdp.encode_datapath_pallas(
        jnp.asarray(pixels.astype(np.int32)), jnp.asarray(qfull),
        interpret=True))
    got = datapath.encode_datapath(torch.from_numpy(pixels),
                                   torch.from_numpy(quant))
    assert got.dtype == torch.int32 and got.shape == (n, 64)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("sign", [1, -1])
def test_decode_worst_case_coefficients(sign):
    """Max-magnitude 12-bit coefficients everywhere — the int32 overflow
    stress case behind the split 181-multiply."""
    coefs = np.full((8, 64), sign * 2047, dtype=np.int32)
    quant = np.full((8, 64), 255, dtype=np.int32)
    ref = np.asarray(jdp.decode_datapath_pallas(
        jnp.asarray(coefs), jnp.asarray(quant), interpret=True))
    got = datapath.decode_datapath(torch.from_numpy(coefs),
                                   torch.from_numpy(quant))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), ref)


def test_mul181_shift8_exact_over_int32():
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.integers(-2**27, 2**27, 4096),
                        [0, 1, -1, 2**27 - 1, -2**27]]).astype(np.int32)
    got = chen._mul181_shift8(torch.from_numpy(a)).numpy()
    ref = np.asarray(chen_jax._mul181_shift8(jnp.asarray(a)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, (181 * a.astype(np.int64) + 128) >> 8)


def test_chen_transforms_match_reference():
    rng = np.random.default_rng(3)
    blocks = rng.integers(-2048, 2048, (64, 8, 8)).astype(np.int32)
    tile = jnp.asarray(blocks.transpose(1, 2, 0))
    inv = np.asarray(chen_jax.chen_inverse(tile)).transpose(2, 0, 1)
    fwd = np.asarray(chen_jax.chen_forward(tile // 16)).transpose(2, 0, 1)
    np.testing.assert_array_equal(
        chen.chen_inverse(torch.from_numpy(blocks)).numpy(), inv)
    np.testing.assert_array_equal(
        chen.chen_forward(torch.from_numpy(blocks // 16)).numpy(), fwd)


@pytest.mark.parametrize("src", ["decode_datapath.cu", "encode_datapath.cu"])
def test_kernel_zigzag_table_matches_model(src):
    """The CUDA kernels carry their own zigzag table; it must be the
    model's (natural index of each zigzag position)."""
    text = (CSRC / src).read_text()
    body = re.search(r"kInverse\[64\]\s*=\s*\{([^}]*)\}", text).group(1)
    table = [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]
    assert table == np.asarray(INVERSE).tolist()


def test_wrappers_reject_bad_inputs():
    coefs = torch.zeros((4, 64), dtype=torch.int64)
    with pytest.raises(TypeError):
        datapath.decode_datapath(coefs, torch.ones((1, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        datapath.encode_datapath(torch.zeros((4, 8, 8), dtype=torch.uint8),
                                 torch.ones((1, 63), dtype=torch.int32))
