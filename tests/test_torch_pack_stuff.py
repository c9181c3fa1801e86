"""Port K8 (plain version, CPU) against the reference Pallas packer
``pack_stuff_pallas`` in interpret mode, on slots from the reference's
``_symbol_parts`` and on synthetic slots. Tolerance: exact equality of the
whole (S, m_out) byte array, the lengths and the overflow flag."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.entropy import pallas_encode, tpu_encode
from video_coding_tpu.entropy.tables import pack_encoder_tables
from video_coding_tpu.model.encoder import Parameters
from video_coding_tpu_torch.entropy import pack_stuff


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.int32) \
        if np.asarray(a).dtype == np.uint32 else np.asarray(a, np.int32)


def _both(c_hi, c_lo, c_len, raw, m_raw, m_out):
    """(port result, reference result) on the same int32 slot arrays."""
    ref = pallas_encode.pack_stuff_pallas(
        jnp.asarray(c_hi.view(np.uint32)), jnp.asarray(c_lo.view(np.uint32)),
        jnp.asarray(c_len), jnp.asarray(raw), m_raw=m_raw, m_out=m_out,
        interpret=True)
    got = pack_stuff.pack_stuff(*(torch.from_numpy(a) for a in
                                  (c_hi, c_lo, c_len, raw)),
                                m_raw=m_raw, m_out=m_out)
    return got, ref


def _assert_equal(got, ref):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert bool(got[2]) == bool(ref[2])
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32


def _symbol_slots(density: float, seed: int, B: int = 6, N: int = 48):
    rng = np.random.default_rng(seed)
    p = Parameters.c420(16, 16, 75)
    tabs = pack_encoder_tables(
        [p.dc_huffman_tables[0].data, p.dc_huffman_tables[1].data],
        [p.ac_huffman_tables[0].data, p.ac_huffman_tables[1].data])
    T = tpu_encode.device_encoder_tables(tabs)
    q = rng.integers(-1000, 1000, size=(N, 64)).astype(np.int32)
    q[rng.random((N, 64)) > density] = 0
    sched = np.resize(np.array([0, 0, 0, 0, 1, 1], np.int32), B)
    prev = np.full(B, -1, np.int32)
    seen = {}
    for i, c in enumerate(sched):
        prev[i] = seen.get(int(c), -1)
        seen[int(c)] = i
    hi, lo, ln = tpu_encode._symbol_parts(
        jnp.asarray(q), jnp.asarray(np.tile(sched, N // B)),
        jnp.asarray(prev), *map(jnp.asarray, T), B)
    S = N // B
    hi, lo, ln = (_i32(x).reshape(S, -1) for x in (hi, lo, ln))
    total = ln.sum(axis=1)
    pad = (-total) & 7
    c_hi = np.concatenate([hi, np.zeros((S, 1), np.int32)], axis=1)
    c_lo = np.concatenate([lo, ((1 << pad) - 1)[:, None].astype(np.int32)],
                          axis=1)
    c_len = np.concatenate([ln, pad[:, None].astype(np.int32)], axis=1)
    return c_hi, c_lo, c_len, ((total + pad) >> 3).astype(np.int32)


@pytest.mark.parametrize("density", [0.05, 0.4, 0.9])
def test_pack_stuff_on_symbol_slots_matches_pallas(density):
    c_hi, c_lo, c_len, raw = _symbol_slots(density, seed=int(density * 100))
    m_raw = 6 * 512 + 64
    got, ref = _both(c_hi, c_lo, c_len, raw, m_raw, m_raw + m_raw // 4 + 8)
    _assert_equal(got, ref)
    assert not bool(got[2])
    # nothing is left pending: the stuffed length covers every raw byte
    assert (got[1].numpy() >= raw).all()


def _synthetic(kind: str):
    rng = np.random.default_rng(len(kind))
    S, K = 5, 40
    c_hi = rng.integers(-2**31, 2**31, (S, K), dtype=np.int64) \
        .astype(np.int32)
    c_lo = rng.integers(-2**31, 2**31, (S, K), dtype=np.int64) \
        .astype(np.int32)
    if kind == "zero lengths":
        c_len = np.zeros((S, K), np.int32)
        c_len[:, ::5] = 8
    elif kind == "exactly 32":
        c_len = np.full((S, K), 32, np.int32)
    elif kind == "33 to 59":
        c_len = rng.integers(33, 60, (S, K)).astype(np.int32)
        c_len[:, -1] = 0
        c_len[:, -1] = (-c_len.sum(axis=1)) & 7
    elif kind == "all ones":
        c_hi[:] = -1
        c_lo[:] = -1
        c_len = rng.integers(0, 60, (S, K)).astype(np.int32)
        c_len[:, -1] = 0
        c_len[:, -1] = (-c_len.sum(axis=1)) & 7
    elif kind == "garbage above the length":
        c_len = rng.integers(0, 12, (S, K)).astype(np.int32)
        c_len[:, -1] = 0
        c_len[:, -1] = (-c_len.sum(axis=1)) & 7
    else:
        raise AssertionError(kind)
    return c_hi, c_lo, c_len, (c_len.sum(axis=1) >> 3).astype(np.int32)


@pytest.mark.parametrize("kind", ["zero lengths", "exactly 32", "33 to 59",
                                  "all ones", "garbage above the length"])
def test_pack_stuff_on_synthetic_slots_matches_pallas(kind):
    c_hi, c_lo, c_len, raw = _synthetic(kind)
    got, ref = _both(c_hi, c_lo, c_len, raw, 4096, 1024)
    _assert_equal(got, ref)
    assert not bool(got[2])
    if kind == "all ones":
        out = got[0].numpy()
        ff = np.flatnonzero(out[0, :-1] == 0xFF)
        assert len(ff) > 10 and (out[0, ff + 1] == 0).all()


def test_garbage_above_the_length_is_masked():
    """Two inputs that differ only at or above each slot's length pack to
    the same bytes."""
    c_hi, c_lo, c_len, raw = _synthetic("garbage above the length")
    keep = ((np.int64(1) << c_len) - 1).astype(np.int64)
    clean_lo = (c_lo.astype(np.int64) & keep).astype(np.int32)
    a = pack_stuff.pack_stuff(*(torch.from_numpy(x) for x in
                                (c_hi, c_lo, c_len, raw)),
                              m_raw=4096, m_out=256)
    b = pack_stuff.pack_stuff(*(torch.from_numpy(x) for x in
                                (np.zeros_like(c_hi), clean_lo, c_len, raw)),
                              m_raw=4096, m_out=256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("m_raw,m_out,expect", [(4096, 1024, False),
                                                (10, 1024, True),
                                                (4096, 37, True)])
def test_overflow_by_m_raw_and_by_m_out_matches_pallas(m_raw, m_out, expect):
    """Bytes past m_out are dropped while the cursor goes on counting."""
    c_hi, c_lo, c_len, raw = _synthetic("all ones")
    got, ref = _both(c_hi, c_lo, c_len, raw, m_raw, m_out)
    _assert_equal(got, ref)
    assert bool(got[2]) is expect
    full, _ = _both(c_hi, c_lo, c_len, raw, 4096, 1024)
    np.testing.assert_array_equal(got[1].numpy(), full[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(),
                                  full[0].numpy()[:, :m_out])


def test_length_outside_the_domain_is_clamped():
    """Lengths lie in 0..59; one outside is clamped into that range."""
    c_hi = np.full((1, 3), 0x12345678, np.int32)
    c_lo = np.full((1, 3), -0x0FEDCBA9, np.int32)
    raw = np.zeros(1, np.int32)

    def run(lens):
        return pack_stuff.pack_stuff(
            torch.from_numpy(c_hi), torch.from_numpy(c_lo),
            torch.tensor([lens], dtype=torch.int32), torch.from_numpy(raw),
            m_raw=64, m_out=64)

    a, b = run([64, -5, 5]), run([59, 0, 5])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_argument_checks():
    z = torch.zeros((2, 3), dtype=torch.int32)
    r = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        pack_stuff.pack_stuff(z, z, z.to(torch.int64), r, m_raw=8, m_out=8)
    with pytest.raises(ValueError):
        pack_stuff.pack_stuff(z, z[:, :2].contiguous(), z, r, m_raw=8,
                              m_out=8)
    with pytest.raises(ValueError):
        pack_stuff.pack_stuff(z, z, z, torch.zeros(3, dtype=torch.int32),
                              m_raw=8, m_out=8)
    with pytest.raises(ValueError):
        pack_stuff.pack_stuff(z, z, z, r, m_raw=8, m_out=0)
    with pytest.raises(ValueError):
        pack_stuff.pack_stuff(z.t(), z.t(), z.t(), r, m_raw=8, m_out=8)
