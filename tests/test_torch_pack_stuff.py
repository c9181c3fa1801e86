"""Port K8 (plain version, CPU) against the reference Pallas packer
``pack_stuff_pallas`` in interpret mode, on slots from the reference's
``_symbol_parts`` and on synthetic slots; and a numpy model of the CUDA
kernel's chunked warp packer against both. Tolerance: exact equality of
the whole (S, m_out) byte array, the lengths and the overflow flag."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.entropy import pallas_encode, tpu_encode
from video_coding_tpu.entropy.tables import pack_encoder_tables
from video_coding_tpu.model.encoder import Parameters
from video_coding_tpu_torch.entropy import pack_stuff

from chip_smoke import K8_CASES, k8_budgets, k8_slots


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


# --- K8's chunked warp packer, modelled --------------------------------------

CSRC = pathlib.Path(__file__).resolve().parent.parent / \
    "video_coding_tpu_torch" / "csrc"
M32 = (1 << 32) - 1
M64 = (1 << 64) - 1


def _k8_constants() -> tuple[int, int]:
    """kChunkSlots and kBufWords of csrc/pack_stuff.cu."""
    text = (CSRC / "pack_stuff.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
                 for name in ("kChunkSlots", "kBufWords"))


def _popc(x: int) -> int:
    return bin(x).count("1")


def _put_bits(buf: list, o: int, n: int, hi: int, lo: int) -> None:
    """``put_bits`` as the kernel computes it in 64-bit registers, checked
    against the 96-bit window of words o/32 .. o/32 + 2."""
    v = (((hi & M32) << 32) | (lo & M32)) & ((1 << n) - 1)
    w, s = o >> 5, 96 - (o & 31) - n
    assert 6 <= s <= 95
    if s >= 32:
        top, w2 = (v << (s - 32)) & M64, 0
    else:
        top, w2 = v >> (32 - s), (v << s) & M32
    parts = (top >> 32, top & M32, w2)
    window = v << s
    assert parts == tuple((window >> (64 - 32 * i)) & M32 for i in range(3))
    for i, x in enumerate(parts):
        if x:
            buf[w + i] |= x          # IndexError past the buffer


def _stuff(buf: list, nbits: int, pos: int, write) -> int:
    """``stuff``: a round of 32 words at a time, a word a thread; each
    thread's cursor from three ballots of its 0xFF count; the words are
    cleared as they are read, and the partial byte goes to the head."""
    nbytes, nwords = nbits >> 3, (nbits + 31) >> 5
    head = (buf[nbits >> 5] >> (24 - (nbits & 24))) & 0xFF \
        if nbits & 7 else 0
    for w0 in range(0, nwords, 32):
        xs, ffs = [], []
        for t in range(32):
            w = w0 + t
            x = buf[w] if w < nwords else 0
            if w < nwords:
                buf[w] = 0
            nb = min(max(nbytes - 4 * w, 0), 4)
            ffs.append(sum(1 << b for b in range(nb)
                           if (x >> (24 - 8 * b)) & 0xFF == 0xFF))
            xs.append((x, nb))
        nff = [_popc(f) for f in ffs]
        m = [sum(((n >> i) & 1) << t for t, n in enumerate(nff))
             for i in range(3)]
        for t, ((x, nb), ff) in enumerate(zip(xs, ffs)):
            lt = (1 << t) - 1
            p = pos + 4 * t + sum(_popc(m[i] & lt) << i for i in range(3))
            for b in range(nb):
                write(p, (x >> (24 - 8 * b)) & 0xFF)
                if (ff >> b) & 1:
                    write(p + 1, 0)
                    p += 1
                p += 1
        pos += min(nbytes - 4 * w0, 128) + sum(_popc(m[i]) << i
                                               for i in range(3))
    assert not any(buf)
    buf[0] = head << 24
    return pos


def _packer_model(c_hi, c_lo, c_len, raw, m_raw, m_out):
    """K8's ``pack_stuff_kernel`` lane by lane: chunks of kChunkSlots slots
    (slot c0 + 32·j + t to thread t), bit offsets from two warp scans of
    packed 16-bit pairs after the bits already in the buffer, the slots'
    bits OR-ed into a buffer of kBufWords words; once the buffer holds more
    than kFlushBits bits, and at the lane's end, the completed bytes are
    stuffed at the cursor with bytes at or past m_out dropped and the
    partial byte moved to the buffer's head; then the zero tail. Every
    byte of every row must be written exactly once."""
    chunk, n_words = _k8_constants()
    flush = 32 * n_words - chunk * 59
    S, K = c_len.shape
    out = np.full((S, m_out), 0xA5, np.uint8)
    writes = np.zeros((S, m_out), np.int64)
    out_lens = np.zeros(S, np.int32)
    for s in range(S):
        def write(p, byte):
            if p < m_out:
                out[s, p] = byte
                writes[s, p] += 1

        buf, pos, nbits = [0] * n_words, 0, 0
        for c0 in range(0, K, chunk):
            ln = np.zeros(chunk, np.int64)
            part = c_len[s, c0:c0 + chunk]
            ln[:len(part)] = np.clip(part, 0, 59)
            grid = ln.reshape(-1, 32)                  # [j, t]
            x01 = np.cumsum(grid[0] | grid[1] << 16)
            x23 = np.cumsum(grid[2] | grid[3] << 16)
            assert x01[-1] < 1 << 32 and x23[-1] < 1 << 32
            incl = np.stack([x01 & 0xFFFF, x01 >> 16, x23 & 0xFFFF,
                             x23 >> 16])
            r = incl[:, -1]
            if r.sum() == 0:
                continue
            off = nbits + np.concatenate([[0], np.cumsum(r)[:-1]])[:, None] \
                + incl - grid
            nbits += int(r.sum())
            for j, t in zip(*np.nonzero(grid)):
                k = c0 + 32 * j + t
                _put_bits(buf, int(off[j, t]), int(grid[j, t]),
                          int(c_hi[s, k]), int(c_lo[s, k]))
            if nbits > flush:
                pos = _stuff(buf, nbits, pos, write)
                nbits &= 7
        pos = _stuff(buf, nbits, pos, write)
        for p in range(min(pos, m_out), m_out):
            write(p, 0)
        out_lens[s] = pos
    assert (writes == 1).all()
    overflow = bool((raw > m_raw).any() or (out_lens > m_out).any())
    return out, out_lens, overflow


def _model_plain_pallas(c_hi, c_lo, c_len, raw, m_raw, m_out):
    """The model against the plain version and, where every length lies in
    0..59 (the reference does not clamp), the Pallas kernel."""
    model = _packer_model(c_hi, c_lo, c_len, raw, m_raw, m_out)
    plain = pack_stuff.pack_stuff_plain(
        *(torch.from_numpy(a) for a in (c_hi, c_lo, c_len, raw)),
        m_raw=m_raw, m_out=m_out)
    np.testing.assert_array_equal(model[0], plain[0].numpy())
    np.testing.assert_array_equal(model[1], plain[1].numpy())
    assert model[2] == bool(plain[2])
    if c_len.min() >= 0 and c_len.max() <= 59:
        _assert_equal(plain, _both(c_hi, c_lo, c_len, raw, m_raw, m_out)[1])
    return model


@pytest.mark.parametrize("case", K8_CASES)
def test_packer_model_matches_plain_and_pallas(case):
    """Slots at K8's edges (chip_smoke.k8_slots) over three chunks, at a
    budget that fits, one a byte short in m_raw and an m_out that cuts the
    longest lanes inside a chunk."""
    chunk, _ = _k8_constants()
    rng = np.random.default_rng(K8_CASES.index(case))
    c_hi, c_lo, c_len, raw = k8_slots(case, 5, 2 * chunk + 45, rng)
    results = [_model_plain_pallas(c_hi, c_lo, c_len, raw, m_raw, m_out)
               for m_raw, m_out in k8_budgets(raw)]
    assert [r[2] for r in results] == [False, True, True]
    if case in ("dense 0xFF", "0xFF across chunks"):
        out = results[0][0]
        ff = np.flatnonzero(out[0, :-1] == 0xFF)
        assert len(ff) > 8 and (out[0, ff + 1] == 0).all()
    # an m_out cut drops bytes, never the count
    np.testing.assert_array_equal(results[2][1], results[0][1])


@pytest.mark.parametrize("S,K", [(1, 1), (3, 1), (4, 127), (2, 129),
                                 (9, 257)])
def test_packer_model_on_odd_shapes(S, K):
    """K = 1, odd K on either side of a chunk edge, one lane and lanes not a
    multiple of a CTA's."""
    rng = np.random.default_rng(S * 1000 + K)
    c_hi, c_lo, c_len, raw = k8_slots("mixed", S, K, rng)
    c_len = np.clip(c_len, 0, 59)
    raw = (c_len.sum(axis=1) >> 3).astype(np.int32)
    for m_raw, m_out in k8_budgets(raw):
        _model_plain_pallas(c_hi, c_lo, c_len, raw, m_raw, m_out)


def test_packer_model_on_symbol_slots():
    """Slots from the reference's symbol construction (a pad slot ends
    every lane on a byte boundary)."""
    c_hi, c_lo, c_len, raw = _symbol_slots(0.4, seed=7)
    m_raw = int(raw.max())
    model = _model_plain_pallas(c_hi, c_lo, c_len, raw, m_raw,
                                2 * m_raw + 8)
    assert not model[2] and (model[1] >= raw).all()
