"""Port K9 (plain version, CPU) against the reference Pallas lookup kernel
in interpret mode and against ``table[idx]``. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_coding_tpu.ops import lookup as jlookup
from video_coding_tpu_torch.ops import lookup


def _pallas(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    k = -(-len(table) // 128)
    tab128 = np.zeros(k * 128, np.int32)
    tab128[:len(table)] = table
    out = jlookup._lookup_pallas(jnp.asarray(tab128.reshape(k, 128)),
                                 jnp.asarray(idx.reshape(-1)),
                                 interpret=True)
    return np.asarray(out).reshape(idx.shape)


def _table(T: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, T, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n", [1, 127, 1000])
@pytest.mark.parametrize("T", [1, 128, 528, 1024])
def test_table_lookup_matches_pallas_and_indexing(T, n):
    table = _table(T, T + n)
    idx = np.random.default_rng(n).integers(0, T, n).astype(np.int32)
    got = lookup.table_lookup(torch.from_numpy(table),
                              torch.from_numpy(idx)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, table[idx])
    np.testing.assert_array_equal(got, _pallas(table, idx))


@pytest.mark.parametrize("T", [1, 100, 528, 1024])
def test_out_of_range_index_gives_zero(T):
    """An index outside [0, T) matches no table row in the Pallas kernel
    and yields 0; the port does the same."""
    table = _table(T, 7) | 1          # no zero entries
    idx = np.array([-1, -129, T, T + 1, 1023, 1024, 5000, 2**31 - 1,
                    -2**31, 0, T - 1], dtype=np.int32)
    got = lookup.table_lookup(torch.from_numpy(table),
                              torch.from_numpy(idx)).numpy()
    inside = (idx >= 0) & (idx < T)
    np.testing.assert_array_equal(got[~inside], 0)
    np.testing.assert_array_equal(got[inside], table[idx[inside]])
    np.testing.assert_array_equal(got, _pallas(table, idx))


def test_shape_is_kept_and_reference_wrapper_agrees():
    table = _table(528, 3)
    idx = np.random.default_rng(3).integers(0, 528, (37, 63)).astype(np.int32)
    got = lookup.table_lookup(torch.from_numpy(table), torch.from_numpy(idx))
    assert tuple(got.shape) == (37, 63)
    ref = jlookup.table_lookup(jnp.asarray(table), jnp.asarray(idx),
                               use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_argument_checks():
    t = torch.zeros(8, dtype=torch.int32)
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        lookup.table_lookup(torch.zeros(1025, dtype=torch.int32), i)
    with pytest.raises(ValueError):
        lookup.table_lookup(torch.zeros(0, dtype=torch.int32), i)
    with pytest.raises(ValueError):
        lookup.table_lookup(t.to(torch.int64), i)
    with pytest.raises(ValueError):
        lookup.table_lookup(t, i.to(torch.int64))
    with pytest.raises(ValueError):
        lookup.table_lookup(t, torch.zeros((4, 4), dtype=torch.int32).t())
