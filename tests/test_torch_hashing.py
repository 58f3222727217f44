"""Parity of the port's ROBE hash with the JAX package's.

The port computes the hash in int64; the JAX package in uint32 limbs.  For
the same ``RobeSpec`` both must give the same coefficients and
bit-for-bit the same slots and signs (``torch.equal``), over every block
size the paper uses, dims 1..128 (powers of two and not), row ids near
2^31 - 1 (x*d past 2^32) and several table ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import robe as jr
from repro_torch.core import hashing as th
from repro_torch.core import robe as tr

ROW_PROBES = np.array([0, 1, 2, 39_999_999, 2 ** 31 - 2, 2 ** 31 - 1,
                       123_456_789, 2 ** 30 + 7], np.int32)


@pytest.mark.parametrize("seed,m,salt", [(0, 2, 2), (11, 26_135_627, 1),
                                         (7, 4096, 1), (123, 2 ** 31 - 2, 5)])
def test_uhash_draw_coefficients_equal(seed, m, salt):
    a, b = jh.UHash.draw(seed, m, salt), th.UHash.draw(seed, m, salt)
    assert (a.a_table, a.a2, a.a1, a.a0, a.b, a.m) == b.coefficients()


def test_uhash_raw_matches_on_64bit_keys():
    """The hash itself, on keys spread over all 64 bits' digits."""
    h = jh.UHash.draw(3, 1_000_003, salt=1)
    rs = np.random.RandomState(0)
    keys = np.concatenate([rs.randint(0, 2 ** 62, 200, dtype=np.int64),
                           [0, 2 ** 31 - 1, 2 ** 31, 2 ** 62 - 1, 2 ** 63 - 1]])
    tids = rs.randint(0, 30, keys.shape[0]).astype(np.uint32)
    hi = jnp.asarray((keys >> 32).astype(np.uint32))
    lo = jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32))
    want = np.asarray(h(jnp.asarray(tids), hi, lo)).astype(np.int64)
    got = th.UHash.draw(3, 1_000_003, salt=1)(
        torch.from_numpy(tids.astype(np.int64)), torch.from_numpy(keys))
    assert torch.equal(got, torch.from_numpy(want))


def test_sign_hash_matches_jax():
    rs = np.random.RandomState(1)
    keys = rs.randint(0, 2 ** 40, 64, dtype=np.int64)
    tids = rs.randint(0, 26, 64).astype(np.uint32)
    want = np.asarray(jh.sign_hash(
        jh.UHash.draw(11, 2, salt=2), jnp.asarray(tids),
        jnp.asarray((keys >> 32).astype(np.uint32)),
        jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32))))
    got = th.sign_hash(th.UHash.draw(11, 2, salt=2),
                       torch.from_numpy(tids.astype(np.int64)),
                       torch.from_numpy(keys))
    assert torch.equal(got, torch.from_numpy(np.array(want)))
    assert set(got.tolist()) == {-1.0, 1.0}


def _rows(n_extra: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return np.concatenate([ROW_PROBES,
                           rs.randint(0, 2 ** 31 - 1, n_extra,
                                      dtype=np.int64).astype(np.int32)])


@pytest.mark.parametrize("z", (1, 2, 4, 8, 16, 32))
@pytest.mark.parametrize("dim", (1, 3, 16, 24, 127, 128))
@pytest.mark.parametrize("use_sign", (False, True))
def test_slots_and_signs_match_jax(z, dim, use_sign):
    size = 26_135_627 if z == 32 else 4099 + z
    kw = dict(size=size, block_size=z, seed=11, use_sign=use_sign)
    js, ts = jr.RobeSpec(**kw), tr.RobeSpec(**kw)
    rows = _rows(24, seed=z * 131 + dim).reshape(4, 8)      # [B=4, F=8]
    tids = np.array([0, 1, 5, 25, 2, 3, 100, 7], np.uint32)
    want_slots = np.asarray(jr.robe_slots(js, jnp.asarray(tids)[None, :],
                                          jnp.asarray(rows), dim))
    got_slots = tr.robe_slots(ts, torch.from_numpy(tids.astype(np.int64)
                                                   )[None, :],
                              torch.from_numpy(rows), dim)
    assert torch.equal(got_slots,
                       torch.from_numpy(want_slots.astype(np.int64)))
    assert int(got_slots.min()) >= 0 and int(got_slots.max()) < size
    if use_sign:
        want_signs = np.asarray(jr.robe_signs(js, jnp.asarray(tids)[None, :],
                                              jnp.asarray(rows), dim))
        got_signs = tr.robe_signs(ts, torch.from_numpy(
            tids.astype(np.int64))[None, :], torch.from_numpy(rows), dim)
        assert torch.equal(got_signs, torch.from_numpy(np.array(want_signs)))


@pytest.mark.parametrize("table_id", (0, 1, 13, 25))
def test_scalar_table_id_and_lookup_match_jax(table_id):
    """A scalar table id broadcast over rows, and the gather + sign of the
    plain lookup, against ``repro.core.robe.robe_lookup``."""
    kw = dict(size=8192, block_size=16, seed=7, use_sign=True)
    js, ts = jr.RobeSpec(**kw), tr.RobeSpec(**kw)
    rows = _rows(8, seed=table_id)
    mem = np.random.RandomState(1).randn(8192).astype(np.float32)
    want = np.asarray(jr.robe_lookup(jnp.asarray(mem), js, table_id,
                                     jnp.asarray(rows), 24))
    got = tr.robe_lookup(torch.from_numpy(mem), ts, table_id,
                         torch.from_numpy(rows), 24)
    assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("combiner", ("sum", "mean"))
def test_lookup_bag_matches_jax(combiner):
    kw = dict(size=2048, block_size=8, seed=3, use_sign=True)
    js, ts = jr.RobeSpec(**kw), tr.RobeSpec(**kw)
    rs = np.random.RandomState(4)
    rows = rs.randint(0, 5000, (5, 3, 4)).astype(np.int32)
    rows[0, 0, 2:] = -1
    rows[2, 1, :] = -1                               # empty bag
    w = (rs.rand(5, 3, 4) * 0.3).astype(np.float32)
    mem = rs.randn(2048).astype(np.float32)
    tids = np.array([0, 1, 2], np.uint32)
    want = np.asarray(jr.robe_lookup_bag(
        jnp.asarray(mem), js, jnp.asarray(tids)[None, :], jnp.asarray(rows),
        8, weights=jnp.asarray(w), combiner=combiner))
    got = tr.robe_lookup_bag(
        torch.from_numpy(mem), ts, torch.tensor([0, 1, 2])[None, :],
        torch.from_numpy(rows), 8, weights=torch.from_numpy(w),
        combiner=combiner)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_spec_validation_matches_jax():
    for bad in (dict(size=100, block_size=3), dict(size=16, block_size=16)):
        with pytest.raises(ValueError):
            jr.RobeSpec(**bad)
        with pytest.raises(ValueError):
            tr.RobeSpec(**bad)
    with pytest.raises(ValueError):
        th.UHash.draw(0, 2 ** 31 - 1)
