"""The port's sketch interface (``core.robe.sketch_vector`` /
``unsketch_vector``) and ``core/theory.py`` against the JAX package's, and
the paper's §3 checks (``tests/test_theory.py``, ``tests/test_robe_core.py``'s
sketch cases) on the port.

The sketch is the ROBE hash of each element plus a sign: the port's must
equal the JAX package's bit for bit (f64 sums in the same order), and so
must every theory function on the same inputs.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import theory as jtheory
from repro.core.robe import RobeSpec as JRobeSpec
from repro.core.robe import init_memory as j_init_memory
from repro.core.robe import sketch_vector as j_sketch
from repro.core.robe import unsketch_vector as j_unsketch
from repro_torch.core import theory
from repro_torch.core.robe import (RobeSpec, init_memory, robe_lookup,
                                   robe_slots, sketch_vector,
                                   unsketch_vector)


@pytest.mark.parametrize("size,z,seed,use_sign", [
    (512, 1, 4, True), (257, 16, 1, True), (1000, 8, 3, False),
    (64, 32, 0, True)])
def test_sketch_matches_jax(size, z, seed, use_sign):
    kw = dict(size=size, block_size=z, seed=seed, use_sign=use_sign)
    theta = np.random.RandomState(seed).randn(300)
    got = sketch_vector(theta, RobeSpec(**kw))
    want = j_sketch(theta, JRobeSpec(**kw))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    back = unsketch_vector(got, 300, RobeSpec(**kw))
    np.testing.assert_array_equal(back, j_unsketch(want, 300,
                                                   JRobeSpec(**kw)))


def test_sketch_roundtrip_exact_for_single_occupant_slots():
    spec = RobeSpec(size=512, block_size=1, seed=4)
    n = 300
    theta = np.random.RandomState(0).randn(n)
    back = unsketch_vector(sketch_vector(theta, spec), n, spec)
    slots = robe_slots(spec, 0, torch.arange(n), 1)[:, 0].numpy()
    uniq, counts = np.unique(slots, return_counts=True)
    single = np.isin(slots, uniq[counts == 1])
    assert single.any()
    assert np.allclose(back[single], theta[single])


def test_lookup_matches_unsketch():
    spec = RobeSpec(size=1000, block_size=8, seed=3, use_sign=True)
    mem = init_memory(torch.Generator().manual_seed(0), spec, "cpu")
    out = robe_lookup(mem, spec, 0, torch.arange(50), 16).numpy()
    want = unsketch_vector(mem.numpy(), 800, spec).reshape(50, 16)
    assert np.allclose(out, want)


@pytest.mark.parametrize("seed", range(5))
def test_theory_functions_match_jax(seed):
    rs = np.random.RandomState(seed)
    x, y = rs.randn(96), rs.randn(96)
    assert theory.feature_hashing_variance(x, y, 32) == \
        jtheory.feature_hashing_variance(x, y, 32)
    for z in (1, 4, 32):
        assert theory.robe_variance(x, y, z, 32) == \
            jtheory.robe_variance(x, y, z, 32)
    for use_sign in (True, False):
        np.testing.assert_array_equal(
            theory.inner_product_estimates(x, y, 8, 40, 6, use_sign),
            jtheory.inner_product_estimates(x, y, 8, 40, 6, use_sign))


@pytest.mark.parametrize("log_z,seed", [(1, 0), (2, 7), (3, 11), (4, 500),
                                        (5, 999), (6, 42)])
def test_variance_ordering_formula(log_z, seed):
    """Eq. 22: V_Z <= V_1 for every Z, every vector pair."""
    rs = np.random.RandomState(seed)
    n, m = 128, 32
    x, y = rs.randn(n), rs.randn(n)
    v1 = theory.feature_hashing_variance(x, y, m)
    assert theory.robe_variance(x, y, 2 ** log_z, m) <= v1 + 1e-9
    assert theory.robe_variance(x, y, 1, m) == pytest.approx(v1)


def test_unbiased_and_variance_matches_theory():
    """Monte-Carlo over hash draws: E[<x,y>^] = <x,y>, Var ~ V_Z (Thm 1)."""
    rs = np.random.RandomState(0)
    n, m, n_seeds = 256, 64, 600
    x, y = rs.randn(n), rs.randn(n)
    true = float(np.dot(x, y))
    for z in (1, 4, 16):
        est = theory.inner_product_estimates(x, y, z=z, m=m,
                                             n_seeds=n_seeds, use_sign=True)
        v_theory = theory.robe_variance(x, y, z, m)
        se = np.sqrt(v_theory / n_seeds)
        assert abs(est.mean() - true) < 5 * se, f"Z={z}"
        assert est.var() == pytest.approx(v_theory, rel=0.25), f"Z={z}"


def test_sign_hash_removes_positive_collision_bias():
    rs = np.random.RandomState(2)
    n, m = 256, 32
    x = np.abs(rs.randn(n)) + 0.1
    true = float(np.dot(x, x))
    no_sign = theory.inner_product_estimates(x, x, 8, m, 300, use_sign=False)
    signed = theory.inner_product_estimates(x, x, 8, m, 300, use_sign=True)
    assert no_sign.mean() > true * 1.05
    se = np.sqrt(signed.var() / 300)
    assert abs(signed.mean() - true) < 5 * se


def test_sketch_is_the_lookup_of_jax_memory():
    """The sketch's read direction on a JAX-initialised array equals the
    JAX package's unsketch."""
    spec_kw = dict(size=700, block_size=8, seed=9, use_sign=True)
    mem = np.asarray(j_init_memory(jax.random.PRNGKey(1),
                                   JRobeSpec(**spec_kw)))
    np.testing.assert_array_equal(
        unsketch_vector(mem, 400, RobeSpec(**spec_kw)),
        j_unsketch(mem, 400, JRobeSpec(**spec_kw)))
