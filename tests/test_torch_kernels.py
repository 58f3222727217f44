"""Parity of the port's serve-path kernel functions with the JAX package's.

On the CPU the port's ops run the plain versions (``kernels/ref.py``); the
Hopper kernels themselves run only on a CUDA card (``chip_smoke.py`` holds
them against these plain versions there).  Here each plain version is
held against ``repro.kernels.ops.*(..., use_kernel=True)`` -- the Pallas
kernel in interpret mode, as ``tests/test_kernel_conformance.py`` runs it
-- and against ``repro.kernels.ref``, on the same numpy inputs.

Tolerances: gathers match exactly (robe, qrobe, and qr in f32); f32
within rtol = atol = 1e-5; bf16 within 1e-2 (the two sides round bf16 at
other places).  A CPU call must launch no kernel: every ``launches`` count
stays 0.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.robe import RobeSpec as JRobeSpec
from repro.core.robe import robe_signs as jrobe_signs
from repro.core.robe import robe_slots as jrobe_slots
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn.embedding_backends.hashed import qr_layout
from repro.nn.embedding_backends.qrobe import GROUP_LOG2
from repro.nn.embedding_backends.tt import factor_dim, factor_rows
from repro_torch import kernels as tk
from repro_torch.configs.recsys_archs import SMOKE_VOCABS
from repro_torch.core.robe import RobeSpec as TRobeSpec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.tt_lookup import (ANY_WARPS, MAX_SMEM, RANKS, WARPS,
                                           plan)

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test here runs on the CPU: no kernel may be launched."""
    tk.reset_launches()
    yield
    counts = tk.launch_counts()
    assert len(counts) == len(tk.CUDA_KERNELS)
    assert all(n == 0 for n in counts.values()), counts


def _specs(z: int, use_sign: bool, size: int = 4096):
    kw = dict(size=size, block_size=z, seed=7, use_sign=use_sign)
    return JRobeSpec(**kw), TRobeSpec(**kw)


def _t(a: np.ndarray, dt: str = "f32") -> torch.Tensor:
    """numpy (f32 or int) -> torch, rounding to bf16 the way jnp does."""
    if a.dtype.kind == "f":
        return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dt: str) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


# ---------------------------------------------------------------------------
# robe_lookup: [B, F] rows -> [B, F, dim]
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,f,dim,z", [
    (16, 3, 24, 16),      # general regime (Z < d), d not a multiple of 128
    (13, 4, 16, 16),      # aligned regime (Z % d == 0), prime batch
    (7, 2, 8, 32),        # aligned, Z > d
    (11, 3, 128, 32),     # the full model's regime: Z=32 < d=128
    (5, 6, 40, 1),        # Z = 1: every element hashed alone
])
@pytest.mark.parametrize("use_sign", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_robe_lookup_matches_pallas_and_ref(b, f, dim, z, use_sign, dt):
    js, ts = _specs(z, use_sign)
    rs = np.random.RandomState(b * 7 + dim)
    rows = rs.randint(0, 40_000_000, (b, f)).astype(np.int32)
    rows[0, 0] = 2 ** 31 - 1                    # x*d past 2^32
    mem = rs.randn(4096).astype(np.float32)
    jmem = jnp.asarray(mem, JDT[dt])
    tids = tuple(range(f))
    got = tops.robe_lookup(_t(mem, dt), _t(rows), tids, dim, ts)
    assert got.shape == (b, f, dim) and got.dtype == TDT[dt]
    kernel = jops.robe_lookup(jmem, jnp.asarray(rows), tids, dim, js, True)
    ref = jref.robe_lookup_ref(jmem, jnp.asarray(rows),
                               jnp.arange(f, dtype=jnp.uint32), dim, js)
    # a gather and a ±1 multiply: exactly equal
    np.testing.assert_array_equal(_np(got), _np(kernel))
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_robe_lookup_field_subset_uses_given_table_ids():
    js, ts = _specs(8, True)
    rs = np.random.RandomState(0)
    rows = rs.randint(0, 1000, (6, 2)).astype(np.int32)
    mem = rs.randn(4096).astype(np.float32)
    got = tops.robe_lookup(_t(mem), _t(rows), (3, 5), 16, ts)
    want = jops.robe_lookup(jnp.asarray(mem), jnp.asarray(rows), (3, 5), 16,
                            js, False)
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# dot_interaction: [B, F, D] -> [B, F(F∓1)/2]
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,f,d", [(16, 3, 24), (13, 27, 128), (7, 5, 40),
                                   (1, 2, 1),
                                   # ragged edges of the 4x4 register tiles
                                   (5, 9, 3), (3, 33, 130)])
@pytest.mark.parametrize("self_interaction", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_dot_interaction_matches_pallas_and_ref(b, f, d, self_interaction,
                                                dt):
    feats = np.random.RandomState(b + f + d).randn(b, f, d).astype(np.float32)
    jf = jnp.asarray(feats, JDT[dt])
    got = tops.dot_interaction(_t(feats, dt), self_interaction)
    n = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    assert got.shape == (b, n) and got.dtype == TDT[dt]
    _close(got, jops.dot_interaction(jf, self_interaction, True), dt)
    _close(got, jref.dot_interaction_ref(jf, self_interaction), dt)


def test_dot_interaction_is_in_tril_order():
    """Pair p is (i, j) of np.tril_indices: (1,0), (2,0), (2,1), (3,0)..."""
    f, d = 5, 3
    feats = torch.zeros(1, f, d)
    for i in range(f):
        feats[0, i, 0] = float(2 ** i)          # <e_i, e_j> = 2^(i+j)
    got = tops.dot_interaction(feats)[0]
    rows, cols = np.tril_indices(f, k=-1)
    assert got.tolist() == [float(2 ** (i + j)) for i, j in zip(rows, cols)]


# ---------------------------------------------------------------------------
# serve_fused: idx [B, F(, bag)] + bot [B, d] -> [B, (F+1)F/2]
# ---------------------------------------------------------------------------

def _serve_inputs(b, f, bag, dim, seed):
    rs = np.random.RandomState(seed)
    shape = (b, f) if bag == 0 else (b, f, bag)
    idx = rs.randint(0, 37, shape).astype(np.int32)
    if bag:
        idx[0, 0, 1:] = -1
        idx[-1, f - 1, :] = -1                   # an empty bag pools to zero
        idx[rs.rand(*shape) < 0.2] = -1
    mem = rs.randn(4096).astype(np.float32)
    bot = rs.randn(b, dim).astype(np.float32)
    return idx, mem, bot


@pytest.mark.parametrize("b,f,bag,dim,z", [
    (16, 3, 0, 24, 16),   # [B, F] ids, the conformance harness's case
    (13, 4, 0, 16, 16),   # prime batch, aligned regime
    (7, 3, 0, 40, 16),    # d not a multiple of 128
    (6, 4, 3, 24, 16),    # bag > 1 with -1 pads and an empty bag
    (5, 3, 2, 128, 32),   # the full model's regime, bags
    (6, 5, 3, 40, 16),    # Z=16 < d=40: rows span three or four blocks
    (3, 9, 2, 130, 32),   # d past 128: the kernel hashes in two chunks
])
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_serve_fused_matches_pallas_and_ref(b, f, bag, dim, z, dt):
    js, ts = _specs(z, True)
    idx, mem, bot = _serve_inputs(b, f, bag, dim, seed=b * f + bag)
    tids = tuple(range(f))
    got = tops.serve_fused(_t(mem, dt), _t(idx), _t(bot, dt), tids, dim, ts)
    assert got.shape == (b, (f + 1) * f // 2) and got.dtype == TDT[dt]
    jmem, jbot = jnp.asarray(mem, JDT[dt]), jnp.asarray(bot, JDT[dt])
    kernel = jops.serve_fused(jmem, jnp.asarray(idx), jbot, tids, dim, js,
                              True)
    ref = jref.serve_fused_ref(jmem, jnp.asarray(idx), jbot,
                               jnp.arange(f, dtype=jnp.uint32), dim, js)
    _close(got, kernel, dt)
    _close(got, ref, dt)


def test_serve_fused_rounds_pooled_once_to_bot_dtype():
    """f32 memory, bf16 bot: the f32 bag sum enters the gram rounded once
    to bf16 -- the same as pooling in f32, casting, then the plain dot."""
    _, ts = _specs(16, False)
    idx, mem, bot = _serve_inputs(6, 4, 3, 24, seed=9)
    m, i, bt = _t(mem), _t(idx), _t(bot, "bf16")
    got = tops.serve_fused(m, i, bt, tuple(range(4)), 24, ts)
    pooled = tops.robe_lookup(m, i.clamp_min(0).transpose(1, 2).reshape(
        -1, 4), tuple(range(4)), 24, ts).reshape(6, 3, 4, 24).transpose(1, 2)
    pooled = (pooled * (i >= 0)[..., None]).sum(dim=2).to(torch.bfloat16)
    want = tops.dot_interaction(torch.cat([bt[:, None], pooled], dim=1))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the compressed substrates' lookups, on the conformance harness's cases
# (tests/test_kernel_conformance.py): VOCABS, QR_M, TT_RANK, dim 24
# ---------------------------------------------------------------------------

VOCABS = (40, 24, 64)
QR_M = 8
TT_RANK = 4


def _ids(b: int, vocabs, seed: int) -> np.ndarray:
    """[b, F] ids per field, the last sample at each field's largest id."""
    rs = np.random.RandomState(seed)
    idx = np.stack([rs.randint(0, v, b) for v in vocabs], axis=1)
    idx[-1] = np.asarray(vocabs) - 1
    return idx.astype(np.int32)


@pytest.mark.parametrize("b,dim,z", [
    (16, 24, 16),         # the harness's case: general layout (Z < d)
    (13, 24, 16),         # prime batch
    (16, 8, 8),           # aligned layout (Z % d == 0), test_qrobe's case
    (11, 128, 32),        # the full model's regime
])
@pytest.mark.parametrize("use_sign", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_qrobe_lookup_matches_pallas_and_ref(b, dim, z, use_sign, dt):
    """int8 codes, per-group scales in ``dt``: exactly equal, the group
    taken from the wrapped slot (|M| = 4000 leaves a partial last group)."""
    size, f = 4000, len(VOCABS)
    kw = dict(size=size, block_size=z, seed=7, use_sign=use_sign)
    js, ts = JRobeSpec(**kw), TRobeSpec(**kw)
    rs = np.random.RandomState(b + dim)
    codes = rs.randint(-127, 128, size).astype(np.int8)
    n_grp = -(-size // (1 << GROUP_LOG2))
    scale = (np.abs(rs.randn(n_grp)) * 0.05 + 0.01).astype(np.float32)
    rows = _ids(b, VOCABS, seed=b)
    rows[0] = [2 ** 31 - 1, 2 ** 31 - 2, 2 ** 30]     # x*d past 2^32
    tids = tuple(range(f))
    got = tops.qrobe_lookup(_t(codes), _t(scale, dt), _t(rows), tids, dim,
                            ts, GROUP_LOG2)
    assert got.shape == (b, f, dim) and got.dtype == TDT[dt]
    jc, jsc = jnp.asarray(codes), jnp.asarray(scale, JDT[dt])
    kernel = jops.qrobe_lookup(jc, jsc, jnp.asarray(rows), tids, dim, js,
                               GROUP_LOG2, True)
    ref = jref.qrobe_lookup_ref(jc, jsc, jnp.asarray(rows),
                                jnp.arange(f, dtype=jnp.uint32), dim, js,
                                GROUP_LOG2)
    np.testing.assert_array_equal(_np(got), _np(kernel))
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("b,dim,z", [
    (13, 24, 16),         # Z < d, d not a multiple of Z's span
    (13, 16, 16),         # Z = d
    (7, 8, 32),           # Z > d: rows share blocks
    (11, 40, 1),          # Z = 1: every element hashed alone
    (5, 130, 32),         # a second chunk of 2 elements
])
@pytest.mark.parametrize("use_sign", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_qrobe_lookup_with_delta_matches_jax_sum(b, dim, z, use_sign, dt):
    """The op's delta term equals the JAX backend's two-op sum: the qrobe
    lookup, plus ``take(delta, robe_slots) · robe_signs`` rounded into the
    output's dtype, added in it.  |M| = 4000 leaves a partial last group."""
    size, f = 4000, len(VOCABS)
    kw = dict(size=size, block_size=z, seed=5, use_sign=use_sign)
    js, ts = JRobeSpec(**kw), TRobeSpec(**kw)
    rs = np.random.RandomState(b * 3 + dim + z)
    codes = rs.randint(-127, 128, size).astype(np.int8)
    n_grp = -(-size // (1 << GROUP_LOG2))
    scale = (np.abs(rs.randn(n_grp)) * 0.05 + 0.01).astype(np.float32)
    delta = (rs.randn(size) * 0.02).astype(np.float32)
    rows = _ids(b, VOCABS, seed=b + 1)
    rows[0] = [2 ** 31 - 1, 2 ** 31 - 2, 2 ** 30]     # x*d past 2^32
    tids = tuple(range(f))
    got = tops.qrobe_lookup(_t(codes), _t(scale, dt), _t(rows), tids, dim,
                            ts, GROUP_LOG2, delta=_t(delta))
    assert got.shape == (b, f, dim) and got.dtype == TDT[dt]
    jt = jnp.arange(f, dtype=jnp.uint32)[None, :]
    jr = jnp.asarray(rows)
    out = jref.qrobe_lookup_ref(jnp.asarray(codes), jnp.asarray(scale, JDT[dt]),
                                jr, jnp.arange(f, dtype=jnp.uint32), dim, js,
                                GROUP_LOG2)
    d = jnp.take(jnp.asarray(delta),
                 jrobe_slots(js, jt, jr, dim).astype(jnp.int32), axis=0)
    if use_sign:
        d = d * jrobe_signs(js, jt, jr, dim)
    np.testing.assert_array_equal(_np(got), _np(out + d.astype(out.dtype)))
    without = tops.qrobe_lookup(_t(codes), _t(scale, dt), _t(rows), tids, dim,
                                ts, GROUP_LOG2)
    assert not torch.equal(got, without)


def test_qrobe_dequant_ref_matches_jax():
    rs = np.random.RandomState(3)
    codes = rs.randint(-127, 128, 1000).astype(np.int8)
    scale = rs.rand(4).astype(np.float32)
    got = tref.qrobe_dequant_ref(_t(codes), _t(scale), GROUP_LOG2)
    want = jref.qrobe_dequant_ref(jnp.asarray(codes), jnp.asarray(scale),
                                  GROUP_LOG2)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("b,dim,m", [
    (16, 24, QR_M),       # the harness's case
    (13, 24, QR_M),       # prime batch
    (16, 24, 7),          # m not a power of two
    (11, 128, 16),        # the full model's width
])
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_qr_lookup_matches_pallas_and_ref(b, dim, m, dt):
    f = len(VOCABS)
    q_rows, q_off, r_off = qr_layout(VOCABS, m)
    qo, ro = tuple(map(int, q_off)), tuple(map(int, r_off))
    rs = np.random.RandomState(b + m)
    q = rs.randn(sum(q_rows), dim).astype(np.float32)
    r = rs.randn(m * f, dim).astype(np.float32)
    idx = _ids(b, VOCABS, seed=m)
    got = tops.qr_lookup(_t(q, dt), _t(r, dt), _t(idx), qo, ro, m)
    assert got.shape == (b, f, dim) and got.dtype == TDT[dt]
    jq, jr = jnp.asarray(q, JDT[dt]), jnp.asarray(r, JDT[dt])
    kernel = jops.qr_lookup(jq, jr, jnp.asarray(idx), qo, ro, m, True)
    ref = jref.qr_lookup_ref(jq, jr, jnp.asarray(idx), qo, ro, m)
    if dt == "f32":       # one f32 product: exactly equal
        np.testing.assert_array_equal(_np(got), _np(kernel))
        np.testing.assert_array_equal(_np(got), _np(ref))
    else:
        _close(got, kernel, dt)
        _close(got, ref, dt)


@pytest.mark.parametrize("b,dim,rank", [
    (16, 24, TT_RANK),    # the harness's case: (d1, d2, d3) = (2, 3, 4)
    (13, 24, TT_RANK),    # prime batch
    (16, 16, 8),          # dim 16 at the backend's default rank 8: d1 = 1
    (13, 18, 8),          # (2, 3, 3): d3 not a multiple of four
    (16, 24, 3),          # a rank with no instance of its own
])
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_tt_lookup_matches_pallas_and_ref(b, dim, rank, dt):
    f = len(VOCABS)
    factors = factor_rows(sum(VOCABS))
    n1, n2, n3 = factors
    d1, d2, d3 = factor_dim(dim)
    offsets = tuple(int(o) for o in
                    np.concatenate([[0], np.cumsum(VOCABS)[:-1]]))
    rs = np.random.RandomState(b + dim + rank)
    cores = (rs.randn(n1, d1, rank).astype(np.float32),
             rs.randn(n2, rank, d2, rank).astype(np.float32),
             rs.randn(n3, rank, d3).astype(np.float32))
    idx = _ids(b, VOCABS, seed=dim)
    got = tops.tt_lookup(*(_t(c, dt) for c in cores), _t(idx), offsets,
                         factors, dim)
    assert got.shape == (b, f, dim) and got.dtype == TDT[dt]
    jc = [jnp.asarray(c, JDT[dt]) for c in cores]
    kernel = jops.tt_lookup(*jc, jnp.asarray(idx), offsets, factors, dim,
                            True)
    ref = jref.tt_lookup_ref(*jc, jnp.asarray(idx), offsets, factors, dim)
    _close(got, kernel, dt)
    _close(got, ref, dt)


def test_index_helpers_match_jax():
    idx = _ids(9, VOCABS, seed=4)
    for m in (QR_M, 7):
        q_rows, q_off, r_off = qr_layout(VOCABS, m)
        got = tref.qr_indices(_t(idx), q_off, r_off, m)
        want = jref.qr_indices(jnp.asarray(idx), q_off, r_off, m)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    factors = factor_rows(sum(VOCABS))
    offsets = np.concatenate([[0], np.cumsum(VOCABS)[:-1]])
    got = tref.tt_indices(_t(idx), offsets, factors)
    want = jref.tt_indices(jnp.asarray(idx), offsets, factors)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# ---------------------------------------------------------------------------
# tt_lookup's index split without a division, and the choice of instance
# ---------------------------------------------------------------------------

def split_rows(g, factors) -> tuple:
    """(i1, i2, i3) of global rows ``g`` (below 2^32) computed as
    ``tt_divmod`` in csrc/tt_lookup.cu computes them, with no division: for
    a radix m > 1 and c = ceil(2^64 / m) (``_build.fastmod_const``), the
    quotient is the high half of c·g and the remainder ((c·g mod 2^64)·m)
    >> 64, both from 32-bit halves; a radix of 1 gives g and 0."""
    from repro_torch.kernels import _build
    g = np.asarray(g, dtype=np.uint64)
    s32, lo32 = np.uint64(32), np.uint64(0xFFFFFFFF)

    def hi64(a, x):         # (a * x) >> 64 for a < 2^64, x < 2^32
        return ((a >> s32) * x + (((a & lo32) * x) >> s32)) >> s32

    def divmod_fast(x, m: int):
        if m == 1:
            return x, np.zeros_like(x)
        c = np.uint64(_build.fastmod_const(m))
        return hi64(c, x), hi64(c * x, np.uint64(m))   # c * x wraps

    _, n2, n3 = (int(n) for n in factors)
    rest, i3 = divmod_fast(g, n3)
    i1, i2 = divmod_fast(rest, n2)
    return tuple(i.astype(np.int64) for i in (i1, i2, i3))


@pytest.mark.parametrize("factors", [
    (589, 589, 589),                              # dlrm-criteo-tb, full
    factor_rows(sum(SMOKE_VOCABS)),               # the smoke configs
    factor_rows(sum(VOCABS)),                     # the harness's
    (7, 1, 3), (2, 5, 1),                         # radices of 1
])
def test_tt_split_rows_matches_floor_division(factors):
    """The kernel's quotient and remainder by multiplies (split_rows
    emulates it) equal // and % at the edges of the mixed radix and at
    10^5 seeded random rows."""
    n1, n2, n3 = factors
    total = n1 * n2 * n3
    edges = np.array([0, n3 - 1, n3, n2 * n3 - 1, total - 1])
    g = np.concatenate([edges[edges >= 0], np.random.RandomState(
        total % 2 ** 31).randint(0, total, 100_000)]).astype(np.int64)
    i1, i2, i3 = split_rows(g, factors)
    np.testing.assert_array_equal(i3, g % n3)
    np.testing.assert_array_equal(i2, (g // n3) % n2)
    np.testing.assert_array_equal(i1, g // n3 // n2)
    # and the port's own plain split agrees
    got = tref.tt_indices(torch.from_numpy(g[:, None].astype(np.int32)),
                          (0,), factors)
    for a, b in zip(got, (i1, i2, i3)):
        np.testing.assert_array_equal(a.numpy()[:, 0], b)


def test_tt_split_rows_is_exact_below_2_to_the_32():
    g = np.concatenate([np.arange(2 ** 32 - 4096, 2 ** 32),
                        np.arange(2 ** 31 - 2048, 2 ** 31 + 2048)])
    for m in (589, 3, 2 ** 31 - 1, 2 ** 16 + 1):
        _, i2, i3 = split_rows(g, (1, m, m))
        np.testing.assert_array_equal(i3, g % m)
        np.testing.assert_array_equal(i2, (g // m) % m)


@pytest.mark.parametrize("dims,rank,itemsize,aligned,want", [
    # full dlrm-criteo-tb width: a lane per row pair (a, b), (a+1, b), so
    # eight lanes and four items a warp, each slot 64 + 2,048 + 256 bytes,
    # two buffers, two warps a block
    ((2, 8, 8), 8, 4, True, (8, 2 * 2 * 4 * 2368)),
    ((2, 8, 8), 8, 2, True, (8, 2 * 2 * 4 * 1184)),
    ((2, 3, 4), 4, 4, True, (4, 2 * 2 * 10 * (32 + 192 + 64))),
    # d3 = 3 in bf16: slices padded to 16 bytes each
    ((2, 3, 3), 8, 2, True, (8, 2 * 2 * 10 * (32 + 384 + 48))),
    # d1 = 1: one real row a pair
    ((1, 4, 4), 8, 4, True, (8, 2 * 2 * 8 * (32 + 1024 + 128))),
    # 32 row pairs: one item a warp, a lane one pair
    ((8, 8, 8), 8, 4, True, (8, 2 * 2 * 1 * 2560)),
    # no instance: rank 3, or cores off 16-byte alignment
    ((2, 3, 4), 3, 4, True, (0, 4 * 8 * (6 + 27 + 12 + 18))),
    ((2, 8, 8), 8, 4, False, (0, 4 * 8 * (16 + 512 + 64 + 128))),
])
def test_tt_plan_picks_instance_by_shape(dims, rank, itemsize, aligned, want):
    assert plan(*dims, rank, itemsize, aligned) == want


def test_tt_plan_reports_a_block_too_large_for_the_card():
    """When no path fits, plan says so and the wrapper raises before any
    launch (its smem check)."""
    inst, smem = plan(2, 256, 8, 8, 4)
    assert inst == 0 and smem > MAX_SMEM


def test_tt_constants_match_the_kernel_source():
    """WARPS, ANY_WARPS, RANKS and MAX_SMEM of kernels/tt_lookup.py are the
    constants csrc/tt_lookup.cu and csrc/robe_common.cuh build with."""
    import re
    from repro_torch.kernels import _build
    tt = (_build.CSRC / "tt_lookup.cu").read_text()
    common = (_build.CSRC / "robe_common.cuh").read_text()

    def const(name, text):
        return re.search(r"constexpr \w+ " + name + r"(\[\])? = ([^;]+);",
                         text).group(2)
    assert int(const("kWarps", tt)) == WARPS
    assert int(const("kAnyWarps", tt)) == ANY_WARPS
    assert tuple(int(r) for r in const("kRanks", tt).strip("{}").split(",")) \
        == RANKS
    a, b = const("kSmemLimit", common).split("*")
    assert int(a) * int(b) == MAX_SMEM


# ---------------------------------------------------------------------------
# the kernels' `% m` without a division: Lemire's fastmod constant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [
    26_135_627,           # |M| of dlrm-criteo-tb at 1000x
    4096, 4000,           # the test and smoke sizes
    2,                    # the sign hash
    1,
    2 ** 31 - 2, 2 ** 31 - 1,
])
def test_fastmod_constant_matches_python_mod(m):
    """((c * r) mod 2^64) * m >> 64 == r % m for the constant the launchers
    receive, at the edges of the M31 residues the hash reduces."""
    from repro_torch.kernels import _build
    c = _build.fastmod_const(m)
    assert 0 <= c < 2 ** 64
    rs_vals = [int(v) for v in
               np.random.RandomState(m % 2 ** 32).randint(0, 2 ** 31 - 1, 64)]
    for r in [0, 1, m - 1, m, m + 1, 2 ** 31 - 2, 2 ** 32 - 1] + rs_vals:
        assert (((c * r) % 2 ** 64) * m) >> 64 == r % m, (m, r)


def test_hash_args_carry_fastmod_constants():
    from repro_torch.kernels import _build
    _, ts = _specs(16, True, size=26_135_627)
    coeffs, tids = _build.hash_args(ts, (0, 3))
    vals = list(coeffs)
    assert len(vals) == 14 and list(tids) == [0, 3]
    for h, part in ((ts.hash_fn(), vals[:7]), (ts.sign_fn(), vals[7:])):
        assert tuple(part[:6]) == h.coefficients()
        assert part[6] == _build.fastmod_const(h.m)
    with pytest.raises(ValueError):
        _build.fastmod_const(0)


# ---------------------------------------------------------------------------
# the plain backwards against the JAX package's custom-VJP backwards, called
# directly (the autograd path through them is in tests/test_torch_train.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,f,dim,z", [(17, 3, 24, 16), (7, 2, 8, 32),
                                       (11, 3, 40, 1), (5, 3, 130, 32)])
@pytest.mark.parametrize("use_sign", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_robe_lookup_bwd_ref_matches_jax_lookup_bwd(b, f, dim, z, use_sign,
                                                    dt):
    js, ts = _specs(z, use_sign, size=509)
    rs = np.random.RandomState(b + dim)
    rows = rs.randint(0, 40_000_000, (b, f)).astype(np.int32)
    g = rs.randn(b, f, dim).astype(np.float32)
    tids = tuple(range(f))
    got = tref.robe_lookup_bwd_ref(_t(g, dt), _t(rows), tids, dim, ts)
    want, none = jops._lookup_bwd(tids, dim, js, False,
                                  (jnp.asarray(rows), 509),
                                  jnp.asarray(g, JDT[dt]))
    assert none is None and got.dtype == TDT[dt] and got.shape == (509,)
    # the scatter's bound: 1e-5 (f32) or 1e-2 (bf16) of the sum of |g| a
    # slot receives, plus 1e-7
    a = tref.robe_lookup_bwd_ref(_t(np.abs(g), dt), _t(rows), tids, dim,
                                 _specs(z, False, size=509)[1])
    rel = 1e-5 if dt == "f32" else 1e-2
    assert (np.abs(_np(got) - _np(want)) <= rel * _np(a) + 1e-7).all()


@pytest.mark.parametrize("b,f,d", [(16, 3, 24), (13, 27, 128), (5, 9, 3),
                                   (1, 2, 1)])
@pytest.mark.parametrize("self_interaction", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_dot_interaction_bwd_ref_matches_jax_dot_bwd(b, f, d,
                                                     self_interaction, dt):
    rs = np.random.RandomState(b * f + d)
    feats = rs.randn(b, f, d).astype(np.float32)
    n = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
    g = rs.randn(b, n).astype(np.float32)
    got = tref.dot_interaction_bwd_ref(_t(g, dt), _t(feats, dt),
                                       self_interaction)
    (want,) = jops._dot_bwd(self_interaction, False,
                            (jnp.asarray(feats, JDT[dt]),),
                            jnp.asarray(g, JDT[dt]))
    assert got.dtype == TDT[dt] and got.shape == (b, f, d)
    _close(got, want, dt)


def test_interaction_sym_doubles_the_diagonal():
    g = torch.arange(1.0, 7.0)[None, :]              # F = 3 with diagonal
    sym = tref.interaction_sym(g, 3, True)[0]
    # pairs (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) -> 1..6
    want = torch.tensor([[2.0, 2.0, 4.0], [2.0, 6.0, 5.0], [4.0, 5.0, 12.0]])
    assert torch.equal(sym, want)
    strict = tref.interaction_sym(torch.tensor([[1.0, 2.0, 3.0]]), 3, False)
    assert torch.equal(strict[0], torch.tensor(
        [[0.0, 1.0, 2.0], [1.0, 0.0, 3.0], [2.0, 3.0, 0.0]]))


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain path, other devices raise, and
# every op has a backward
# ---------------------------------------------------------------------------

def test_ops_refuse_backward():
    """Every op now has a backward: each of the four that were forward
    only (``serve_fused``, ``qrobe_lookup``, ``qr_lookup``, ``tt_lookup``)
    runs one and gives its inputs' gradients, with ``robe_lookup`` and
    ``dot_interaction`` as before; none refuses (the plain backwards are
    held against the JAX package in tests/test_torch_substrate_train.py)."""
    _, ts = _specs(16, False)
    mem = torch.randn(4096, requires_grad=True)
    rows = torch.randint(0, 100, (3, 2), dtype=torch.int32)
    tops.robe_lookup(mem, rows, (0, 1), 16, ts).sum().backward()
    assert mem.grad.shape == (4096,)
    feats = torch.randn(3, 4, 8, requires_grad=True)
    tops.dot_interaction(feats).sum().backward()
    assert feats.grad.shape == (3, 4, 8)
    codes = torch.zeros(4096, dtype=torch.int8)
    codes[::3] = 5
    scale = torch.ones(16, requires_grad=True)
    delta = torch.zeros(4096, requires_grad=True)
    cores = [torch.randn(s, requires_grad=True)
             for s in ((4, 2, 3), (4, 3, 2, 3), (4, 3, 2))]
    q, r = (torch.randn(5, 8, requires_grad=True),
            torch.randn(8, 8, requires_grad=True))
    ids = torch.randint(0, 8, (3, 2), dtype=torch.int32)
    bot = torch.randn(3, 16, requires_grad=True)
    outs = {
        "serve_fused": (tops.serve_fused(mem, rows, bot, (0, 1), 16, ts),
                        (mem, bot)),
        "qrobe_lookup": (tops.qrobe_lookup(codes, scale, rows, (0, 1), 16, ts,
                                           GROUP_LOG2, delta=delta),
                         (scale, delta)),
        "qr_lookup": (tops.qr_lookup(q, r, ids, (0, 3), (0, 4), 4), (q, r)),
        "tt_lookup": (tops.tt_lookup(*cores, ids, (0, 10), (4, 4, 4), 8),
                      tuple(cores)),
    }
    for name, (out, inputs) in outs.items():
        grads = torch.autograd.grad(out.sum(), inputs)
        for x, g in zip(inputs, grads):
            assert g.shape == x.shape and g.dtype == x.dtype, name
            assert torch.isfinite(g).all() and bool(g.any()), name


def test_backward_saves_nothing_without_grad():
    """Under inference mode (the serve path) and for inputs that need no
    grad, the ops keep nothing for a backward."""
    _, ts = _specs(16, False)
    rows = torch.randint(0, 100, (3, 2), dtype=torch.int32)
    with torch.inference_mode():
        out = tops.robe_lookup(torch.randn(4096, requires_grad=True), rows,
                               (0, 1), 16, ts)
        gram = tops.dot_interaction(torch.randn(3, 4, 8, requires_grad=True))
    assert out.grad_fn is None and gram.grad_fn is None
    assert tops.robe_lookup(torch.randn(4096), rows, (0, 1), 16,
                            ts).grad_fn is None


def test_ops_reject_other_devices():
    _, ts = _specs(16, False)
    mem = torch.randn(4096, device="meta")
    rows = torch.zeros((3, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.robe_lookup(mem, rows, (0, 1), 16, ts)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches only on CUDA tensors; a CPU tensor raises before
    the library is built."""
    _, ts = _specs(16, False)
    mem = torch.randn(4096)
    rows = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tk.robe_lookup_cuda(mem, rows, (0, 1), 16, ts)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dot_interaction_cuda(torch.randn(2, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tk.serve_fused_cuda(mem, rows, torch.randn(3, 16), (0, 1), 16, ts)
    codes = torch.zeros(4096, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tk.qrobe_lookup_cuda(codes, torch.ones(16), rows, (0, 1), 16, ts,
                             GROUP_LOG2)
    with pytest.raises(ValueError, match="CUDA"):
        tk.qrobe_lookup_cuda(codes, torch.ones(16), rows, (0, 1), 16, ts,
                             GROUP_LOG2, delta=torch.zeros(4096))
    # a delta that is not [|M|] f32, contiguous, on the codes' device
    for bad in (torch.zeros(4096, dtype=torch.float64),
                torch.zeros(4096, dtype=torch.bfloat16),
                torch.zeros(4095), torch.zeros(4096, 1),
                torch.zeros(8192)[::2],
                torch.zeros(4096, device="meta")):
        with pytest.raises(ValueError, match="delta must be"):
            tk.qrobe_lookup_cuda(codes, torch.ones(16), rows, (0, 1), 16, ts,
                                 GROUP_LOG2, delta=bad)
    with pytest.raises(ValueError, match="CUDA"):
        tk.qr_lookup_cuda(torch.randn(5, 8), torch.randn(8, 8), rows, (0, 3),
                          (0, 4), 4)
    cores = (torch.randn(4, 2, 3), torch.randn(4, 3, 2, 3),
             torch.randn(4, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        tk.tt_lookup_cuda(*cores, rows, (0, 10), (4, 4, 4), 8)


def test_backward_wrappers_refuse_cpu_tensors():
    """The backward kernels' wrappers launch only on CUDA tensors; a CPU
    tensor raises before the library is built."""
    _, ts = _specs(16, True)
    rows = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tk.robe_lookup_bwd_cuda(torch.randn(3, 2, 16), rows, (0, 1), 16, ts)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dot_interaction_bwd_cuda(torch.randn(2, 3), torch.randn(2, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tk.qrobe_lookup_bwd_cuda(torch.randn(3, 2, 16),
                                 torch.zeros(4096, dtype=torch.int8), rows,
                                 (0, 1), 16, ts, GROUP_LOG2)
    with pytest.raises(ValueError, match="CUDA"):
        tk.qr_lookup_bwd_cuda(torch.randn(3, 2, 8), torch.randn(5, 8),
                              torch.randn(8, 8), rows, (0, 3), (0, 4), 4)
    cores = (torch.randn(4, 2, 3), torch.randn(4, 3, 2, 3),
             torch.randn(4, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        tk.tt_lookup_bwd_cuda(torch.randn(3, 2, 8), *cores, rows, (0, 10),
                              (4, 4, 4))
    from repro_torch.kernels.serve_fused import serve_fused_bwd_cuda
    with pytest.raises(ValueError, match="CUDA"):
        serve_fused_bwd_cuda(torch.randn(3, 3), torch.randn(4096), rows,
                             torch.randn(3, 16), (0, 1), 16, ts)


def test_substrate_bwd_layouts_match_the_kernel_sources():
    """The scratch of the substrates' backward sorts and tt's walk plan,
    as the wrappers size them, are what csrc/row_sort.cuh and
    csrc/tt_lookup_bwd.cu compute: a 4-byte count a key, a 4-byte sum a
    4,096-key tile of the scan and an 8-byte (item, key) pair an item, each
    256-byte aligned; the ranked walk's constants, its choice of shapes, its
    (i2, i3) sort keys and its shared memory (8 core0 slots a group of 8
    lanes, four groups a warp, eight warps, and a block copy of core0's
    gradient up to 16,384 floats); the first design's walks, 8 warps a
    block at most, fewer when a warp's f32 stage is large, g's row staged
    only while 8 warps fit; and the QR walk's slots within static shared
    memory."""
    import importlib
    from repro_torch.kernels import _build
    tt = importlib.import_module("repro_torch.kernels.tt_lookup")
    sort_src = (_build.CSRC / "row_sort.cuh").read_text()
    tt_src = (_build.CSRC / "tt_lookup_bwd.cu").read_text()
    qr_src = (_build.CSRC / "qr_lookup_bwd.cu").read_text()
    assert "return rs_align(4 * (size_t)n_keys) + rs_align(4 * " \
        "(size_t)rs_tiles(n_keys)) + rs_align(8 * (size_t)n_items);" in \
        " ".join(sort_src.split())
    assert _const("kRsScanThreads", sort_src) * 4 == _build.SORT_TILE == 4096
    assert "constexpr int kRsTile = 4 * kRsScanThreads;" in sort_src
    # 589 keys: one tile; tt's (i2, i3) keys at full width: 85 tiles
    assert _build.row_sort_bytes(589, 65536 * 26) == \
        2560 + 256 + 13_631_488
    assert _build.row_sort_bytes(589 * 589, 65536 * 26) == \
        1_387_776 + 512 + 13_631_488
    assert _build.row_sort_bytes(1, 1) == 768
    assert _const("kWalkWarps", tt_src) == tt.BWD_WALK_WARPS == 8
    assert _const("kTbWarps", tt_src) == tt.BWD_WARPS
    assert _const("kTbLanes", tt_src) == tt.BWD_LANES == 8
    assert _const("kTbSlots", tt_src) == tt.BWD_SLOTS <= tt.BWD_LANES
    assert _const("kTbMaxCopy", tt_src) == tt.BWD_MAX_COPY
    assert _const("kTbMaxRow3", tt_src) == tt.BWD_MAX_ROW3 == 64
    assert "constexpr long long kTbMaxKeys = 1LL << 24;" in tt_src
    assert tt.BWD_MAX_KEYS == 1 << 24
    assert "constexpr int kTbRanks[] = {4, 8};" in tt_src and RANKS == (4, 8)
    # full width: the ranked walk, sorted by (i2, i3), with 32 groups of 8
    # slots of 16 floats and core0's 589 x 16 floats in a block
    assert tt.bwd_plan(2, 8, 8, 8, 589, 589, 589) == \
        (8, 4 * (32 * 8 * 16 + 589 * 16), 589 * 589, True, 8)
    # TT_SHAPES of chip_smoke.py: ranks 4 and 8 on the ranked walk, 3 not
    assert tt.bwd_plan(2, 3, 4, 4, 589, 589, 589).instance == 4
    assert tt.bwd_plan(2, 3, 3, 8, 589, 589, 589).instance == 8
    assert tt.bwd_plan(1, 4, 4, 8, 589, 589, 589).instance == 8
    assert tt.bwd_plan(2, 3, 4, 3, 589, 589, 589).instance == 0
    # core0 too large for a block copy: slots only
    assert tt.bwd_plan(2, 8, 8, 8, 2000, 589, 589).smem == 4 * 32 * 8 * 16
    # d1 > 2, d2 > 8, r * d3 past 64 or not a multiple of 8, n2 * n3 past
    # 2^24: the first design, sorted by each core's rows
    for shape in ((3, 3, 3, 8), (2, 9, 2, 8), (2, 2, 16, 8), (2, 2, 3, 4)):
        plan_ = tt.bwd_plan(*shape, 589, 589, 589)
        assert plan_.instance == 0 and plan_.keys == 589, shape
    assert tt.bwd_plan(2, 8, 8, 8, 4, 5000, 5000).instance == 0
    # first design, full width: g's row (128), the slices (16, 512, 64), t
    # (128) and the largest row (512): 1,360 floats a warp, eight warps
    assert tt.bwd_plan(2, 8, 8, 3)[3:] == (True, 8)
    assert tt.bwd_plan(1, 1, 1, 1)[3:] == (True, 8)
    # 64,000-wide rows: g is read through L1, and 8 warps still fit
    assert tt.bwd_plan(8, 8, 1000, 1)[3:] == (False, 8)
    # the backward takes every shape the forward takes, its any-rank path's
    # widest items and dims far past a warp's shared memory included
    for d1, d2, d3, r in itertools.product((1, 2, 8, 64), (1, 8, 64),
                                           (1, 3, 8, 700), (1, 3, 8, 16)):
        if tt.plan(d1, d2, d3, r, 4, aligned=False)[1] <= _build.MAX_SMEM:
            assert tt.bwd_plan(d1, d2, d3, r).warps >= 1, (d1, d2, d3, r)
    # the QR walk: a power-of-two slot count, its slots and dR stage of
    # four elements a lane within a block's 48 KB of static shared memory
    slots = _const("kQSlots", qr_src)
    assert slots & (slots - 1) == 0
    assert _const("kWalkWarps", qr_src) * (slots + 1) * 32 * 4 * 4 <= 48 * 1024
    assert _const("kRsChunk", sort_src) == 128


def test_tt_bwd_split_fills_the_card():
    """The ranked walk's grid is the blocks the card holds at once (one an
    SM at full width), no more than give each group of 8 lanes a place, and
    its groups share the sorted places by proportion: at B = 512 every one
    of the 132 SMs gets a block and every group at least one place; every
    place belongs to exactly one group."""
    import importlib
    tt = importlib.import_module("repro_torch.kernels.tt_lookup")
    n = 512 * 26
    blocks, groups, most = tt.bwd_split(n, 132)
    assert (blocks, groups, most) == (132, 132 * 32, 4)
    assert n // groups >= 1
    # the first design's walk: 128 places a warp, 8 warps a block
    assert -(-n // (128 * 8)) == 13
    assert tt.bwd_split(65536 * 26, 132) == (132, 4224, 404)
    assert tt.bwd_split(26, 132) == (1, 32, 1)
    for n_items, resident in ((13_312, 132), (1_703_936, 132), (26, 132),
                              (1000, 7), (5, 1)):
        blocks, groups, most = tt.bwd_split(n_items, resident)
        cover = [0] * n_items
        for k in range(groups):
            lo, hi = k * n_items // groups, (k + 1) * n_items // groups
            assert hi - lo <= most
            for t in range(lo, hi):
                cover[t] += 1
        assert cover == [1] * n_items


def _tt_walk_mirror(g, cores, idx, offsets, factors, groups, seed=0):
    """The ranked walk of csrc/tt_lookup_bwd.cu in Python: the items sorted
    by (i2, i3) (in an arbitrary order within a key), ``groups`` groups of
    32 a block taking the places by proportion; a group sums dc2 while i2
    repeats and dc3 while i3 repeats, sending each on when its row
    changes; dc1 while i1 repeats, then parked in the group's slot i1 %
    kTbSlots (a slot holding another row sends that row into the block's
    copy of core0's gradient first), the slots and then the block copy
    sent on at the end.  Returns the three gradients and, per core, the
    most gradient atomics one row received."""
    from repro_torch.kernels import _build
    slots_n = _const("kTbSlots", (_build.CSRC / "tt_lookup_bwd.cu")
                     .read_text())
    c0, c1, c2 = (c.double() for c in cores)
    g = g.double().reshape(-1, c0.shape[1], c1.shape[2], c2.shape[2])
    i1, i2, i3 = (i.reshape(-1).long()
                  for i in tref.tt_indices(idx, offsets, factors))
    n3 = factors[2]
    gen = torch.Generator().manual_seed(seed)
    tie = torch.rand(len(i1), generator=gen, dtype=torch.float64)
    order = sorted(range(len(i1)),
                   key=lambda t: (int(i2[t]) * n3 + int(i3[t]), tie[t]))
    ws = [torch.zeros_like(c) for c in (c0, c1, c2)]
    hits = [torch.zeros(c.shape[0], dtype=torch.int64) for c in (c0, c1, c2)]
    n = len(order)
    copy = None
    for gid in range(groups):
        if gid % 32 == 0:
            if copy is not None:
                ws[0] += copy
                hits[0] += (copy != 0).flatten(1).any(1)
            copy = torch.zeros_like(c0)
        run = {0: None, 1: None, 2: None}
        acc = {0: 0, 1: 0, 2: 0}
        slots = [None] * slots_n

        def send(k, row, val):
            ws[k][row] += val
            hits[k][row] += 1

        def park(row, val):
            s = row % slots_n
            if slots[s] is not None and slots[s][0] == row:
                slots[s][1] += val
                return
            if slots[s] is not None:
                copy[slots[s][0]] += slots[s][1]
            slots[s] = [row, val]

        for t in order[gid * n // groups:(gid + 1) * n // groups]:
            a, b, c = int(i1[t]), int(i2[t]), int(i3[t])
            x1, x2, x3 = c0[a], c1[b], c2[c]
            tt_ = torch.einsum("ap,pbq->abq", x1, x2)
            dt = torch.einsum("abc,qc->abq", g[t], x3)
            parts = {0: torch.einsum("abq,pbq->ap", dt, x2),
                     1: torch.einsum("ap,abq->pbq", x1, dt),
                     2: torch.einsum("abq,abc->qc", tt_, g[t])}
            for k, row in ((0, a), (1, b), (2, c)):
                if run[k] != row:
                    if run[k] is not None:
                        (park if k == 0 else
                         lambda r, v, k=k: send(k, r, v))(run[k], acc[k])
                    run[k], acc[k] = row, 0
                acc[k] = acc[k] + parts[k]
        for k in (1, 2):
            if run[k] is not None:
                send(k, run[k], acc[k])
        if run[0] is not None:
            park(run[0], acc[0])
        for slot in slots:
            if slot is not None:
                copy[slot[0]] += slot[1]
    ws[0] += copy
    hits[0] += (copy != 0).flatten(1).any(1)
    return ws, [int(h.max()) for h in hits]


@pytest.mark.parametrize("dims,rank,groups", [
    ((2, 3, 4), 4, 32), ((2, 2, 2), 8, 64), ((1, 3, 8), 8, 96)])
def test_tt_bwd_walk_mirror_matches_plain_version(dims, rank, groups):
    """A Python mirror of the ranked walk (one sort by (i2, i3), dc2 summed
    per i2 run, dc3 per i3 run, dc1 per i1 run parked in a group's slots
    and a block's copy of core0), summing in f64, equals tt_lookup_bwd_ref
    (f32) on small cores whose ids repeat (a zipf-like head and one field
    at a single id), within the kernel's bound 1e-5·A + 1e-7 (A the plain
    version on |g| and |cores|); and no core0 row receives more than one
    atomic a block, however many items it takes."""
    factors = (4, 5, 3)
    d1, d2, d3 = dims
    rng = np.random.default_rng(11)
    offsets = (0, 17, 41)
    vocab = factors[0] * factors[1] * factors[2] - offsets[-1]
    ids = np.minimum(rng.zipf(1.3, size=(40, 3)) - 1, vocab - 1)
    ids[:, 1] = 5
    idx = torch.from_numpy(ids.astype(np.int32))
    cores = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((factors[0], d1, rank), (factors[1], rank, d2, rank),
                       (factors[2], rank, d3))]
    g = torch.from_numpy(rng.standard_normal((40, 3, d1 * d2 * d3))
                         .astype(np.float32))
    got, most = _tt_walk_mirror(g, cores, idx, offsets, factors, groups)
    want = tref.tt_lookup_bwd_ref(g, *cores, idx, offsets, factors)
    mag = tref.tt_lookup_bwd_ref(g.abs(), *(c.abs() for c in cores), idx,
                                 offsets, factors)
    for x, y, a in zip(got, want, mag):
        assert bool(((x - y.double()).abs() <= 1e-5 * a + 1e-7).all())
    assert most[0] <= groups // 32


def _qr_walk_mirror(g, q_table, r_table, idx, q_off, r_off, m, chunk,
                    seed=0):
    """The walk of csrc/qr_lookup_bwd.cu in Python: the items sorted by R
    row (in an arbitrary order within a key) and taken ``chunk`` places at
    a time; a chunk sums dR while r repeats and dQ while q repeats, parking
    a finished q's sum in slot q % kQSlots (a slot holding another row
    sends it on first), sending dR on when r changes and every slot at the
    end.  Returns (dQ, dR) and the most atomics one Q row received."""
    from repro_torch.kernels import _build
    slots_n = _const("kQSlots", (_build.CSRC / "qr_lookup_bwd.cu")
                     .read_text())
    qi, ri = (i.reshape(-1).long()
              for i in tref.qr_indices(idx, q_off, r_off, m))
    g = g.double().reshape(-1, q_table.shape[1])
    qt, rt = q_table.double(), r_table.double()
    gen = torch.Generator().manual_seed(seed)
    tie = torch.rand(len(qi), generator=gen, dtype=torch.float64)
    order = sorted(range(len(qi)), key=lambda t: (int(ri[t]), tie[t]))
    dq, dr = torch.zeros_like(qt), torch.zeros_like(rt)
    q_hits = torch.zeros(len(qt), dtype=torch.int64)
    for lo in range(0, len(order), chunk):
        slots = [None] * slots_n
        rcur = qcur = None
        racc = qacc = 0

        def park():
            s = qcur % slots_n
            if slots[s] is not None and slots[s][0] == qcur:
                slots[s][1] += qacc
                return
            if slots[s] is not None:
                dq[slots[s][0]] += slots[s][1]
                q_hits[slots[s][0]] += 1
            slots[s] = [qcur, qacc]

        for t in order[lo:lo + chunk]:
            r, q = int(ri[t]), int(qi[t])
            if r != rcur:
                if rcur is not None:
                    dr[rcur] += racc
                rcur, racc = r, 0
            racc = racc + g[t] * qt[q]
            if q != qcur:
                if qcur is not None:
                    park()
                qcur, qacc = q, 0
            qacc = qacc + g[t] * rt[r]
        dr[rcur] += racc
        park()
        for slot in slots:
            if slot is not None:
                dq[slot[0]] += slot[1]
                q_hits[slot[0]] += 1
    return dq, dr, int(q_hits.max())


@pytest.mark.parametrize("m,chunk", [(1, 32), (3, 32), (4, 128), (64, 32)])
def test_qr_bwd_walk_mirror_matches_plain_version(m, chunk):
    """A Python mirror of the QR walk (one sort by R row, dR summed per R
    run, dQ per q run parked in a direct-mapped table of kQSlots rows with
    eviction) equals qr_lookup_bwd_ref on small tables whose ids repeat:
    m = 1 (one R row a field), m above every vocab (one Q row a field), a
    multi-Q-row field at one id; summing in f64, within the kernel's bound
    1e-5·A + 1e-7 of the plain version (f32; A on |g|, |Q|, |R|).  A
    single-Q-row field's row receives at most ceil(items / chunk) + 1
    atomics."""
    vocabs = (50, 9, 40, 30)
    q_rows, q_off, r_off = qr_layout(vocabs, m)
    rng = np.random.default_rng(5)
    b = 300
    ids = np.stack([np.minimum(rng.zipf(1.2, size=b) - 1, v - 1)
                    for v in vocabs], axis=1)
    ids[:, 3] = 7
    idx = torch.from_numpy(ids.astype(np.int32))
    dim = 6
    qt = torch.from_numpy(rng.standard_normal((sum(q_rows), dim))
                          .astype(np.float32))
    rt = torch.from_numpy(rng.standard_normal((len(vocabs) * m, dim))
                          .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, len(vocabs), dim))
                         .astype(np.float32))
    dq, dr, most = _qr_walk_mirror(g, qt, rt, idx, tuple(q_off),
                                   tuple(r_off), m, chunk)
    args = (idx, tuple(q_off), tuple(r_off), m)
    want = tref.qr_lookup_bwd_ref(g, qt, rt, *args)
    mag = tref.qr_lookup_bwd_ref(g.abs(), qt.abs(), rt.abs(), *args)
    for x, y, a in zip((dq, dr), want, mag):
        assert bool(((x - y.double()).abs() <= 1e-5 * a + 1e-7).all())
    if m > max(vocabs):   # every field one Q row: chunks bound its atomics
        assert most <= -(-b * len(vocabs) // chunk) + 1


def _const(name: str, text: str) -> int:
    import re
    return int(re.search(r"constexpr [\w ]+ " + name + r" = (\w+);",
                         text).group(1), 0)


def test_dot_interaction_bwd_constants_match_the_kernel_source():
    """The wrapper's plan repeats the kernel's layout: its constants are
    the ones csrc/dot_interaction_bwd.cu and csrc/robe_common.cuh build
    with, and its shared-memory bytes add up as the kernel's regions do."""
    import importlib
    import re
    from repro_torch.kernels import _build
    di = importlib.import_module("repro_torch.kernels.dot_interaction")
    src = (_build.CSRC / "dot_interaction_bwd.cu").read_text()
    common = (_build.CSRC / "robe_common.cuh").read_text()
    assert _const("kMaxWin", src) == di.BWD_MAX_WIN
    assert _const("kMaxThreads", src) == di.BWD_MAX_THREADS
    assert _const("kRows", src) == 4
    assert _const("kZero", src) == di.SYM_ZERO
    assert _const("kDiag", src) == di.SYM_DIAG
    assert re.search(r"kSmemLimit = (\d+) \* 1024;", common).group(1) == \
        str(_build.MAX_SMEM // 1024)
    # F = 27, D = 128, f32: two stages of g's 351-entry row (+8, rounded to
    # 16 bytes) and a [27][128] window, sym's [27][28] slice, the 16-bit
    # map [27][28] rounded to 16 bytes
    assert di.bwd_smem_bytes(27, 128) == \
        2 * (1440 + 4 * 27 * 128) + 4 * 27 * 28 + 1520 == 35072
    # bf16: rows 8 elements wider, and the widened f32 window
    assert di.bwd_smem_bytes(27, 128, itemsize=2) == \
        2 * (720 + 2 * 27 * 136) + 4 * 27 * 128 + 4 * 27 * 28 + 1520
    # D past 128 is taken in windows of 128 columns
    assert di.bwd_smem_bytes(3, 1000) == \
        2 * (48 + 4 * 3 * 128) + 4 * 3 * 4 + 32


@pytest.mark.parametrize("f,d,self_int,itemsize,want", [
    # full width: one unit a sample, a thread per 4 x 4 tile (7 x 32)
    (27, 128, False, 4, (2, 28, 128, 224, 35072)),
    (27, 128, True, 2, (2, 28, 128, 224, 34624)),
    # the quickstart's interaction: 2 x 4 tiles, one warp
    (5, 16, False, 4, (2, 8, 16, 32, 1040)),
    # D = 3 and 130: windows rounded up to 8 columns, at most 128
    (2, 3, True, 4, (2, 4, 8, 32, 272)),
    (9, 130, False, 4, (2, 12, 128, 96, 10224)),
    # larger F: narrower column windows, then one stage and row windows
    (120, 128, False, 4, (2, 120, 64, 256, 205024)),
    (200, 128, False, 4, (1, 64, 16, 64, 223632)),
    (235, 128, False, 4, (1, 4, 8, 32, 232224)),
])
def test_dot_interaction_bwd_plan_by_shape(f, d, self_int, itemsize, want):
    from repro_torch.kernels.dot_interaction import bwd_plan
    assert tuple(bwd_plan(f, d, self_int, itemsize)) == want


def test_dot_interaction_bwd_plan_reports_a_shape_too_large():
    """Past the largest F a block holds, the plan says so and the wrapper
    raises before any launch; every F below it fits."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dot_interaction import bwd_plan
    fits = [f for f in range(1, 300)
            if bwd_plan(f, 128).smem <= _build.MAX_SMEM]
    assert fits == list(range(1, 236))
    assert bwd_plan(236, 128).smem > _build.MAX_SMEM


@pytest.mark.parametrize("f", list(range(1, 34)))
@pytest.mark.parametrize("self_int", (False, True))
def test_bwd_sym_map_gathers_interaction_sym(f, self_int):
    """Gathering g through the kernel's sym map (its Python mirror) gives
    kernels/ref.py's interaction_sym: zero where the map says so, twice g
    on the flagged diagonal."""
    from repro_torch.kernels.dot_interaction import (SYM_DIAG, SYM_ZERO,
                                                     bwd_sym_map)
    n_pairs = f * (f + 1) // 2 if self_int else f * (f - 1) // 2
    g = torch.from_numpy(np.random.RandomState(f).randn(3, n_pairs)
                         .astype(np.float32))
    np_ = -(-f // 4) * 4
    m = torch.tensor(bwd_sym_map(f, self_int)).view(f, np_)
    assert int(m.max()) <= (SYM_ZERO if f > 1 or self_int or np_ > f
                            else 0)
    zero, diag = m == SYM_ZERO, (m & SYM_DIAG).bool() & (m != SYM_ZERO)
    idx = torch.where(zero, 0, m & ~SYM_DIAG).long()
    if n_pairs:
        assert int(idx.max()) < n_pairs
        got = torch.where(zero, 0.0, g[:, idx] * torch.where(diag, 2.0, 1.0))
    else:
        got = torch.zeros(3, f, np_)
    assert bool(diag.diagonal()[:f].all()) == self_int
    want = tref.interaction_sym(g, f, self_int)
    torch.testing.assert_close(got[:, :, :f], want, rtol=0, atol=0)
    assert bool(zero[:, f:].all())


def test_robe_lookup_bwd_constants_match_the_kernel_source():
    """BAND_LOG2, MAX_BUCKETS and MAX_SEG_LOG2 of kernels/robe_lookup.py
    are the constants csrc/robe_lookup_bwd.cu builds with (from the
    scatter's header, csrc/robe_scatter.cuh, which it alone includes)."""
    import importlib
    from repro_torch.kernels import _build
    rl = importlib.import_module("repro_torch.kernels.robe_lookup")
    assert '#include "robe_scatter.cuh"' in (
        _build.CSRC / "robe_lookup_bwd.cu").read_text()
    assert [p.name for p in sorted(_build.CSRC.iterdir())
            if '#include "robe_scatter.cuh"' in p.read_text()] == \
        ["robe_lookup_bwd.cu"]
    src = (_build.CSRC / "robe_scatter.cuh").read_text()
    assert _const("kBandLog2", src) == rl.BAND_LOG2
    assert _const("kMaxBuckets", src) == rl.MAX_BUCKETS
    assert _const("kSegLog2", src) == rl.MAX_SEG_LOG2
    assert _const("kSortBlocks", src) == rl.SORT_BLOCKS
    assert _const("kSortThreads", src) == rl.SORT_THREADS
    assert _const("kStagePairs", src) == rl.STAGE_PAIRS
    # 2^22 f32 slots a band: 16 MiB, a third of the H100's 50 MB L2
    assert 4 << rl.BAND_LOG2 == 16 * 2 ** 20


@pytest.mark.parametrize("size,f,items,dim,z,want", [
    # full width: 7 bands of 2^22 slots, 4 pairs an item; 256 sort blocks'
    # counts of 182 buckets, then 6,815,744 first slots and sorted pairs
    (26_135_627, 26, 65536 * 26, 128, 32,
     (5, 4, 22, 7, 182, 256, 186_368 + 256 + 27_262_976 + 54_525_952)),
    # the quickstart: one band, one pair an item (d = 16 inside Z = 32)
    (18_400, 4, 4096, 16, 32, (5, 1, 22, 1, 4, 8, 256 + 256 + 16384 +
                                                   32768)),
    # Z = 16 < d = 24: an item starts mid-block, so up to 3 pairs
    (4096, 26, 509 * 26, 24, 16, (4, 3, 22, 1, 26, 26,
                                  2816 + 256 + 158_976 + 317_696)),
    # Z = 1: a pair an element; Z = 64 > 32: pairs of 32 inside a block
    (4096, 3, 10, 40, 1, (0, 40, 22, 1, 3, 1, 256 + 256 + 1792 + 3328)),
    (4096, 3, 10, 130, 64, (5, 6, 22, 1, 3, 1, 256 + 256 + 256 + 512)),
    # a band edge inside M: 2^22 + 1 slots make two bands
    (2 ** 22 + 1, 26, 26, 128, 32, (5, 4, 22, 2, 52, 1,
                                    256 + 256 + 512 + 1024)),
    # bands widen where bands x fields would pass MAX_BUCKETS
    (2 ** 31 - 1, 128, 128, 128, 32, (5, 4, 26, 32, 4096, 1,
                                      16384 + 256 + 2048 + 4096)),
])
def test_robe_lookup_bwd_plan(size, f, items, dim, z, want):
    from repro_torch.kernels.robe_lookup import bwd_plan
    spec = TRobeSpec(size=size, block_size=z, seed=0)
    assert tuple(bwd_plan(spec, f, items, dim)) == want


def test_qrobe_lookup_bwd_constants_match_the_kernel_source():
    """BAND_LOG2 and MAX_SEG_LOG2 of kernels/qrobe_lookup.py are the
    constants csrc/qrobe_lookup_bwd.cu builds with; it takes its count,
    scan, place and rounding passes from csrc/row_sort.cuh (the pair sort
    rs_seg_sort, with no copy of its own), not robe_lookup_bwd's scatter,
    and has no pass over all of |M|."""
    import importlib
    from repro_torch.kernels import _build
    ql = importlib.import_module("repro_torch.kernels.qrobe_lookup")
    src = (_build.CSRC / "qrobe_lookup_bwd.cu").read_text()
    assert '#include "robe_scatter.cuh"' not in src
    assert '#include "row_sort.cuh"' in src
    assert "qrobe_group_kernel" not in src
    assert "rs_seg_sort(QbKey{" in src and "__match_any_sync(" not in src
    assert _const("kBandLog2", src) == ql.BAND_LOG2
    assert _const("kSegLog2", src) == ql.MAX_SEG_LOG2
    # a pair's W <= 32 slots start in one band: a band's pairs update one
    # window of two 32-slot lines
    assert 1 << ql.MAX_SEG_LOG2 <= 1 << ql.BAND_LOG2 == 32
    sort_src = (_build.CSRC / "row_sort.cuh").read_text()
    assert _const("kRsScanThreads", sort_src) * 4 == _build.SORT_TILE
    assert "rs_seg_pass_kernel" in sort_src


@pytest.mark.parametrize("size,items,dim,z,gl,want", [
    # full width: 4 pairs an item; 816,739 bands of 32 slots (200 tiles of
    # the scan), 6,815,744 sorted pair indices, 102,093 scale groups
    (26_135_627, 65536 * 26, 128, 32, 8,
     (5, 4, 816_739, 200, 102_093,
      3_267_072 + 1024 + 27_262_976 + 408_576)),
    # the quickstart's 18,400-slot array: one pair an item (d = 16 < Z)
    (18_400, 4096, 16, 32, 8, (5, 1, 575, 1, 72, 2304 + 256 + 16384 + 512)),
    # Z = 16 < d = 24: an item starts mid-block, so up to 3 pairs
    (4096, 509 * 26, 24, 16, 8, (4, 3, 128, 1, 16,
                                 512 + 256 + 158_976 + 256)),
    # Z = 1: a pair an element; Z = 64 > 32: pairs of 32 inside a block
    (4096, 10, 40, 1, 8, (0, 40, 128, 1, 16, 512 + 256 + 1792 + 256)),
    (4096, 10, 130, 64, 8, (5, 6, 128, 1, 16, 512 + 256 + 256 + 256)),
    # |M| = 2^22 + 1: one slot past a power of two opens a band, a scan
    # tile and a scale group of their own; at G = 0 a group a slot
    (2 ** 22 + 1, 26, 128, 32, 8, (5, 4, 131_073, 33, 16_385,
                                   524_544 + 256 + 512 + 65_792)),
    (2 ** 22 + 1, 26, 128, 32, 0, (5, 4, 131_073, 33, 2 ** 22 + 1,
                                   524_544 + 256 + 512 + 16_777_472)),
])
def test_qrobe_lookup_bwd_plan(size, items, dim, z, gl, want):
    from repro_torch.kernels.qrobe_lookup import bwd_plan
    spec = TRobeSpec(size=size, block_size=z, seed=0)
    assert tuple(bwd_plan(spec, items, dim, gl)) == want


def _qrobe_walk_mirror(g, codes, rows, tids, dim, spec, gl, chunk, seed=0):
    """The order and walk of csrc/qrobe_lookup_bwd.cu in Python: every
    (item, segment) pair ordered by band of its first slot (slot0 >> 5, in
    an arbitrary order within a band), taken ``chunk`` places a warp; a
    warp sums a band's pairs into a window of 64 slots from the band's
    first (lane l of a pair at offset o into slot o + l, the sign
    applied), and flushes the window when the band changes and at its
    chunk's end: each slot that holds a value (wrapped once at |M|) into
    delta's gradient, and, line by line, code * sum over each run of lanes
    of one scale group into that group's gradient.  Sums in f64.  Returns
    (gscale, gdelta, most delta atomics on one slot, the most pairs one
    band holds, the pairs that wrap, the lines whose scale runs are more
    than one)."""
    from repro_torch.core.robe import robe_signs, robe_slots
    from repro_torch.kernels.qrobe_lookup import BAND_LOG2, bwd_plan
    b, f = rows.shape
    m = spec.size
    plan = bwd_plan(spec, b * f, dim, gl)
    lw, w = plan.seg_log2, 1 << plan.seg_log2
    t = torch.as_tensor(tids, dtype=torch.int64)[None, :]
    slots = robe_slots(spec, t, rows, dim)
    gs = g.double()
    if spec.use_sign:
        gs = gs * robe_signs(spec, t, rows, dim).double()
    pairs = []                       # (slot0, {lane: value})
    for bb, ff in itertools.product(range(b), range(f)):
        k0 = int(rows[bb, ff]) * dim
        for j in range(plan.n_seg):
            start = ((k0 >> lw) + j) << lw
            if start >= k0 + dim:
                continue
            vals = {lane: float(gs[bb, ff, start + lane - k0])
                    for lane in range(w) if 0 <= start + lane - k0 < dim}
            lane = next(iter(vals))       # slot0 from a lane the item has
            slot0 = (int(slots[bb, ff, start + lane - k0]) - lane) % m
            pairs.append((slot0, vals))
    tie = np.random.default_rng(seed).permutation(len(pairs))
    order = sorted(range(len(pairs)),
                   key=lambda q: (pairs[q][0] >> BAND_LOG2, tie[q]))
    gdelta = torch.zeros(m, dtype=torch.float64)
    gscale = torch.zeros(plan.n_groups, dtype=torch.float64)
    hits = torch.zeros(m, dtype=torch.int64)
    split_lines = 0

    def flush(band, acc):
        nonlocal split_lines
        base = band << BAND_LOG2
        for h in range(2):
            line = acc[32 * h:32 * h + 32]
            if not any(line):
                continue
            prods, grps = [], []
            for lane in range(32):
                s = base + 32 * h + lane
                s = s - m if s >= m else s
                prods.append(line[lane] * int(codes[s]) if line[lane]
                             else 0.0)
                grps.append(s >> gl)
                if line[lane]:
                    gdelta[s] += line[lane]
                    hits[s] += 1
            runs = [(k, list(v)) for k, v in itertools.groupby(
                range(32), key=lambda lane: grps[lane])]
            sums = [(k, sum(prods[lane] for lane in v)) for k, v in runs]
            split_lines += sum(1 for _, x in sums if x) > 1
            for k, x in sums:
                if x:
                    gscale[k] += x

    for lo in range(0, len(order), chunk):
        band, acc = None, [0.0] * 64
        for q in order[lo:lo + chunk]:
            slot0, vals = pairs[q]
            if slot0 >> BAND_LOG2 != band:
                if band is not None:
                    flush(band, acc)
                band, acc = slot0 >> BAND_LOG2, [0.0] * 64
            o = slot0 & ((1 << BAND_LOG2) - 1)
            for lane, v in vals.items():
                acc[o + lane] += v
        flush(band, acc)
    most_band = max(sum(1 for s0, _ in pairs if s0 >> BAND_LOG2 == k)
                    for k in {s0 >> BAND_LOG2 for s0, _ in pairs})
    wraps = sum(1 for s0, v in pairs if s0 + max(v) >= m)
    return gscale, gdelta, int(hits.max()), most_band, wraps, split_lines


@pytest.mark.parametrize("dim,z,size,gl,sign,chunk", [
    (128, 32, 4096 + 75, 8, False, 32),     # full-width pairs, zipf heads
    (128, 32, 4096 + 75, 8, True, 256),
    (24, 16, 4096 + 75, 8, True, 32),       # pairs cut by the item's edges
    (16, 16, 1029, 4, False, 32),           # groups of 16: runs in a line
    (8, 32, 1029, 8, True, 64),             # d < Z: items share a block
    (40, 1, 1029, 8, False, 32),            # a pair an element
    (130, 64, 1029, 0, True, 32),           # a group a slot
    (128, 32, 2 ** 12 + 5, 8, True, 32),    # a 5-slot last group
])
def test_qrobe_bwd_walk_mirror_matches_plain_version(dim, z, size, gl, sign,
                                                     chunk):
    """A Python mirror of the qrobe backward's order and walk (pairs by
    band of their first slot, run sums in a 64-slot window, one flush a
    band run with the scales' runs per group, the wrap at |M| into the
    last partial group) equals qrobe_lookup_bwd_ref on small arrays whose
    ids repeat, within the kernel's bound 1e-5·A + 1e-7 (A on |g| and
    |code|).  A slot takes one delta atomic at most for each chunk that
    holds pairs of the two bands whose windows reach it."""
    rng = np.random.default_rng(dim * 31 + z + size)
    b, vocabs = 40, (50, 9, 400)
    ids = np.stack([np.minimum(rng.zipf(1.3, size=b) - 1, v - 1)
                    for v in vocabs], axis=1)
    ids[:, 1] = 4                               # a field at a single row
    tids = (0, 1, 2)
    spec = TRobeSpec(size=size, block_size=z, seed=5, use_sign=sign)
    # field 0 also takes rows whose elements run from slot |M| - 1 on to
    # slot 0 inside one block: pairs that wrap, into the last scale group
    # (at Z = 1 no pair wraps: rows that read slot |M| - 1)
    from repro_torch.core.robe import robe_slots
    cand = torch.arange(20000, dtype=torch.int32).view(-1, 1)
    s = robe_slots(spec, torch.zeros((1, 1), dtype=torch.int64), cand, dim)
    at = (s[..., :-1] == size - 1) & (s[..., 1:] == 0) if z > 1 \
        else s == size - 1
    wrap = cand[at.any(-1)[:, 0], 0]
    ids[:len(wrap[:3]), 0] = wrap[:3].numpy()
    rows = torch.from_numpy(ids.astype(np.int32))
    codes = torch.from_numpy(rng.integers(-127, 128, size, dtype=np.int8))
    g = torch.from_numpy(rng.standard_normal((b, 3, dim)).astype(np.float32))
    gscale, gdelta, most, most_band, wraps, split = _qrobe_walk_mirror(
        g, codes, rows, tids, dim, spec, gl, chunk)
    ws, wd = tref.qrobe_lookup_bwd_ref(g, codes, rows, tids, dim, spec, gl)
    a_s, a_d = tref.qrobe_lookup_bwd_ref(
        g.abs(), codes.abs(), rows, tids, dim,
        TRobeSpec(size=size, block_size=z, seed=5), gl)
    for x, y, a in ((gscale, ws, a_s), (gdelta, wd, a_d)):
        assert bool(((x - y.double()).abs() <= 1e-5 * a + 1e-7).all())
    assert most <= 2 * (-(-most_band // chunk) + 1)
    assert (wraps > 0) == (z > 1)
    assert float(a_d[-1]) > 0 and float(a_s[-1]) > 0
    if gl <= 4:               # lines flush more than one group's run
        assert split > 0


@pytest.mark.parametrize("dim,z", [(24, 16), (16, 16), (8, 32), (40, 1),
                                   (128, 32), (130, 64), (3, 4)])
def test_robe_lookup_bwd_pairs_cover_each_element_once(dim, z):
    """The kernel's pairs, mirrored: item x's pair j starts at element
    index k = ((x*d >> lw) + j) << lw of its table and covers the lanes
    whose k + lane falls in [x*d, x*d + d); its slots are one run from the
    slot of k, wrapped once at |M|.  The plan's n_seg pairs give every
    element its robe_slots slot, exactly once."""
    from repro_torch.core.robe import robe_slots
    from repro_torch.kernels.robe_lookup import bwd_plan
    spec = TRobeSpec(size=4099, block_size=z, seed=5)
    tid = torch.zeros((1, 1), dtype=torch.int64)
    rows = [0, 1, 2, 3, 7, 11, 4097, 9_999_991]

    def slot_of(k):   # element k of table 0: row k at width 1
        return int(robe_slots(spec, tid, torch.tensor([[k]],
                                                      dtype=torch.int32),
                              1)[0, 0, 0])
    plan = bwd_plan(spec, 1, len(rows), dim)
    w = 1 << plan.seg_log2
    for x in rows:
        want = robe_slots(spec, tid, torch.tensor([[x]], dtype=torch.int32),
                          dim)[0, 0]
        k0 = x * dim
        seen = [0] * dim
        for j in range(plan.n_seg):
            start = ((k0 >> plan.seg_log2) + j) << plan.seg_log2
            if start >= k0 + dim:
                continue
            first = slot_of(start)
            for lane in range(w):
                e = start + lane - k0
                if 0 <= e < dim:
                    seen[e] += 1
                    s = first + lane
                    assert int(want[e]) == (s - spec.size if s >= spec.size
                                            else s), (x, j, lane)
        assert seen == [1] * dim


def test_kernel_sources_and_bindings_agree():
    """Each launcher the Python side binds is defined in csrc/ with as many
    parameters as its ctypes signature has."""
    import ctypes
    import re
    from repro_torch.kernels import _build
    text = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    # one launcher per kernel wrapper, named after it
    assert set(_build.SIGNATURES) == {
        k.__name__.removesuffix("_cuda") + "_launch"
        for k in tk.CUDA_KERNELS}
    params = {}
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        params[name] = [" ".join(p.split()) for p in m.group(1).split(",")]
        assert len(params[name]) == len(argtypes), name
    # qrobe's optional delta: a pointer (c_void_p, so None passes null)
    # after scale, where the wrapper passes it
    q = params["qrobe_lookup_launch"]
    assert q[1:4] == ["const void* scale", "const void* delta",
                      "const void* rows"], q
    assert _build.SIGNATURES["qrobe_lookup_launch"][2] is ctypes.c_void_p
