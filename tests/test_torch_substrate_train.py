"""Training of the port's compressed substrates (``qrobe``, ``hashed``,
``tt``) and ``serve_fused``'s backward, against the JAX package, on the CPU.

Inputs are made with numpy from a seed; JAX params are carried into the
port with ``convert.params_from_numpy``.  On the CPU the port's backwards
run their plain versions (``kernels/ref.py``); ``chip_smoke.py`` holds the
Hopper kernels against those on the card.

Tolerances:

* each plain backward against ``jax.grad`` of the JAX op (its custom VJP,
  on the reference path and, for one case per op, the Pallas kernel in
  interpret mode): rtol = atol = 1e-5 in f32, 1e-2 in bf16.  The sums that
  alias many terms into one slot or row (the scales', delta's and M's
  gradients, the QR tables' and the cores') are held element by element
  within ``1e-5 · A + 1e-7`` (bf16 ``1e-2 · A``), ``A`` the same backward
  of the inputs' magnitudes: the two packages add the terms in other
  orders;
* each substrate's ``lookup`` gradient: as above;
* ``QRobeBackend.project``: bit for bit;
* the smoke DLRM's train step, each port step from the JAX run's state
  before it: loss within 1e-5, each param leaf's updates within 1e-4 of
  their norm over the steps, qrobe's codes equal but where the JAX step's
  w / scale lies within 1e-5 (relative) of a half-integer, and there by
  exactly 1.

A CPU call must launch no kernel: every ``launches`` count stays 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.core.robe import RobeSpec as JRobeSpec
from repro.core.robe import robe_signs as jrobe_signs
from repro.core.robe import robe_slots as jrobe_slots
from repro.data.synthetic_ctr import CtrDataConfig, CtrStream
from repro.kernels import ops as jops
from repro.models import recsys as jrec
from repro.nn.embedding_backends import qrobe as jqrobe
from repro.nn.embedding_backends.hashed import qr_layout
from repro.nn.embedding_backends.tt import factor_dim, factor_rows
from repro.nn.embeddings import EmbeddingSpec as JSpec
from repro.nn.embeddings import embedding_init as j_embedding_init
from repro.nn.embeddings import embedding_lookup as j_embedding_lookup
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import kernels as tk
from repro_torch import tree as ttree
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core.robe import RobeSpec as TRobeSpec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import recsys as trec
from repro_torch.nn.embedding_backends import qrobe as tqrobe
from repro_torch.nn.embeddings import EmbeddingSpec as TSpec
from repro_torch.nn.embeddings import embedding_lookup as t_embedding_lookup
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
VOCABS = (40, 24, 64)
KINDS = ("full", "qrobe", "hashed", "tt")


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test here runs on the CPU: no kernel may be launched."""
    tk.reset_launches()
    yield
    counts = tk.launch_counts()
    assert len(counts) == len(tk.CUDA_KERNELS)
    assert all(n == 0 for n in counts.values()), counts


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dt: str) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


def _summed_close(got, want, a, dt: str) -> None:
    """|got - want| <= 1e-5·A + 1e-7 (f32), 1e-2·A (bf16), elementwise."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    a = _np(a).astype(np.float64)
    bound = 1e-5 * a + 1e-7 if dt == "f32" else 1e-2 * a + 1e-7
    err = np.abs(got - want)
    worst = np.unravel_index(int(np.argmax(err - bound)), err.shape)
    assert (err <= bound).all(), (
        f"at {worst}: got {got[worst]}, want {want[worst]}, A {a[worst]}")


def _ids(b: int, vocabs, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    idx = np.stack([rs.randint(0, v, b) for v in vocabs], axis=1)
    idx[-1] = np.asarray(vocabs) - 1              # each field's largest id
    return idx.astype(np.int32)


def _t(a: np.ndarray, dt: str = "f32") -> torch.Tensor:
    if a.dtype.kind == "f":
        return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the plain backwards against jax.grad of the JAX ops
# ---------------------------------------------------------------------------

# (B, dim, Z): prime batches, dims that are not a multiple of 128
SHAPES = [(17, 24, 16), (7, 40, 8), (13, 128, 32)]


def _qrobe_inputs(b, dim, z, use_sign, size=4096 + 75, seed=0):
    rs = np.random.RandomState(seed)
    kw = dict(size=size, block_size=z, seed=7, use_sign=use_sign)
    codes = rs.randint(-127, 128, size).astype(np.int8)
    scale = (np.abs(rs.randn(-(-size // 256))) * 0.05 + 0.01).astype(
        np.float32)
    idx = _ids(b, VOCABS, seed + 1)
    ct = rs.randn(b, len(VOCABS), dim).astype(np.float32)
    return JRobeSpec(**kw), TRobeSpec(**kw), codes, scale, idx, ct


@pytest.mark.parametrize("b,dim,z", SHAPES)
@pytest.mark.parametrize("use_sign", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_qrobe_lookup_bwd_matches_jax(b, dim, z, use_sign, dt):
    """The scales' gradient against ``jax.grad`` through the op (its
    ``_qrobe_bwd``); delta's against ``jax.grad`` of the JAX backend's
    delta term (``jnp.take(delta, slots) · sign``), on an array whose last
    scale group is partial."""
    js, ts, codes, scale, idx, ct = _qrobe_inputs(b, dim, z, use_sign)
    tids = tuple(range(len(VOCABS)))
    gl = jqrobe.GROUP_LOG2
    jidx, jct = jnp.asarray(idx), jnp.asarray(ct)

    def jloss(s, delta):
        out = jops.qrobe_lookup(jnp.asarray(codes), s, jidx, tids, dim, js,
                                gl, False)
        slots = jrobe_slots(js, jnp.asarray(tids, jnp.uint32)[None, :],
                            jidx, dim).astype(jnp.int32)
        d = jnp.take(delta, slots, axis=0)
        if use_sign:
            d = d * jrobe_signs(js, jnp.asarray(tids, jnp.uint32)[None, :],
                                jidx, dim)
        return ((out + d.astype(out.dtype)).astype(jnp.float32) * jct).sum()

    wscale, wdelta = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(scale, JDT[dt]), jnp.zeros(js.size, jnp.float32))
    tscale = _t(scale, dt).requires_grad_(True)
    tdelta = torch.zeros(ts.size, requires_grad=True)
    out = tops.qrobe_lookup(_t(codes), tscale, _t(idx), tids, dim, ts, gl,
                            delta=tdelta)
    gscale, gdelta = torch.autograd.grad(
        (out.to(torch.float32) * _t(ct)).sum(), (tscale, tdelta))
    assert gscale.dtype == TDT[dt] and gdelta.dtype == torch.float32
    g = _t(ct, dt).to(torch.float32).abs()
    a_s, a_d = tref.qrobe_lookup_bwd_ref(
        g, _t(codes).abs(), _t(idx), tids, dim,
        dataclasses.replace(ts, use_sign=False), gl)
    _summed_close(gscale, wscale, a_s, dt)
    _summed_close(gdelta, wdelta, a_d, "f32")


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_qrobe_lookup_bwd_matches_jax_kernel_path(dt):
    """Against the JAX op with its Pallas kernel in interpret mode."""
    js, ts, codes, scale, idx, ct = _qrobe_inputs(9, 24, 16, True, seed=3)
    tids = tuple(range(len(VOCABS)))
    gl = jqrobe.GROUP_LOG2
    want = jax.grad(lambda s: (jops.qrobe_lookup(
        jnp.asarray(codes), s, jnp.asarray(idx), tids, 24, js, gl,
        True).astype(jnp.float32) * jnp.asarray(ct)).sum())(
        jnp.asarray(scale, JDT[dt]))
    gscale, gdelta = tref.qrobe_lookup_bwd_ref(
        _t(ct, dt), _t(codes), _t(idx), tids, 24, ts, gl)
    a_s, _ = tref.qrobe_lookup_bwd_ref(
        _t(ct, dt).to(torch.float32).abs(), _t(codes).abs(), _t(idx), tids,
        24, dataclasses.replace(ts, use_sign=False), gl)
    _summed_close(gscale, want, a_s, dt)
    assert gdelta.shape == (ts.size,) and gdelta.dtype == torch.float32


def test_qrobe_lookup_bwd_groups_shorter_than_a_block():
    """An array whose last group (5 slots) is shorter than Z = 32, and rows
    whose runs cross the wrap at |M| inside it: the scales' gradient is
    the sum over each group of code · delta's gradient."""
    size = 2 * 256 + 5
    js, ts, codes, scale, _, _ = _qrobe_inputs(4, 128, 32, True, size=size)
    rs = np.random.RandomState(5)
    idx = rs.randint(0, 10 ** 6, (64, 3)).astype(np.int32)
    ct = rs.randn(64, 3, 128).astype(np.float32)
    gscale, gdelta = tref.qrobe_lookup_bwd_ref(
        _t(ct), _t(codes), _t(idx), (0, 1, 2), 128, ts, 8)
    want = torch.zeros(3).index_add_(
        0, torch.arange(size) >> 8, gdelta * _t(codes).to(torch.float32))
    _close(gscale, want, "f32")
    wscale = jax.grad(lambda s: (jops.qrobe_lookup(
        jnp.asarray(codes), s, jnp.asarray(idx), (0, 1, 2), 128, js, 8,
        False) * jnp.asarray(ct)).sum())(jnp.asarray(scale))
    a_s, _ = tref.qrobe_lookup_bwd_ref(
        _t(ct).abs(), _t(codes).abs(), _t(idx), (0, 1, 2), 128,
        dataclasses.replace(ts, use_sign=False), 8)
    _summed_close(gscale, wscale, a_s, "f32")


def _qr_inputs(b, dim, m, seed=0):
    rs = np.random.RandomState(seed)
    q_rows, q_off, r_off = qr_layout(VOCABS, m)
    q = rs.randn(sum(q_rows), dim).astype(np.float32)
    r = rs.randn(m * len(VOCABS), dim).astype(np.float32)
    idx = _ids(b, VOCABS, seed + 1)
    ct = rs.randn(b, len(VOCABS), dim).astype(np.float32)
    return q, r, idx, ct, tuple(map(int, q_off)), tuple(map(int, r_off))


@pytest.mark.parametrize("b,dim", [(17, 24), (7, 40), (13, 128), (1, 8)])
@pytest.mark.parametrize("m", (8, 7, 64))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_qr_lookup_bwd_matches_jax(b, dim, m, dt):
    """m = 64 puts every id of a field in one quotient row (a chain of B);
    m = 7 is not a power of two."""
    q, r, idx, ct, qo, ro = _qr_inputs(b, dim, m)
    want = jax.grad(lambda a, c: (jops.qr_lookup(
        a, c, jnp.asarray(idx), qo, ro, m, False).astype(jnp.float32)
        * jnp.asarray(ct)).sum(), argnums=(0, 1))(
        jnp.asarray(q, JDT[dt]), jnp.asarray(r, JDT[dt]))
    tq, tr = _t(q, dt).requires_grad_(True), _t(r, dt).requires_grad_(True)
    out = tops.qr_lookup(tq, tr, _t(idx), qo, ro, m)
    got = torch.autograd.grad((out.to(torch.float32) * _t(ct)).sum(),
                              (tq, tr))
    a = tref.qr_lookup_bwd_ref(_t(ct, dt).to(torch.float32).abs(),
                               _t(q, dt).to(torch.float32).abs(),
                               _t(r, dt).to(torch.float32).abs(), _t(idx),
                               qo, ro, m)
    for g, w, aa in zip(got, want, a):
        assert g.dtype == TDT[dt]
        _summed_close(g, w, aa, dt)


def test_qr_lookup_bwd_matches_jax_kernel_path():
    q, r, idx, ct, qo, ro = _qr_inputs(9, 24, 8, seed=4)
    want = jax.grad(lambda a, c: (jops.qr_lookup(
        a, c, jnp.asarray(idx), qo, ro, 8, True) * jnp.asarray(ct)).sum(),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(r))
    got = tref.qr_lookup_bwd_ref(_t(ct), _t(q), _t(r), _t(idx), qo, ro, 8)
    for g, w in zip(got, want):
        _close(g, w, "f32")


def _tt_inputs(b, dim, rank, seed=0):
    rs = np.random.RandomState(seed)
    factors = tuple(int(n) for n in factor_rows(int(sum(VOCABS))))
    offsets = tuple(int(o) for o in
                    np.concatenate([[0], np.cumsum(VOCABS)[:-1]]))
    d1, d2, d3 = factor_dim(dim)
    n1, n2, n3 = factors
    cores = (rs.randn(n1, d1, rank).astype(np.float32),
             rs.randn(n2, rank, d2, rank).astype(np.float32),
             rs.randn(n3, rank, d3).astype(np.float32))
    idx = _ids(b, VOCABS, seed + 1)
    ct = rs.randn(b, len(VOCABS), dim).astype(np.float32)
    return cores, idx, ct, offsets, factors


@pytest.mark.parametrize("b,dim,rank", [(17, 24, 4), (7, 40, 8), (13, 128, 8),
                                        (5, 16, 3), (3, 18, 8)])
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_tt_lookup_bwd_matches_jax(b, dim, rank, dt):
    cores, idx, ct, offsets, factors = _tt_inputs(b, dim, rank)
    want = jax.grad(lambda c0, c1, c2: (jops.tt_lookup(
        c0, c1, c2, jnp.asarray(idx), offsets, factors, dim,
        False).astype(jnp.float32) * jnp.asarray(ct)).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(c, JDT[dt]) for c in cores))
    tc = [_t(c, dt).requires_grad_(True) for c in cores]
    out = tops.tt_lookup(*tc, _t(idx), offsets, factors, dim)
    got = torch.autograd.grad((out.to(torch.float32) * _t(ct)).sum(), tc)
    a = tref.tt_lookup_bwd_ref(_t(ct, dt).to(torch.float32).abs(),
                               *(_t(c, dt).to(torch.float32).abs()
                                 for c in cores), _t(idx), offsets, factors)
    for g, w, aa in zip(got, want, a):
        assert g.dtype == TDT[dt]
        _summed_close(g, w, aa, dt)


def test_tt_lookup_bwd_matches_jax_kernel_path():
    cores, idx, ct, offsets, factors = _tt_inputs(9, 24, 4, seed=2)
    want = jax.grad(lambda c0, c1, c2: (jops.tt_lookup(
        c0, c1, c2, jnp.asarray(idx), offsets, factors, 24, True)
        * jnp.asarray(ct)).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(c) for c in cores))
    got = tref.tt_lookup_bwd_ref(_t(ct), *(_t(c) for c in cores), _t(idx),
                                 offsets, factors)
    for g, w in zip(got, want):
        _close(g, w, "f32")


def _serve_inputs(b, dim, z, bag, use_sign, seed=0):
    rs = np.random.RandomState(seed)
    kw = dict(size=4096, block_size=z, seed=7, use_sign=use_sign)
    mem = rs.randn(4096).astype(np.float32)
    bot = rs.randn(b, dim).astype(np.float32)
    f = len(VOCABS)
    idx = np.stack([rs.randint(0, v, (b, bag)) for v in VOCABS], axis=1)
    if bag > 1:
        idx = np.where(rs.rand(b, f, bag) < 0.3, -1, idx)
        idx[0, 0, :] = -1                               # an empty bag
    else:
        idx = idx[..., 0]
    ct = rs.randn(b, (f + 1) * f // 2).astype(np.float32)
    return (JRobeSpec(**kw), TRobeSpec(**kw), mem, bot,
            idx.astype(np.int32), ct)


@pytest.mark.parametrize("b,dim,z,bag", [(17, 24, 16, 1), (7, 40, 16, 3),
                                         (13, 128, 32, 3), (5, 16, 32, 2)])
@pytest.mark.parametrize("use_sign", (False, True))
@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_serve_fused_bwd_matches_jax(b, dim, z, bag, use_sign, dt):
    """dM and dbot against ``jax.grad`` through the JAX op (its
    ``_serve_bwd``), with bags of 2 and 3, -1 pads and an empty bag; bot
    (and the output) in ``dt``, M in f32 as the serve path holds it."""
    js, ts, mem, bot, idx, ct = _serve_inputs(b, dim, z, bag, use_sign)
    tids = tuple(range(len(VOCABS)))
    want = jax.grad(lambda m_, bt: (jops.serve_fused(
        m_, jnp.asarray(idx), bt, tids, dim, js, False).astype(jnp.float32)
        * jnp.asarray(ct)).sum(), argnums=(0, 1))(
        jnp.asarray(mem), jnp.asarray(bot, JDT[dt]))
    tm = _t(mem).requires_grad_(True)
    tb = _t(bot, dt).requires_grad_(True)
    out = tops.serve_fused(tm, _t(idx), tb, tids, dim, ts)
    gm, gb = torch.autograd.grad((out.to(torch.float32) * _t(ct)).sum(),
                                 (tm, tb))
    assert gm.dtype == torch.float32 and gb.dtype == TDT[dt]
    am, ab = tref.serve_fused_bwd_ref(
        _t(ct, dt).to(torch.float32).abs(), _t(mem).abs(), _t(idx),
        _t(bot, dt).to(torch.float32).abs(), tids, dim,
        dataclasses.replace(ts, use_sign=False))
    _summed_close(gm, want[0], am, dt)
    _summed_close(gb, want[1], ab, dt)


def test_serve_fused_bwd_matches_jax_kernel_path():
    js, ts, mem, bot, idx, ct = _serve_inputs(9, 24, 16, 3, True, seed=6)
    tids = tuple(range(len(VOCABS)))
    want = jax.grad(lambda m_, bt: (jops.serve_fused(
        m_, jnp.asarray(idx), bt, tids, 24, js, True)
        * jnp.asarray(ct)).sum(), argnums=(0, 1))(
        jnp.asarray(mem), jnp.asarray(bot))
    got = tref.serve_fused_bwd_ref(_t(ct), _t(mem), _t(idx), _t(bot), tids,
                                   24, ts)
    for g, w in zip(got, want):
        _close(g, w, "f32")


# ---------------------------------------------------------------------------
# each substrate's lookup gradient against jax.grad of repro's backend
# ---------------------------------------------------------------------------

def _backend_specs(kind: str, dim: int = 8):
    robe = dict(size=512, block_size=8, seed=3, use_sign=True)
    kw = dict(vocab_sizes=VOCABS, dim=dim, kind=kind, hashed_buckets=16,
              tt_rank=4)
    return (JSpec(robe=JRobeSpec(**robe), **kw),
            TSpec(robe=TRobeSpec(**robe), **kw))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("use_kernel", (False, True), ids=("jnp", "pallas"))
def test_backend_grad_matches_jax(kind, use_kernel):
    """The port of tests/test_embedding_backends.py's
    test_grad_matches_reference: the gradient of sum(lookup · ct) over
    every float leaf of the substrate's params; qrobe's int8 codes take
    none."""
    js, ts = _backend_specs(kind)
    js = dataclasses.replace(js, use_kernel=use_kernel)
    jparams = j_embedding_init(jax.random.PRNGKey(0), js)
    rs = np.random.RandomState(2)
    idx = rs.randint(0, min(VOCABS), (8, 3)).astype(np.int32)
    ct = rs.randn(8, 3, 8).astype(np.float32)
    want = jax.grad(lambda p: (j_embedding_lookup(p, js, jnp.asarray(idx))
                               * jnp.asarray(ct)).sum(),
                    allow_int=True)(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    live = {k: (v.requires_grad_(True) if v.is_floating_point() else v)
            for k, v in tparams.items()}
    out = t_embedding_lookup(live, ts, _t(idx))
    names = sorted(k for k, v in live.items() if v.is_floating_point())
    got = torch.autograd.grad((out * _t(ct)).sum(),
                              [live[k] for k in names])
    for name, g in zip(names, got):
        assert g.shape == live[name].shape
        np.testing.assert_allclose(_np(g), np.asarray(want[name], np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if kind == "qrobe":
        assert want["codes"].dtype == jax.dtypes.float0
        assert not live["codes"].requires_grad


# ---------------------------------------------------------------------------
# QRobeBackend.project, and the JAX package's qrobe training cases
# ---------------------------------------------------------------------------

def _qrobe_spec():
    return (JSpec(vocab_sizes=(400, 240, 640), dim=8, kind="qrobe",
                  robe=JRobeSpec(size=2048, block_size=8, seed=3)),
            TSpec(vocab_sizes=(400, 240, 640), dim=8, kind="qrobe",
                  robe=TRobeSpec(size=2048, block_size=8, seed=3)))


@pytest.mark.parametrize("case", ("random", "collapsed", "negative",
                                  "ties", "saturating", "bf16_scale"))
def test_project_matches_jax_bit_for_bit(case):
    js, ts = _qrobe_spec()
    size = js.robe.size
    rs = np.random.RandomState(7)
    codes = rs.randint(-127, 128, size).astype(np.int8)
    scale = (np.abs(rs.randn(size // 256)) * 0.02 + 1e-3).astype(np.float32)
    delta = (rs.randn(size) * 1e-2).astype(np.float32)
    if case == "collapsed":
        scale[0], scale[3] = 0.0, 1e-30
    elif case == "negative":
        scale[1::2] *= -1
    elif case == "ties":
        # w / scale exactly on half-integers: half to even decides
        delta = (np.repeat(scale, 256) * (rs.randint(-4, 5, size) + 0.5)
                 ).astype(np.float32)
    elif case == "saturating":
        delta[:300] = 50.0
    jp = {"codes": jnp.asarray(codes), "scale": jnp.asarray(scale),
          "delta": jnp.asarray(delta)}
    tp = {"codes": _t(codes), "scale": _t(scale), "delta": _t(delta)}
    if case == "bf16_scale":
        jp["scale"] = jp["scale"].astype(jnp.bfloat16)
        tp["scale"] = tp["scale"].to(torch.bfloat16)
    want = jax.tree.map(np.asarray, jqrobe.QRobeBackend().project(jp, js))
    got = tqrobe.QRobeBackend().project(tp, ts)
    assert got["codes"].dtype == torch.int8
    assert got["scale"].dtype == tp["scale"].dtype
    np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
    np.testing.assert_array_equal(
        got["scale"].to(torch.float32).numpy().view(np.uint32),
        want["scale"].astype(np.float32).view(np.uint32))
    assert not bool(got["delta"].any()) and got["delta"].shape == (size,)


def test_project_recovers_from_collapsed_scale():
    """tests/test_qrobe.py's case on the port: zero one group's scale;
    project saturates that group (no NaN) and leaves every other group's
    codes as they were."""
    _, ts = _qrobe_spec()
    bk = tqrobe.QRobeBackend()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = bk.init(gen, ts, "cpu")
    crushed = dict(params, scale=params["scale"].clone())
    crushed["scale"][0] = 0.0
    out = bk.project(crushed, ts)
    assert torch.isfinite(out["scale"]).all()
    assert bool(out["scale"].abs().min() >= tqrobe.SCALE_FLOOR)
    assert torch.equal(out["codes"][tqrobe.GROUP_SIZE:],
                       params["codes"][tqrobe.GROUP_SIZE:])
    assert int(out["codes"][:tqrobe.GROUP_SIZE].abs().max()) <= 127


def _qrobe_model(kind: str = "qrobe"):
    return trec.RecsysConfig(name="t", arch="dlrm", n_dense=4,
                             bot_mlp=(16, 8), top_mlp=(8, 1), embed_dim=8,
                             vocab_sizes=(400, 240, 640), embedding=kind,
                             robe_size=2048, robe_block=8)


def _port_train(cfg, params, n_steps, batch_size):
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="adagrad", lr=0.05))
    tc = ttl.TrainConfig()
    step = ttl.build_train_step(lambda p, b: trec.loss_fn(p, cfg, b), opt,
                                tc, project=trec.make_project_fn(cfg))
    state = ttl.init_state(params, opt, tc)
    stream = CtrStream(CtrDataConfig(vocab_sizes=cfg.vocab_sizes, n_dense=4,
                                     batch_size=batch_size))
    losses = []
    for s in range(n_steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in stream.batch_at(s).items()}
        state, m = step(state, batch)
        assert float(m["finite"]) == 1.0
        losses.append(float(m["loss"]))
    return state, losses


def test_underflow_scale_trains_without_nan():
    """tests/test_qrobe.py's case on the port: three steps from a collapsed
    scale stay finite through the grads, the update and the projection."""
    cfg = _qrobe_model()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = trec.init_params(cfg, gen, "cpu")
    emb = params["embedding"]
    emb["scale"] = emb["scale"].clone()
    emb["scale"][0] = 0.0
    state, losses = _port_train(cfg, params, 3, 64)
    assert np.isfinite(losses).all()
    p = state["params"]["embedding"]
    assert torch.isfinite(p["scale"]).all()
    assert not bool(p["delta"].any())


def test_qrobe_training_tracks_robe():
    """tests/test_qrobe.py's QAT drift gate on the port: 30 adagrad steps
    of the same model on robe and on qrobe; both learn, and the int8 run
    trails the float run by no more than quantization noise."""
    losses = {}
    for kind in ("robe", "qrobe"):
        cfg = _qrobe_model(kind)
        gen = torch.Generator()
        gen.manual_seed(0)
        _, run = _port_train(cfg, trec.init_params(cfg, gen, "cpu"), 30, 128)
        losses[kind] = float(np.mean(run[25:]))
    assert np.isfinite(losses["qrobe"])
    assert losses["qrobe"] < 0.8 and losses["robe"] < 0.8
    assert losses["qrobe"] <= losses["robe"] + 0.05, losses


# ---------------------------------------------------------------------------
# the smoke DLRM's train step on each substrate against the JAX package's
# ---------------------------------------------------------------------------

def _jax_ratio(emb) -> np.ndarray:
    """w / scale of a JAX qrobe array before its projection."""
    size = emb["codes"].shape[0]
    w = (np.asarray(emb["codes"], np.float32)
         * np.asarray(jqrobe._expand(emb["scale"], size))
         + np.asarray(emb["delta"], np.float32))
    return w / np.asarray(jqrobe._expand(jqrobe._safe_scale(emb["scale"]),
                                         size))


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_matches_jax(kind):
    """Five adagrad steps of the dlrm-rm2 smoke DLRM (lr 0.05, with qrobe's
    projection), each port step from the JAX run's state before it."""
    jcfg = j_get_arch("dlrm-rm2").make_config("smoke", embedding=kind)
    tcfg = t_get_arch("dlrm-rm2").make_config("smoke", embedding=kind)
    opt = dict(kind="adagrad", lr=0.05)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**opt))
    to = topt.make_optimizer(topt.OptimizerConfig(**opt))
    jc, tc = jtl.TrainConfig(), ttl.TrainConfig()
    # the JAX step without the projection, applied below after w / scale
    # is read
    jstep = jax.jit(jtl.build_train_step(
        lambda p, b: jrec.loss_fn(p, jcfg, b), jo, jc))
    jproject = jrec.make_project_fn(jcfg)
    tstep = ttl.build_train_step(lambda p, b: trec.loss_fn(p, tcfg, b), to,
                                 tc, project=trec.make_project_fn(tcfg))
    assert (jproject is None) == (kind != "qrobe")
    state = jtl.init_state(jrec.init_params(jax.random.PRNGKey(0), jcfg),
                           jo, jc)
    stream = CtrStream(CtrDataConfig(vocab_sizes=jcfg.vocab_sizes,
                                     n_dense=jcfg.n_dense, batch_size=64,
                                     seed=3))
    acc, ties = {}, 0
    for k in range(5):
        batch = stream.batch_at(k)
        old = jax.tree.map(np.asarray, state)
        state, jm = jstep(state, {key: jnp.asarray(v)
                                  for key, v in batch.items()})
        ratio = None
        if jproject is not None:
            ratio = _jax_ratio(state["params"]["embedding"])
            state = dict(state, params=jproject(state["params"]))
        new = jax.tree.map(np.asarray, state)
        got, tm = tstep(params_from_numpy(old, "cpu"),
                        {key: torch.from_numpy(v)
                         for key, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        got = tree_to_numpy(got)
        names = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                          for p in path) for path, _ in
                 jax.tree_util.tree_leaves_with_path(old["params"])]
        for name, o, t, j in zip(names, ttree.leaves(old["params"]),
                                 ttree.leaves(got["params"]),
                                 ttree.leaves(new["params"])):
            if name.endswith("codes"):
                diff = t.astype(np.int32) - j.astype(np.int32)
                frac = ratio - np.floor(ratio)
                tie = np.abs(frac - 0.5) <= 1e-5 * np.abs(ratio)
                assert np.all((diff == 0) | (tie & (np.abs(diff) == 1)))
                ties += int((diff != 0).sum())
                continue
            o = np.asarray(o, np.float64)
            want = np.asarray(j, np.float64) - o
            d = np.asarray(t, np.float64) - o - want
            dd, ww = acc.get(name, (0.0, 0.0))
            acc[name] = (dd + float((d * d).sum()),
                         ww + float((want * want).sum()))
    for name, (d, w) in acc.items():
        rel = (d / w) ** 0.5 if w > 0 else (0.0 if d == 0 else 1.0)
        assert rel <= 1e-4, (name, rel)
    if kind == "qrobe":
        assert "embedding/delta" in acc and "embedding/scale" in acc
    print(f"{kind}: codes off by one at half-integer ties: {ties}")
