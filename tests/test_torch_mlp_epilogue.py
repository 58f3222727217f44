"""The f32 MLPs' bias in the GEMM's epilogue (``nn.core``).

On the CPU:

* a layer that ``bias_epilogue`` admits (2-D float32 input, a float32
  bias, ``torch.relu``, both GEMM widths above 1) gives what
  ``dense_apply`` + ``torch.relu`` gives, forward and the gradients of
  ``x``, ``w`` and ``b``, under ``inference_mode`` and under grad, at the
  DLRM's widths;
* bf16, 3-D, other activations, no bias and width-1 layers run the old
  path, op for op (``bias_epilogue`` admits none of them);
* a NaN or an infinity in an input row comes out as ``torch.relu`` gives
  it;
* the DLRM fuses 3 layers of its bottom MLP and 4 of its top at f32 and
  none at bf16, and the whole model (logits, every gradient leaf) agrees
  with the unfused path;
* the dry run's FLOP counter counts a fused layer as the GEMM it is.

On the card (marked ``chip``, skipped without one; run with
``python -m pytest -q -m chip tests/test_torch_mlp_epilogue.py``): the
full-width DLRM's serve forward at B=16,384 launches no bias add inside
the MLP spans but the width-1 last layer's, and one ReLU a fused layer;
its scores agree with the unfused path, a NaN input row still scores NaN,
and a grad-mode step's gradients agree with the unfused path's.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.recsys_archs import CRITEO_TB_VOCABS
from repro_torch.models import recsys as trec
from repro_torch.nn import core
from repro_torch.serve.server import ServerConfig

#: the DLRM's fused layers (d_in, d_out): bottom 13-512-256-128 (its last
#: ReLU is ``final_act``), top 479-1024-1024-512-256 (479 = 128 + 27·26/2)
DLRM_LAYERS = [(13, 512), (512, 256), (256, 128), (479, 1024),
               (1024, 1024), (1024, 512), (512, 256)]
B = 33
MODES = ["inference", "grad"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the epilogue is cuBLASLt's")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _decisions(monkeypatch) -> list:
    """``bias_epilogue``'s answers from now on, in call order (one a
    layer that ``mlp_apply`` runs)."""
    seen, admit = [], core.bias_epilogue

    def record(*args):
        seen.append(admit(*args))
        return seen[-1]
    monkeypatch.setattr(core, "bias_epilogue", record)
    return seen


def _old_mlp(layers, x, act=torch.relu, final_act=None):
    """``mlp_apply`` as it was before the epilogue: every layer
    ``dense_apply`` then its activation."""
    for i, p in enumerate(layers):
        x = core.dense_apply(p, x)
        if i < len(layers) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def _layer(d_in, d_out, seed=0, bias=True):
    g = torch.Generator().manual_seed(seed)
    p = core.dense_init(g, d_in, d_out, "cpu", bias=bias)
    if bias:
        p["b"] = torch.randn(d_out, generator=g) * 0.1
    return p


def _fused(p, x):
    """One layer through ``mlp_apply``, with its ReLU; it must fuse."""
    assert core.bias_epilogue(p, x, torch.relu)
    return core.mlp_apply([p], x, final_act=torch.relu)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _run(p, x, fn, mode):
    """``fn(p, x)`` under ``inference_mode``, or under grad with the
    gradients of ``x``, ``w`` and ``b`` of the sum of squares."""
    if mode == "inference":
        with torch.inference_mode():
            return fn(p, x), ()
    x = x.clone().requires_grad_(True)
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    y = fn(q, x)
    return y.detach(), torch.autograd.grad((y * y).sum(), (x, q["w"], q["b"]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", DLRM_LAYERS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_layer_matches_dense_relu(shape, mode):
    p = _layer(*shape)
    x = torch.randn(B, shape[0], generator=torch.Generator().manual_seed(1))
    assert core.bias_epilogue(p, x, torch.relu)
    y, grads = _run(p, x, _fused, mode)
    y0, grads0 = _run(p, x, lambda q, v: torch.relu(core.dense_apply(q, v)),
                      mode)
    assert (y > 0).any() and (y == 0).any()
    assert _rel(y, y0) <= 1e-6
    for g, g0 in zip(grads, grads0):
        assert _rel(g, g0) <= 1e-6


#: (dims, x's shape, act, final_act, x's dtype): each keeps the old path
#: (a bf16 input meets f32 weights, as the LMs' layers do)
OLD_PATH = {
    "bf16": ((13, 64, 32), (B, 13), torch.relu, torch.relu, torch.bfloat16),
    "3d": ((13, 64, 32), (3, B, 13), torch.relu, torch.relu, torch.float32),
    "tanh": ((13, 64, 32), (B, 13), torch.tanh, torch.tanh, torch.float32),
    "gelu": ((13, 64, 32), (B, 13), torch.nn.functional.gelu,
             torch.nn.functional.gelu, torch.float32),
    "no_bias": ((13, 64, 32), (B, 13), torch.relu, torch.relu,
                torch.float32),
    "width_1": ((13, 1), (B, 13), torch.relu, torch.relu, torch.float32),
    "one_row": ((13, 64, 32), (1, 13), torch.relu, torch.relu,
                torch.float32),
}


@pytest.mark.parametrize("case", sorted(OLD_PATH))
def test_other_inputs_keep_the_old_path(case, monkeypatch):
    dims, shape, act, final_act, dtype = OLD_PATH[case]
    g = torch.Generator().manual_seed(2)
    layers = core.mlp_init(g, dims, "cpu", bias=case != "no_bias")
    x = torch.randn(shape, generator=g).to(dtype)
    seen = _decisions(monkeypatch)
    y = core.mlp_apply(layers, x, act=act, final_act=final_act)
    assert seen == [False] * len(layers)
    assert torch.equal(y, _old_mlp(layers, x, act, final_act))


@pytest.mark.parametrize("mode", MODES)
def test_last_layer_without_act_keeps_the_old_path(mode, monkeypatch):
    """Of 479-1024-256-1 without ``final_act``, two layers fuse; the
    width-1 last layer is ``dense_apply`` alone."""
    g = torch.Generator().manual_seed(3)
    layers = core.mlp_init(g, (479, 1024, 256, 1), "cpu")
    x = torch.randn(B, 479, generator=g)
    seen = _decisions(monkeypatch)
    ctx = torch.inference_mode() if mode == "inference" else \
        torch.enable_grad()
    with ctx:
        y = core.mlp_apply(layers, x)
        y0 = _old_mlp(layers, x)
    assert seen == [True, True, False]
    assert _rel(y, y0) <= 1e-6


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")], ids=["nan", "inf", "-inf"])
def test_non_finite_rows_come_out_as_relu_gives_them(value, mode):
    p = _layer(479, 1024)
    x = torch.randn(B, 479, generator=torch.Generator().manual_seed(4))
    x[3, 0] = value
    x[7] = value
    y, _ = _run(p, x, _fused, mode)
    y0, _ = _run(p, x, lambda q, v: torch.relu(core.dense_apply(q, v)),
                 mode)
    assert torch.equal(torch.isnan(y), torch.isnan(y0))
    assert not torch.isnan(y[:3]).any()
    if value != value:
        assert torch.isnan(y[3]).all() and torch.isnan(y[7]).all()
    torch.testing.assert_close(y, y0, rtol=1e-6, atol=1e-6, equal_nan=True)


# -- the DLRM --------------------------------------------------------------

VOCABS = (300, 120, 500, 40)
N_DENSE = 5


def _dlrm(dtype=torch.float32):
    cfg = trec.RecsysConfig(name="t", arch="dlrm", vocab_sizes=VOCABS,
                            embed_dim=8, n_dense=N_DENSE, bot_mlp=(16, 16, 8),
                            top_mlp=(32, 16, 16, 8, 1), embedding="robe",
                            robe_size=512, robe_block=4, compute_dtype=dtype)
    params = trec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(5)
    batch = {"dense": torch.randn(24, N_DENSE, generator=g),
             "sparse": torch.stack([torch.randint(0, v, (24,), generator=g)
                                    for v in VOCABS], 1).to(torch.int32),
             "label": (torch.rand(24, generator=g) < 0.5).float()}
    return cfg, params, batch


def _float_leaves(params):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor) and t.is_floating_point():
            out.append(t)
    walk(params)
    return out


def _logits_and_grads(cfg, params, batch, path):
    if path == "serve":
        with torch.inference_mode():
            return trec.serve_scores(params, cfg, batch), ()
    leaves = [t.requires_grad_(True) for t in _float_leaves(params)]
    loss, _ = trec.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.parametrize("path", ["serve", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlrm_fuses_its_hidden_layers(dtype, path, monkeypatch):
    """The bottom MLP's three layers (the last with ``final_act``), then
    the top's five, of which the width-1 last has no activation."""
    cfg, params, batch = _dlrm(getattr(torch, dtype))
    seen = _decisions(monkeypatch)
    _logits_and_grads(cfg, params, batch, path)
    f32 = dtype == "float32"
    assert seen == [f32] * 3 + [f32] * 4 + [False]


@pytest.mark.parametrize("path", ["serve", "train"])
def test_dlrm_matches_the_unfused_path(path, monkeypatch):
    cfg, params, batch = _dlrm()
    out, grads = _logits_and_grads(cfg, params, batch, path)
    monkeypatch.setattr(core, "bias_epilogue", lambda *a: False)
    out0, grads0 = _logits_and_grads(cfg, params, batch, path)
    assert _rel(out, out0) <= 1e-6
    assert len(grads) == len(grads0)
    for g, g0 in zip(grads, grads0):
        assert float((g - g0).abs().max()) <= 1e-6 * max(
            float(g0.abs().max()), 1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_flop_counter_counts_the_fused_gemm(mode, monkeypatch):
    dims = (13, 64, 32, 1)
    layers = core.mlp_init(torch.Generator().manual_seed(6), dims, "cpu")
    x = torch.randn(B, 13)

    def flops():
        ls = [{k: v.clone().requires_grad_(mode == "grad")
               for k, v in p.items()} for p in layers]
        with FlopCounterMode(display=False) as f:
            y = core.mlp_apply(ls, x)
            if mode == "grad":
                y.sum().backward()
        return f.get_total_flops()

    fused = flops()
    forward = 2 * B * sum(a * b for a, b in zip(dims, dims[1:]))
    assert fused >= forward
    monkeypatch.setattr(core, "bias_epilogue", lambda *a: False)
    assert fused == flops()


# -- the card --------------------------------------------------------------

CARD_B = 16_384


def _card_dlrm(dev):
    rc = ServerConfig(vocab_sizes=CRITEO_TB_VOCABS, embed_dim=128, n_dense=13,
                      bot_mlp=(512, 256, 128),
                      top_mlp=(1024, 1024, 512, 256, 1), backends=("robe",),
                      robe_compression=1000, robe_block=32,
                      use_kernel=True).recsys_cfg("robe")
    g = torch.Generator(device=dev).manual_seed(0)
    params = trec.init_params(rc, g, dev)
    vocab = torch.tensor(CRITEO_TB_VOCABS, dtype=torch.float64, device=dev)
    u = torch.rand(CARD_B, len(CRITEO_TB_VOCABS), generator=g, device=dev,
                   dtype=torch.float64)
    batch = {"dense": torch.randn(CARD_B, 13, generator=g, device=dev),
             "sparse": (u * vocab).long().clamp_max(vocab.long() - 1)
             .to(torch.int32),
             "label": (torch.rand(CARD_B, generator=g, device=dev) < 0.3)
             .float()}
    return rc, params, batch


def _launches_under(event):
    """(op, kernel) of every kernel launched under ``event``'s host span,
    the op being the innermost one that launched it."""
    out, todo = [], [event]
    while todo:
        e = todo.pop()
        out += [(e.name, k.name) for k in e.kernels]
        todo += e.cpu_children
    return out


@pytest.mark.chip
def test_card_serve_forward_fuses(card, monkeypatch):
    cfg, params, batch = _card_dlrm(card)
    with torch.inference_mode():
        trec.serve_scores(params, cfg, batch)       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            out = trec.serve_scores(params, cfg, batch)
        torch.cuda.synchronize()
    spans = {e.name: _launches_under(e) for e in prof.events()
             if e.name in ("model.bot_mlp", "model.top_mlp")}
    assert set(spans) == {"model.bot_mlp", "model.top_mlp"}, spans

    def by(span, op=None, kernel=""):
        return [k for o, k in spans[span]
                if (op is None or o == op) and kernel in k]
    # the bottom MLP: three GEMMs with the bias in their epilogue, each
    # followed by its ReLU; the top: four, then the 256 -> 1 layer's GEMV
    # and its bias add, the one add left
    assert len(by("model.bot_mlp", "aten::addmm")) >= 3, spans
    assert not by("model.bot_mlp", "aten::add"), spans
    assert len(by("model.bot_mlp", kernel="elementwise")) == 3, spans
    assert len(by("model.top_mlp", "aten::addmm")) >= 4, spans
    assert len(by("model.top_mlp", "aten::add")) == 1, spans
    assert len(by("model.top_mlp", kernel="elementwise")) == 5, spans

    nan_batch = dict(batch, dense=batch["dense"].clone())
    nan_batch["dense"][5, 0] = float("nan")
    with torch.inference_mode():
        nan_out = trec.serve_scores(params, cfg, nan_batch)
    _, grads = _logits_and_grads(cfg, params, batch, "train")
    monkeypatch.setattr(core, "bias_epilogue", lambda *a: False)
    with torch.inference_mode():
        out0 = trec.serve_scores(params, cfg, batch)
    _, grads0 = _logits_and_grads(cfg, params, batch, "train")

    rms = float(out0.pow(2).mean().sqrt())
    assert float((out - out0).abs().max()) <= 3e-5 * rms
    assert torch.isnan(nan_out[5]) and torch.isfinite(
        torch.cat([nan_out[:5], nan_out[6:]])).all()
    assert len(grads) == len(grads0)
    for g, g0 in zip(grads, grads0):
        assert float((g - g0).norm()) <= 1e-5 * float(g0.norm()), \
            (g.shape, float((g - g0).norm() / g0.norm()))
