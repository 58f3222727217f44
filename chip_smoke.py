#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serve path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, the
CUDA toolkit (nvcc) and PyTorch built for CUDA.  It imports nothing of JAX
and nothing of the ``repro`` package.  Phases, each of which exits
non-zero on failure:

1. the card: ``nvidia-smi``'s name and power limit; the kernels' build
   (``nvcc`` for sm_90a, from ``src/repro_torch/kernels/csrc`` alone);
2. each Hopper kernel against its plain PyTorch version on the card, at
   the paper's ``dlrm-criteo-tb`` widths (F=26, d=128, Z=32,
   |M| = 26,135,627 f32 slots): ``robe_lookup`` exactly (torch.equal),
   ``dot_interaction`` and ``serve_fused`` within rtol = atol = 1e-5 in
   f32 and 1e-2 in bf16;
3. the main path at full width, ``EmbeddingServer.score("robe", ...)``,
   answering four padded batches of 512 requests (one with n_valid < 512)
   through the fused path (``use_kernel=True``) and the unfused path on the
   same weights, with every kernel's launch count set to 0 before each run
   and read after it; the scores must be finite, the two paths must agree
   within rtol = atol = 1e-4, and both must agree as closely with the same
   entry point run on the CPU (the plain versions);
4. times with CUDA events (median of 21 repetitions, launches queued behind
   a sleep kernel so the host does not starve the card): each kernel at
   B=512 and B=262144, its plain version at B=512, ``torch.bmm`` as the
   library yardstick of ``dot_interaction``, and ``score`` end to end;
   plus a ``torch.profiler`` breakdown of ``score`` at B=262144 by device
   kernel, with the card's busy share of the window;
5. one JSON line of kernel numbers, then, last, the ok line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np
import torch

from repro_torch.configs.recsys_archs import CRITEO_TB_VOCABS
from repro_torch.core.robe import (RobeSpec, init_memory,
                                   robe_slots)
from repro_torch.data import (CtrDataConfig, CtrStream,
                              RequestStream)
from repro_torch.kernels import (_build, dot_interaction_cuda,
                                 launch_counts, reset_launches,
                                 robe_lookup_cuda, serve_fused_cuda)
from repro_torch.kernels.ref import (dot_interaction_ref,
                                     robe_lookup_ref, serve_fused_ref)
from repro_torch.serve.server import EmbeddingServer, ServerConfig

SEED = 0
F, D = 26, 128
B_P99, B_BULK = 512, 262144           # RECSYS_SHAPES serve_p99 / serve_bulk
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SCORE_TOL = 1e-4
REPS = 21
#: card -> (device memory bytes/s, f32 FLOP/s outside the tensor cores):
#: the H100 SXM data sheet's peaks
PEAKS = {"H100": (3.35e12, 67e12)}
KERNELS = {
    "robe_lookup": dict(
        source="src/repro_torch/kernels/csrc/robe_lookup.cu",
        replaces="src/repro/kernels/robe_lookup.py:262"),
    "dot_interaction": dict(
        source="src/repro_torch/kernels/csrc/dot_interaction.cu",
        replaces="src/repro/kernels/dot_interaction.py:37"),
    "serve_fused": dict(
        source="src/repro_torch/kernels/csrc/serve_fused.cu",
        replaces="src/repro/kernels/serve_fused.py:98"),
}


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple:
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    raise SmokeFailure(f"no peak rates known for {name!r}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_rows(gen, shape, dev) -> torch.Tensor:
    """Uniform row ids per field over the CriteoTB vocabularies (so rows
    reach 40M-1, x*d past 2^32), last sample at each field's largest id."""
    vocab = torch.tensor(CRITEO_TB_VOCABS, dtype=torch.float64, device=dev)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)
    v = vocab.view((1, F) + (1,) * (len(shape) - 2))
    rows = torch.minimum(u * v, v - 1).to(torch.int32)
    rows[-1] = (v[0] - 1).to(torch.int32)
    return rows.contiguous()


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_kernels(gen, memory, spec, dev) -> dict:
    """Max abs error of each kernel against its plain version, per dtype:
    {kernel: {"float32": e, "bfloat16": e}}."""
    err = {k: {"float32": 0.0, "bfloat16": 0.0} for k in KERNELS}

    def record(k, got, want):
        key = str(got.dtype).removeprefix("torch.")
        err[k][key] = max(err[k][key], max_err(got, want))
    tids = tuple(range(F))
    rows = random_rows(gen, (B_P99, F), dev)

    # robe_lookup: a gather and a ±1 multiply, so exactly equal
    cases = [(b, dataclasses.replace(spec, use_sign=s), memory, D)
             for b in (B_P99, 509) for s in (False, True)]
    cases.append((509, dataclasses.replace(spec, use_sign=True),
                  memory.to(torch.bfloat16), D))
    aligned = RobeSpec(size=spec.size, block_size=16, seed=spec.seed,
                       use_sign=True)                      # Z = d = 16
    cases.append((509, aligned, memory, 16))
    for b, sp, mem, dim in cases:
        got = robe_lookup_cuda(mem, rows[:b], tids, dim, sp)
        want = robe_lookup_ref(mem, rows[:b], tids, dim, sp)
        require(torch.equal(got, want),
                f"robe_lookup B={b} Z={sp.block_size} d={dim} "
                f"sign={sp.use_sign} {mem.dtype}: max err "
                f"{max_err(got, want)}")
        record("robe_lookup", got, want)
    torch.cuda.synchronize()

    for b in (B_P99, 509):
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn((b, F + 1, D), generator=gen, device=dev
                                ).to(dtype)
            for self_int in (False, True):
                got = dot_interaction_cuda(feats, self_int)
                want = dot_interaction_ref(feats, self_int)
                tol = TOL[dtype]
                require(got.shape == want.shape and got.dtype == dtype
                        and torch.allclose(got.float(), want.float(),
                                           rtol=tol, atol=tol),
                        f"dot_interaction B={b} {dtype} self={self_int}: "
                        f"max err {max_err(got, want)}")
                record("dot_interaction", got, want)
    torch.cuda.synchronize()

    sp = dataclasses.replace(spec, use_sign=True)
    bag3 = random_rows(gen, (509, F, 3), dev)
    pad = torch.rand((509, F, 3), generator=gen, device=dev) < 0.3
    bag3 = torch.where(pad, torch.full_like(bag3, -1), bag3)
    bag3[0, 0, :] = -1                                      # an empty bag
    for idx in (rows, bag3.contiguous()):
        b = idx.shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            bot = torch.randn((b, D), generator=gen, device=dev).to(dtype)
            for s in (spec, sp):
                got = serve_fused_cuda(memory, idx, bot, tids, D, s)
                want = serve_fused_ref(memory, idx, bot, tids, D, s)
                tol = TOL[dtype]
                require(got.shape == want.shape and got.dtype == dtype
                        and torch.allclose(got.float(), want.float(),
                                           rtol=tol, atol=tol),
                        f"serve_fused idx={tuple(idx.shape)} {dtype} "
                        f"sign={s.use_sign}: max err {max_err(got, want)}")
                record("serve_fused", got, want)
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def padded_batches(n_valids, size: int) -> list:
    """Padded request batches from ``RequestStream``: (batch, n_valid)."""
    stream = RequestStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                         n_dense=13, batch_size=size,
                                         seed=SEED))
    out = []
    for k, n in enumerate(n_valids):
        reqs = stream.requests(n, start=k * size)
        batch = {}
        for key in ("dense", "sparse"):
            rows = np.stack([r[key] for r in reqs])
            padded = np.zeros((size,) + rows.shape[1:], rows.dtype)
            padded[:n] = rows
            batch[key] = padded
        out.append((batch, n))
    return out


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def run_path(server, batches) -> tuple:
    """Scores of every batch, with the launch counts of just this run."""
    reset_launches()
    scores = [server.score("robe", b, n) for b, n in batches]
    torch.cuda.synchronize()
    return scores, launch_counts()


def main_path(cfg: ServerConfig) -> tuple:
    fused = EmbeddingServer(cfg, device="cuda")
    params = fused.params("robe")
    unfused = EmbeddingServer(dataclasses.replace(cfg, use_kernel=False),
                              params={"robe": params}, device="cuda")
    robe_size = fused.recsys_config("robe").robe_size
    require(robe_size == 26_135_627 and
            params["embedding"]["memory"].shape == (robe_size,),
            f"ROBE array of {robe_size} slots, expected 26,135,627")
    batches = padded_batches((512, 512, 437, 512), B_P99)

    s_fused, c_fused = run_path(fused, batches)
    s_unfused, c_unfused = run_path(unfused, batches)
    print(f"launches fused path: {c_fused}; unfused path: {c_unfused}")
    require(c_fused["serve_fused"] > 0,
            "the fused path never launched serve_fused")
    require(c_unfused["robe_lookup"] > 0 and c_unfused["dot_interaction"] > 0,
            "the unfused path did not launch robe_lookup and "
            "dot_interaction")
    for (_, n), a, b in zip(batches, s_fused, s_unfused):
        require(a.shape == (n,) and b.shape == (n,),
                f"scores of shape {a.shape} / {b.shape}, expected ({n},)")
        require(np.isfinite(a).all() and np.isfinite(b).all(),
                "non-finite scores")
        require(np.allclose(a, b, rtol=SCORE_TOL, atol=SCORE_TOL),
                f"fused and unfused scores differ by "
                f"{np.abs(a - b).max()}")

    # the same entry point on the CPU (the plain versions), padded batch
    cpu = EmbeddingServer(dataclasses.replace(cfg, use_kernel=False),
                          params={"robe": to_device(params, "cpu")},
                          device="cpu")
    want = cpu.score("robe", *batches[2])
    for got in (s_fused[2], s_unfused[2]):
        require(np.allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL),
                f"card scores differ from the CPU run by "
                f"{np.abs(got - want).max()}")
    cpu_err = max(float(np.abs(want - s).max())
                  for s in (s_fused[2], s_unfused[2]))
    agree = max(float(np.abs(a - b).max()) for a, b in zip(s_fused,
                                                           s_unfused))
    print(f"main path: 4 batches of {B_P99}, n_valid "
          f"{[n for _, n in batches]}; fused vs unfused max diff {agree}; "
          f"card vs CPU max diff {cpu_err}")
    return fused, unfused, c_fused, c_unfused


# ---------------------------------------------------------------------------
# phase 4: times and bounds
# ---------------------------------------------------------------------------

def device_ms(fn, inputs, inner: int = 8) -> float:
    """Median per-call device time of ``fn(*args)`` over REPS repetitions
    of ``inner`` calls cycling through ``inputs``, queued behind a sleep
    kernel so that the calls run back to back on the card."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    per = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)          # ~20 ms: the queue fills
        start.record()
        for i in range(inner):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / inner)
    return statistics.median(per)


def host_ms(fn, reps: int = REPS) -> float:
    fn()
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        per.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per)


def touched_slots(spec, idx, chunk: int = 8192) -> int:
    """Distinct slots of M a lookup of ``idx`` [B, F(, bag)] reads (-1 pads
    read nothing): what this run's data needs from M."""
    seen = torch.zeros(spec.size, dtype=torch.bool, device=idx.device)
    tids = torch.arange(F, device=idx.device).view(
        (1, F) + (1,) * (idx.dim() - 2))
    for s in range(0, idx.shape[0], chunk):
        part = idx[s:s + chunk]
        slots = robe_slots(spec, tids, part.clamp_min(0), D)
        seen[slots[part >= 0]] = True
    return int(seen.sum())


def bound(bytes_moved: float, flops: float, rates: tuple) -> tuple:
    t_bytes, t_ops = bytes_moved / rates[0] * 1e3, flops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bulk_inputs(gen, dev, b: int, n: int) -> list:
    """``n`` distinct zipf-skewed id batches [b, F] from the CTR stream."""
    stream = CtrStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                     n_dense=13, batch_size=b, seed=SEED))
    return [torch.from_numpy(stream.batch_at(100 + k)["sparse"]).to(dev)
            for k in range(n)]


def time_kernels(gen, memory, spec, rates, dev) -> dict:
    tids = tuple(range(F))
    p = (F + 1) * F // 2
    out = {k: {} for k in KERNELS}
    for b, n_in in ((B_P99, 8), (B_BULK, 1)):
        tag = "" if b == B_P99 else "_bulk"
        rows = bulk_inputs(gen, dev, b, n_in)
        feats = [torch.randn((b, F + 1, D), generator=gen, device=dev)
                 for _ in range(n_in)]
        bots = [torch.randn((b, D), generator=gen, device=dev)
                for _ in range(n_in)]
        uniq = touched_slots(spec, rows[0])
        torch.cuda.synchronize()

        o = out["robe_lookup"]
        o["ms" + tag] = device_ms(
            lambda r: robe_lookup_cuda(memory, r, tids, D, spec),
            [(r,) for r in rows])
        o["bound_ms" + tag], o["bound_by" + tag] = bound(
            b * F * 4 + uniq * 4 + b * F * D * 4, 0, rates)
        o["library_ms" + tag] = None
        o["touched_slots" + tag] = uniq

        o = out["dot_interaction"]
        o["ms" + tag] = device_ms(dot_interaction_cuda,
                                  [(x,) for x in feats])
        o["bound_ms" + tag], o["bound_by" + tag] = bound(
            b * (F + 1) * D * 4 + b * p * 4, 2 * b * p * D, rates)
        o["library_ms" + tag] = device_ms(
            lambda x: torch.bmm(x, x.transpose(1, 2)), [(x,) for x in feats])

        o = out["serve_fused"]
        o["ms" + tag] = device_ms(
            lambda r, bt: serve_fused_cuda(memory, r, bt, tids, D, spec),
            list(zip(rows, bots)))
        o["bound_ms" + tag], o["bound_by" + tag] = bound(
            b * F * 4 + b * D * 4 + uniq * 4 + b * p * 4,
            2 * b * p * D + b * F * D, rates)
        o["library_ms" + tag] = None

        if b == B_P99:
            out["robe_lookup"]["plain_ms"] = device_ms(
                lambda r: robe_lookup_ref(memory, r, tids, D, spec),
                [(r,) for r in rows])
            out["dot_interaction"]["plain_ms"] = device_ms(
                dot_interaction_ref, [(x,) for x in feats])
            out["serve_fused"]["plain_ms"] = device_ms(
                lambda r, bt: serve_fused_ref(memory, r, bt, tids, D, spec),
                list(zip(rows, bots)))
        del rows, feats, bots
        torch.cuda.empty_cache()
    return out


def time_scores(fused, unfused) -> dict:
    out = {}
    for size in (B_P99, B_BULK):
        (batch, n), = padded_batches((size,), size)
        for name, server in (("fused", fused), ("unfused", unfused)):
            out[f"{name}_{size}"] = host_ms(
                lambda: server.score("robe", batch, n))
    return out


def profile_scores(fused, unfused, size: int = B_BULK, calls: int = 3
                   ) -> dict:
    """Device time per ``score`` call by kernel name (``torch.profiler``),
    and the card's busy share of the host-clock window, per serve path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    (batch, n), = padded_batches((size,), size)
    out = {}
    for name, server in (("fused", fused), ("unfused", unfused)):
        server.score("robe", batch, n)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                server.score("robe", batch, n)
            wall_us = (time.perf_counter() - t0) * 1e6
        per = {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                per[evt.name[:60]] = per.get(evt.name[:60], 0.0) + \
                    evt.time_range.elapsed_us()
        busy = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        out[name] = {"wall_ms": wall_us / calls / 1e3,
                     "device_ms": busy / calls / 1e3,
                     "busy_share": busy / wall_us if per else None,
                     "top_ms": {k: v / calls / 1e3 for k, v in top}}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    rates = peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
          f"peaks {rates[0] / 1e12} TB/s, {rates[1] / 1e12} TFLOP/s f32")

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build and load: {time.perf_counter() - t0:.2f} s")
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip())

    cfg = ServerConfig(vocab_sizes=CRITEO_TB_VOCABS, embed_dim=D, n_dense=13,
                       bot_mlp=(512, 256, 128),
                       top_mlp=(1024, 1024, 512, 256, 1), backends=("robe",),
                       robe_compression=1000, robe_block=32,
                       cache_capacity=0, use_kernel=True, seed=SEED)
    spec = cfg.recsys_cfg("robe").embedding_spec().robe
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    memory = init_memory(gen, spec, dev)

    t0 = time.perf_counter()
    err = check_kernels(gen, memory, spec, dev)
    print(f"kernels match their plain versions ({time.perf_counter() - t0:.1f}"
          f" s): max abs err {err}")

    t0 = time.perf_counter()
    with torch.inference_mode():
        fused, unfused, c_fused, c_unfused = main_path(cfg)
    print(f"main path ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    with torch.inference_mode():
        times = time_kernels(gen, memory, spec, rates, dev)
        scores = time_scores(fused, unfused)
        prof = profile_scores(fused, unfused)
    print(f"timing done ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"profile_score_262144": prof}))
    print(json.dumps({"score_ms": scores, "batch": B_P99,
                      "batch_bulk": B_BULK, "card": smi}))

    launches = {"robe_lookup": c_unfused["robe_lookup"],
                "dot_interaction": c_unfused["dot_interaction"],
                "serve_fused": c_fused["serve_fused"]}
    kernels = []
    for k, meta in KERNELS.items():
        row = {"name": k, "route": "cuda", **meta, "launches": launches[k],
               "max_abs_err": err[k]["float32"],
               "max_abs_err_bf16": err[k]["bfloat16"]}
        row.update(times[k])
        kernels.append(row)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
