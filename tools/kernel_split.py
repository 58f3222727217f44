"""Split the time of the port's redesigned kernels into their parts.

    python3 tools/kernel_split.py [--only di,sf,tt,rl,qb,db,rb,tb,qd,qg]
                                  [CSRC_DIR ...]

Builds variants of ten kernels from the sources in each CSRC_DIR (by
default ``src/repro_torch/kernels/csrc``; an older tree works too, e.g.
from ``git archive <commit> src/repro_torch/kernels/csrc | tar -x -C
build/old``), each as it is and with one part taken out:

- ``dot_interaction``: the gram skipped (the kernel writes one value per
  sample instead, so its loads stay live);
- ``serve_fused``: the gram skipped; the sign hash replaced by a constant;
- ``tt_lookup``: the chain skipped (the core slices are gathered and one
  value per item is written); the gathers skipped (every item reads the
  slices of row 0: the index split and the gathers go, the chain and the
  stores stay); stores only; and, where the output is stored with the
  streaming (evict-first) hint, plain stores instead;
- ``robe_lookup``: the block hash replaced by a constant (each slot is the
  element's offset in its block, so the hash goes and every gather hits
  L1); stores only; plain stores instead of streaming ones, where used;
- ``qrobe_lookup``: the same three, each timed without and, where the
  launcher takes it, with the ``delta`` operand;
- ``dot_interaction_bwd``: the contraction skipped (one value per tile
  is written from its first operands, so the staging loads stay live);
- ``robe_lookup_bwd``: the atomics skipped (the walk, the hash and the
  reads of g stay, their slot and value kept live by a store that never
  fires); the atomics aimed at an L2-resident window of M (each slot
  masked into its low 2^23 slots, 32 MiB), so that the cost of L2 misses
  and that of contention show apart; where the launcher buckets the
  pairs by band of M first, also the bucketing passes alone.  Each
  ``robe_lookup_bwd`` call is timed with the zeroing of its |M| f32
  workspace, as the wrapper does it, and the zeroing alone beside it;
- ``tt_lookup_bwd``: the contractions skipped (the first design's per-item
  t / dt and accumulator loops replaced by one add a row element of the
  staged slices; the ranked walk's three R x R contractions -- t = c1.c2,
  dc1's dt.c2^T and dc2's c1^T.dt -- replaced by adds, its loop over g's
  columns with dt, dc3 and their shuffles kept), so the loads and the
  atomics stay live; the global gradient atomics skipped (kept live by a
  store that never fires); the sort passes alone (the walks' launches
  dropped);
- ``qr_lookup_bwd``: the walks' atomics skipped (the same store that never
  fires); the sort passes alone.  Each call of the two with the zeroing of
  its f32 workspaces, as the wrappers do;
- ``qrobe_lookup_bwd``: its gradient atomics skipped (the same store that
  never fires: the band-ordered walk's REDs into delta's gradient and its
  atomics into the scales', or the first design's scatter atomics from
  robe_scatter.cuh, which the tool inlines); the sort passes alone (the
  walk's launch dropped; in the first design the scatter's and the group
  pass's); in the band-ordered design, every window flushed by the
  general line flush (``qb_flush_lines``) instead of the per-group path
  of windows that lie in one group.  Each call with the zeroing of
  delta's and the scales' gradients, as the wrapper does; f32.

Each variant is compiled with nvcc into its own library under
``build/kernel_split/`` (all at once) and timed at B=512 and B=262144 on
the ``dlrm-criteo-tb`` widths (F=26, d=128, Z=32, |M| = 26,135,627; int8
codes with one f32 scale per 256 slots; TT factors (589, 589, 589), dims
(2, 8, 8), rank 8) with CUDA events (median
of 21 runs of 8 back-to-back launches), beside ``torch.bmm`` on the same
[B, 27, 128] input; the two backwards at B=512 and B=65536 (the training
batch), ``dot_interaction_bwd`` beside ``torch.bmm(sym, feats)``; the
substrates' three backwards at B=512 and B=65536 on the full-width tables
(QR: m = 8,192, 24,941 Q rows and 212,992 R rows; qrobe: int8 codes, a
scale per 256 slots).
Several CSRC_DIRs are timed in one process, in turns; ``--only`` keeps
the named kernels (di = dot_interaction, sf = serve_fused, tt =
tt_lookup, rl = robe_lookup, qb = qrobe_lookup, db =
dot_interaction_bwd, rb = robe_lookup_bwd, tb = tt_lookup_bwd, qd =
qr_lookup_bwd, qg = qrobe_lookup_bwd).
Prints one JSON object, the card's name and power limit included.  The
variants are made at run time and never kept in the repository.  Needs
one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.recsys_archs import CRITEO_TB_VOCABS  # noqa: E402
from repro_torch.core.robe import RobeSpec, init_memory  # noqa: E402
from repro_torch.data import CtrDataConfig, CtrStream  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.tt_lookup import plan as tt_plan  # noqa: E402

OUT = ROOT / "build" / "kernel_split"
NVCC = ("/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared")
F, D, SIZE = 26, 128, 26_135_627
TT_FACTORS, TT_DIMS, TT_RANK = (589, 589, 589), (2, 8, 8), 8

# the gram skipped: the first port's epilogue (gram_tril in
# robe_common.cuh), then the warp gram of gram.cuh
SKIP_OLD = r'''
template <typename TO>
__device__ void skip_gram(const float* s, int n, int dim, int self, TO* out) {
  const int pairs = gram_pairs(n, self), tot = n * gram_ld(dim);
  float acc = 0.f;
  for (int e = threadIdx.x; e < tot; e += blockDim.x) acc += s[e];
  if (threadIdx.x < pairs) out[threadIdx.x] = from_f32<TO>(acc);
}
'''
GRAM_OLD = re.compile(r"gram_tril<(\w+)>\(")
GRAM_NEW = re.compile(r"gram_warp<(\w+)>\((\w+), L, stage,\s*(out \+ [^,]+), "
                      r"lane\);")
SKIP_NEW = (r"if (lane == 0) (\3)[0] = from_f32<\1>(\2[0] + "
            r"\2[gram_row(L.w4, L.n - 1)]);\n    __syncwarp();")
SIGN = re.compile(r"robe_sign\(p, [^()]*\)")

# tt_lookup's first design, one warp per item (the any-rank path since):
# (pattern, replacement, count) per variant
TT_WARP = {
    "nochain": [(r"  // t\[a, b, q\].*?o\[e\] = from_f32<T>\(acc\);\n  \}\n",
                 "  if (lane == 0) out[(long long)row * (p.d1 * d2 * d3)] = "
                 "from_f32<T>(s1[0] + s2[n2c - 1] + s3[n3c - 1]);\n", 1)],
    "nogather": [(r"\(long long\)i[123] \* ", "0LL * ", 3)],
    "storeonly": [(r"(  if \(row >= n_rows\) return;\n)",
                   r"\1  { const int dd = p.d1 * p.d2 * p.d3;\n"
                   r"    for (int e = lane; e < dd; e += 32)\n"
                   r"      out[(long long)row * dd + e] = from_f32<T>(0.f);\n"
                   r"    return; }\n", 1)],
}
# tt_lookup with the rank as a template parameter: tt_copy starts an item's
# gathers, tt_chain contracts and stores its row
TT_RANKED = {
    "nochain": [(r"tt_chain<T, R>\([^;]*;",
                 "if (jl == 0) out[item * dim] = *reinterpret_cast<const T*>("
                 "bufs + (bb * q.items + j) * q.slot + q.o2);", 1)],
    "nogather": [(r"(tt_copy<T, R>\([^;]*?), i1,\s*i2, i3,",
                  r"\1, 0u, 0u, 0u,", 1)],
    "storeonly": [(r"tt_copy<T, R>\(bufs[^;]*;", ";", 1),
                  (r"tt_chain<T, R>\([^;]*;",
                   "for (int e = jl; e < dim; e += q.lanes) "
                   "out[item * dim + e] = from_f32<T>(0.f);", 1)],
}
# the output's streaming (evict-first) stores made plain stores
PLAIN = [(r"__stcs\(([^,]+),\s*(.*?)\);", r"*(\1) = \2;", None)]
TT_RANKED["plainstore"] = PLAIN
# robe_lookup's first design, one warp per item
ROBE_WARP = {
    "nohash": [(r"mem\[robe_slot\(p, t, k\)\]",
                "mem[(unsigned int)(k & ((1ULL << p.log2_z) - 1ULL))]", 1)],
    "storeonly": [(r"T v = mem\[robe_slot\(p, t, k\)\];",
                   "T v = from_f32<T>(0.f);", 1)],
}
# robe_lookup hashing each block once: the table fill and the gathers
ROBE_BLOCK = {
    "nohash": [(r"robe_chunk_hash\([^;]*\);", "0u;", 1)],
    "storeonly": [(r"mem\[ok \? robe_chunk_slot\(.*?: 0u\]",
                   "from_f32<T>(0.f)", 1)],
    "plainstore": PLAIN,
}
# qrobe_lookup's first design, one warp per item
QROBE_WARP = {
    "nohash": [(r"robe_slot\(p, t, k\)",
                "(unsigned int)(k & ((1ULL << p.log2_z) - 1ULL))", 1)],
    "storeonly": [(r"const unsigned int slot = robe_slot\(p, t, k\);\s*"
                   r"float v = [^;]*;", "float v = 0.f;", 1)],
}
# qrobe_lookup on the block-hash table: the table fill, and a run's
# gathers of codes, scales and delta
QROBE_BLOCK = {
    "nohash": [(r"robe_chunk_hash\([^;]*\);", "0u;", 1)],
    "storeonly": [(r"qrobe_gather<T, kDelta>\(p, [^;]*\);",
                   "runs[u][i] = QRun{};", 1)],
    "plainstore": PLAIN,
}
# dot_interaction_bwd: the first design's loop over j (a scalar of feats and
# a float4 of sym a step), then the register-tiled contraction of
# bwd_contract
DB_PARTS = {
    "nocontract": [(r"for \(int j = 0; j < n; \+\+j\) \{.*?acc\[3\] = "
                    r"fmaf\([^;]*;\s*\}", "acc[0] = fs[d] + sj[0];", 1),
                   (r"bwd_contract\(acc, ([^,]+), ([^,]+), [^;]*\);",
                    r"acc[0][0] = (\1)[0] + (\2)[0];", 1)],
}
# robe_lookup_bwd: the atomic of the item-order walk, or of the band-ordered
# scatter; kept live but never fired, or masked into the low 2^23 slots
RB_SITE = re.compile(r"atomicAdd\(ws \+ (robe_chunk_slot\([^;]*?\)|\w+),"
                     r"\s*(\w+)\);")
RB_PARTS = {
    "nored": r"{ const unsigned s_ = \1; if (__float_as_uint(\2) == "
             r"0x7fc00001u) ws[s_] = \2; }",
    "l2win": r"atomicAdd(ws + ((\1) & 0x7FFFFFu), \2);",
}
# a gradient atomic kept live by a store that never fires
NEVER = r"{ if (__float_as_uint(\2) == 0x7fc00001u) *(\1) = \2; }"
# tt_lookup_bwd: the first design (three walks, per-item contractions in
# shared memory), then the ranked walk (three R x R contractions in
# registers, by helper)
TB_PARTS = {
    "nocontract": (
        [(r"      // st\[\(a\*d2 \+ b\)\*r \+ q'\].*?        sa\[e\] = "
          r"acc;\n      \}\n",
          "      __syncwarp();\n"
          "      for (int e = lane; e < row; e += 32)\n"
          "        sa[e] += s1[e % n1c] + s2[e % n2c] + s3[e % n3c] +\n"
          "                 (kG ? sg[e % dim] : 0.f);\n", 1)],
        [(r"tb_chain<R>\(c1a, c1b, c2r, t0, t1\);",
          "for (int q = 0; q < R; ++q) { t0[q] = c1a[q] + c2r[q][q]; "
          "t1[q] = c1b[q]; }", 1),
         (r"tb_dc1<R>\(dt0, dt1, c2r, d1v\);",
          "for (int x = 0; x < R; ++x) { d1v[x] = dt0[x]; "
          "d1v[R + x] = dt1[x]; }", 1),
         (r"tb_dc2<R>\(c1a, c1b, dt0, dt1, dc2\);",
          "for (int a = 0; a < R; ++a) for (int q = 0; q < R; ++q) "
          "dc2[a][q] += dt0[q] + c1a[a];", 1)]),
    "noatomic": [(r"atomicAdd\((dst \+ [^;]*?), ([\w\[\]]+)\);", NEVER,
                  None)],
    "sortonly": [(r"kernel<<<[^;]*;", ";", None)],
}
# qr_lookup_bwd: the walks' gradient atomics (into ws in the first design,
# dst in the one walk), or their launches
QD_PARTS = {
    "noatomic": [(r"atomicAdd\(((?:ws|dst) \+ [^;]*?), (\w+)\);", NEVER,
                  None)],
    "sortonly": [(r"qr_walk_kernel<[^>]*><<<[^;]*;", ";", 1)],
}
# qrobe_lookup_bwd: its gradient atomics (the band-ordered walk's four: the
# REDs of a flush and of a wrapping flush, a wrapping flush's group sums and
# a group's share, into ws and ws_scale; the first design's scatter's one,
# into ws), or the launches after the sort passes
QG_SITE = r"atomicAdd\((ws\w* \+ \w+),\s*(\w+)\);"
QG_PARTS = {
    "noatomic": ([(QG_SITE, NEVER, 1)], [(QG_SITE, NEVER, 4)]),
    "sortonly": ([(r"rb_scatter_kernel<T><<<[^;]*;", ";", 1),
                  (r"qrobe_group_kernel<T><<<[^;]*;", ";", 1)],
                 [(r"qb_walk_kernel<T, kSign><<<[^;]*;", ";", 1)]),
    # every window through the general flush (qb_flush_lines), the common
    # case's per-group path bypassed
    "lines": (None, [(r"if \(group_log2 < kBandLog2 \|\| base \+ 64 > m\) "
                      r"\{", "if (true) {", 1)]),
}
#: variant name -> (source, launcher, {generation: transforms} or flags)
VARIANTS = {
    "di": ("dot_interaction.cu", {}),
    "di_nogram": ("dot_interaction.cu", {"nogram": True}),
    "sf": ("serve_fused.cu", {}),
    "sf_nogram": ("serve_fused.cu", {"nogram": True}),
    "sf_nosign": ("serve_fused.cu", {"nosign": True}),
    "sf_nogram_nosign": ("serve_fused.cu", {"nogram": True, "nosign": True}),
    "tt": ("tt_lookup.cu", {}),
    "tt_nochain": ("tt_lookup.cu", {"part": "nochain"}),
    "tt_nogather": ("tt_lookup.cu", {"part": "nogather"}),
    "tt_storeonly": ("tt_lookup.cu", {"part": "storeonly"}),
    "tt_plainstore": ("tt_lookup.cu", {"part": "plainstore"}),
    "rl": ("robe_lookup.cu", {}),
    "rl_nohash": ("robe_lookup.cu", {"part": "nohash"}),
    "rl_storeonly": ("robe_lookup.cu", {"part": "storeonly"}),
    "rl_plainstore": ("robe_lookup.cu", {"part": "plainstore"}),
    "qb": ("qrobe_lookup.cu", {}),
    "qb_nohash": ("qrobe_lookup.cu", {"part": "nohash"}),
    "qb_storeonly": ("qrobe_lookup.cu", {"part": "storeonly"}),
    "qb_plainstore": ("qrobe_lookup.cu", {"part": "plainstore"}),
    "db": ("dot_interaction_bwd.cu", {}),
    "db_nocontract": ("dot_interaction_bwd.cu", {"part": "nocontract"}),
    "rb": ("robe_lookup_bwd.cu", {}),
    "rb_nored": ("robe_lookup_bwd.cu", {"part": "nored"}),
    "rb_l2win": ("robe_lookup_bwd.cu", {"part": "l2win"}),
    "rb_bucketonly": ("robe_lookup_bwd.cu", {"part": "bucketonly"}),
    "tb": ("tt_lookup_bwd.cu", {}),
    "tb_nocontract": ("tt_lookup_bwd.cu", {"part": "nocontract"}),
    "tb_noatomic": ("tt_lookup_bwd.cu", {"part": "noatomic"}),
    "tb_sortonly": ("tt_lookup_bwd.cu", {"part": "sortonly"}),
    "qd": ("qr_lookup_bwd.cu", {}),
    "qd_noatomic": ("qr_lookup_bwd.cu", {"part": "noatomic"}),
    "qd_sortonly": ("qr_lookup_bwd.cu", {"part": "sortonly"}),
    "qg": ("qrobe_lookup_bwd.cu", {}),
    "qg_noatomic": ("qrobe_lookup_bwd.cu", {"part": "noatomic"}),
    "qg_sortonly": ("qrobe_lookup_bwd.cu", {"part": "sortonly"}),
    "qg_lines": ("qrobe_lookup_bwd.cu", {"part": "lines"}),
}
#: the kernels timed by time_backwards and time_sub_backwards
BACKWARDS = ("db", "rb", "tb", "qd", "qg")
LAUNCHERS = {"di": "dot_interaction_launch", "sf": "serve_fused_launch",
             "tt": "tt_lookup_launch", "rl": "robe_lookup_launch",
             "qb": "qrobe_lookup_launch", "db": "dot_interaction_bwd_launch",
             "rb": "robe_lookup_bwd_launch", "tb": "tt_lookup_bwd_launch",
             "qd": "qr_lookup_bwd_launch", "qg": "qrobe_lookup_bwd_launch"}
QROBE_GROUP_LOG2 = 8


def is_old(csrc: Path) -> bool:
    return "gram_tril" in (csrc / "robe_common.cuh").read_text()


def subst(text: str, rules, name: str) -> str:
    """Each rule applied `count` times (None: at least once)."""
    for pat, repl, count in rules:
        text, k = re.subn(pat, repl, text, flags=re.S)
        assert k == count if count is not None else k > 0, (name, pat, k)
    return text


def variant(csrc: Path, tag: str, name: str, src: str, nogram=False,
            nosign=False, part=None):
    text = (csrc / src).read_text()
    if src in ("robe_lookup_bwd.cu", "qrobe_lookup_bwd.cu") and \
            "robe_scatter.cuh" in text:
        # the passes live in a shared header: inline it, so the marked
        # sites are in the variant's own text
        text = text.replace(
            '#include "robe_scatter.cuh"',
            (csrc / "robe_scatter.cuh").read_text().replace(
                "#pragma once\n", ""))
    if nogram and is_old(csrc):
        text = text.replace('#include "robe_common.cuh"',
                            '#include "robe_common.cuh"\n' + SKIP_OLD)
        text, k = GRAM_OLD.subn(r"skip_gram<\1>(", text)
    elif nogram:
        text, k = GRAM_NEW.subn(SKIP_NEW, text)
    if nogram:
        assert k == 1, name
    if nosign:
        text, k = SIGN.subn("(-1.f)", text)
        assert k >= 1, name
    if part and src == "dot_interaction_bwd.cu":
        pat, repl, _ = DB_PARTS[part][int("bwd_contract" in text)]
        text = subst(text, [(pat, repl, 1)], name)
    elif part and src == "tt_lookup_bwd.cu":
        rules = TB_PARTS[part]
        if part == "nocontract":
            rules = rules[int("tb_chain<R>" in text)]
        text = subst(text, rules, name)
    elif part and src == "qr_lookup_bwd.cu":
        text = subst(text, QD_PARTS[part], name)
    elif part and src == "qrobe_lookup_bwd.cu":
        rules = QG_PARTS[part][int("qb_walk_kernel" in text)]
        if rules is None:           # a part this design does not have
            return None
        text = subst(text, rules, name)
    elif part and src == "robe_lookup_bwd.cu":
        if part == "bucketonly":
            # the band-ordered design's scatter launch dropped
            if "rb_scatter_kernel" not in text:
                return None
            text = subst(text, [(r"rb_scatter_kernel<T><<<[^;]*;", ";", 1)],
                         name)
        else:
            text = subst(text, [(RB_SITE.pattern, RB_PARTS[part], 1)], name)
    elif part:
        if src == "tt_lookup.cu":
            rules = TT_RANKED if "tt_chain<" in text else TT_WARP
        elif src == "qrobe_lookup.cu":
            rules = QROBE_BLOCK if "qrobe_gather" in text else QROBE_WARP
        else:
            rules = ROBE_BLOCK if "robe_chunk_slot" in text else ROBE_WARP
        if part not in rules:       # a part this design does not have
            return None
        if part == "plainstore" and "__stcs" not in text:
            # the streaming stores live in the shared header: inline it
            text = text.replace(
                '#include "robe_common.cuh"',
                (csrc / "robe_common.cuh").read_text().replace(
                    "#pragma once\n", ""))
        text = subst(text, rules[part], name)
    out = OUT / tag / (name + ".cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def build(csrc: Path, cu: Path):
    lib = cu.with_suffix(".so")
    cmd = [*NVCC, "-I", str(csrc), "-o", str(lib), str(cu)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def n_params(text: str, launcher: str) -> int:
    m = re.search(r'extern "C" int ' + launcher + r"\(([^)]*)\)", text)
    return len(m.group(1).split(","))


def device_ms(fn, inputs, inner=8, reps=21):
    fn(*inputs[0])
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        a.record()
        for i in range(inner):
            fn(*inputs[i % len(inputs)])
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / inner)
    return statistics.median(per)


def hash_coeffs(spec, tids, old: bool):
    """The launchers' coefficient array: the first port read 12 (no
    fastmod constants), the later ones read 14."""
    co, ta = _build.hash_args(spec, tids)
    if not old:
        return co, ta
    vals = list(co)
    return (ctypes.c_uint64 * 12)(*(vals[0:6] + vals[7:13])), ta


def load(trees: dict, only) -> dict:
    """{tag: {variant: (launcher, an older launcher)}}: every variant of
    every tree written first, then all built at once.  An older launcher
    lacks one argument: tt_lookup's first took no instance, qrobe_lookup's
    before the delta operand no delta."""
    names = [k for k in VARIANTS if not only or k.split("_")[0] in only]
    cus = {(tag, k): variant(csrc, tag, k, VARIANTS[k][0], **VARIANTS[k][1])
           for tag, csrc in trees.items() for k in names}
    procs = {key: build(trees[key[0]], cu) for key, cu in cus.items()
             if cu is not None}
    logs = {key: p.communicate()[0] for key, (_, p) in procs.items()}
    failed = [key for key, (_, p) in procs.items() if p.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" +
                           "\n".join(logs[key] for key in failed))
    fns = {tag: {} for tag in trees}
    for (tag, k), (lib, _) in procs.items():
        name = LAUNCHERS[k.split("_")[0]]
        fn = getattr(ctypes.CDLL(str(lib)), name)
        argtypes = _build.SIGNATURES[name]
        older = n_params((trees[tag] / VARIANTS[k][0]).read_text(),
                         name) < len(argtypes)
        if older and k.startswith("rb"):   # no scratch, scratch_bytes
            argtypes = argtypes[:4] + argtypes[6:]
        elif older:
            drop = 2 if k.startswith("qb") else len(argtypes) - 2
            argtypes = argtypes[:drop] + argtypes[drop + 1:]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[tag][k] = (fn, older)
    return fns


def time_backwards(trees, res, spec, tids, gen, dev, s) -> None:
    """The variants of the two backwards at B=512 and the training batch
    B=65536, on the first zipf batches of the CTR stream (F=26 fields; the
    interaction's 27 rows)."""
    from repro_torch.kernels.ref import interaction_sym
    from repro_torch.kernels.robe_lookup import bwd_plan
    n = F + 1
    p = n * (n - 1) // 2
    ws = torch.empty(SIZE, device=dev)
    scratch = torch.empty(0, dtype=torch.uint8, device=dev)
    for b, n_in in ((512, 8), (65536, 2)):
        stream = CtrStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                         n_dense=13, batch_size=b, seed=0))
        rows = [torch.from_numpy(stream.batch_at(100 + k)["sparse"]).to(dev)
                for k in range(n_in)]
        gs = [torch.randn((b, F, D), generator=gen, device=dev)
              for _ in range(n_in)]
        feats = [torch.randn((b, n, D), generator=gen, device=dev)
                 for _ in range(n_in)]
        gts = [torch.randn((b, p), generator=gen, device=dev)
               for _ in range(n_in)]
        dout = torch.empty((b, n, D), device=dev)
        need = bwd_plan(spec, F, b * F, D).scratch_bytes
        if scratch.numel() < need:
            scratch = torch.empty(need, dtype=torch.uint8, device=dev)
        co, ta = _build.hash_args(spec, tids)
        res[f"zero_ws_{b}"] = device_ms(lambda: ws.zero_(), [()])
        for k in VARIANTS:
            if not k.startswith(("db", "rb")):
                continue
            for tag, (_, _, fns) in trees.items():
                if k not in fns:
                    continue
                fn, older = fns[k]
                key = f"{tag}_{k}_{b}"
                if k.startswith("db"):
                    res[key] = device_ms(
                        lambda g, x, fn=fn: fn(g.data_ptr(), p, x.data_ptr(),
                                               dout.data_ptr(), b, n, D, 0, 0,
                                               s), list(zip(gts, feats)))
                    continue
                extra = () if older else (scratch.data_ptr(), scratch.numel())

                def call(r, g, fn=fn, extra=extra):
                    ws.zero_()
                    err = fn(g.data_ptr(), r.data_ptr(), ws.data_ptr(),
                             ws.data_ptr(), *extra, b * F, 0, F * D, D, co,
                             ta, F, D, spec.log2_z, 0, s)
                    assert err == 0, (k, err)
                res[key] = device_ms(call, list(zip(rows, gs)))
        syms = [interaction_sym(g, n, False) for g in gts]
        res[f"bmm_sym_{b}"] = device_ms(torch.bmm, list(zip(syms, feats)))
        del rows, gs, feats, gts, dout, syms
        torch.cuda.empty_cache()


def time_sub_backwards(trees, res, gen, dev, s) -> None:
    """The variants of tt_lookup_bwd, qr_lookup_bwd and qrobe_lookup_bwd at
    B=512 and the training batch B=65536, on the first zipf batches of the
    CTR stream and the full-width tables, each call with the zeroing of its
    f32 workspaces (tt's three cores, QR's two tables, delta's and the
    scales' gradients) as the wrappers do."""
    from repro_torch.kernels.qrobe_lookup import bwd_plan as qg_plan
    from repro_torch.kernels.robe_lookup import bwd_plan as rb_plan
    from repro_torch.nn.embedding_backends.hashed import (default_buckets,
                                                          qr_layout)
    m = default_buckets(tuple(CRITEO_TB_VOCABS))
    q_rows, q_off, r_off = qr_layout(tuple(CRITEO_TB_VOCABS), m)
    n_q, n_r = sum(q_rows), F * m
    qt = torch.randn((n_q, D), generator=gen, device=dev)
    rt = torch.randn((n_r, D), generator=gen, device=dev)
    ws_q, ws_r = torch.empty_like(qt), torch.empty_like(rt)
    qo = _build.field_args(tuple(int(o) for o in q_off))
    ro = _build.field_args(tuple(int(o) for o in r_off))
    (n1, n2, n3), (d1, d2, d3), r = TT_FACTORS, TT_DIMS, TT_RANK
    cores = [0.3 * torch.randn(shape, generator=gen, device=dev) for shape
             in ((n1, d1, r), (n2, r, d2, r), (n3, r, d3))]
    tws = [torch.empty_like(c) for c in cores]
    tt_off = [0]
    for v in CRITEO_TB_VOCABS[:-1]:
        tt_off.append(tt_off[-1] + v)
    off_arr = _build.field_args(tuple(tt_off))
    spec = RobeSpec(size=SIZE, block_size=32, seed=0)
    tids = tuple(range(F))
    codes = torch.randint(-127, 128, (SIZE,), dtype=torch.int8,
                          generator=gen, device=dev)
    gl = QROBE_GROUP_LOG2
    gdelta = torch.empty(SIZE, device=dev)
    gscale = torch.empty(-(-SIZE >> gl), device=dev)
    co, ta = _build.hash_args(spec, tids)
    for b, n_in in ((512, 8), (65536, 2)):
        stream = CtrStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                         n_dense=13, batch_size=b, seed=0))
        rows = [torch.from_numpy(stream.batch_at(100 + k)["sparse"]).to(dev)
                for k in range(n_in)]
        gs = [torch.randn((b, F, D), generator=gen, device=dev)
              for _ in range(n_in)]
        # the QR sort's keys, and tt's: (i2, i3) in the ranked walk; the
        # qrobe backward's bucketed pairs, either design's
        nbytes = max(_build.row_sort_bytes(max(n_q, n_r, n2 * n3), b * F),
                     rb_plan(spec, F, b * F, D).scratch_bytes,
                     qg_plan(spec, b * F, D, gl).scratch_bytes)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)

        def qd_call(x, g, fn):
            ws_q.zero_()
            ws_r.zero_()
            err = fn(g.data_ptr(), qt.data_ptr(), rt.data_ptr(),
                     x.data_ptr(), ws_q.data_ptr(), ws_r.data_ptr(),
                     ws_q.data_ptr(), ws_r.data_ptr(), scratch.data_ptr(),
                     nbytes, b * F, 0, F * D, D, qo, ro, F, m, D, n_q, n_r,
                     s)
            assert err == 0, err

        def tb_call(x, g, fn):
            for w in tws:
                w.zero_()
            err = fn(g.data_ptr(), *(c.data_ptr() for c in cores),
                     x.data_ptr(), *(w.data_ptr() for w in tws),
                     *(w.data_ptr() for w in tws), scratch.data_ptr(),
                     nbytes, b * F, 0, F * D, D, off_arr, F, n1, n2, n3, d1,
                     d2, d3, r, s)
            assert err == 0, err

        def qg_call(x, g, fn):
            gdelta.zero_()
            gscale.zero_()
            err = fn(g.data_ptr(), x.data_ptr(), codes.data_ptr(),
                     gdelta.data_ptr(), gscale.data_ptr(), scratch.data_ptr(),
                     nbytes, b * F, 0, F * D, D, co, ta, F, D, spec.log2_z,
                     0, gl, s)
            assert err == 0, err

        res[f"zero_qr_ws_{b}"] = device_ms(
            lambda: (ws_q.zero_(), ws_r.zero_()), [()])
        res[f"zero_qrobe_ws_{b}"] = device_ms(
            lambda: (gdelta.zero_(), gscale.zero_()), [()])
        for k in VARIANTS:
            if not k.startswith(("tb", "qd", "qg")):
                continue
            call = {"tb": tb_call, "qd": qd_call, "qg": qg_call}[k[:2]]
            for tag, (_, _, fns) in trees.items():
                if k in fns:
                    res[f"{tag}_{k}_{b}"] = device_ms(
                        lambda x, g, fn=fns[k][0], call=call: call(x, g, fn),
                        list(zip(rows, gs)))
        del rows, gs, scratch
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA card", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    only = None
    if args[:1] == ["--only"]:
        only, args = set(args[1].split(",")), args[2:]
    dirs = [Path(a).resolve() for a in args] or \
        [ROOT / "src/repro_torch/kernels/csrc"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.time()
    fns = load({f"t{i}": d for i, d in enumerate(dirs)}, only)
    trees = {f"t{i}": (d, is_old(d), fns[f"t{i}"])
             for i, d in enumerate(dirs)}
    res = {"card": smi, "build_s": time.time() - t0,
           **{tag: {"csrc": str(d)} for tag, (d, _, _) in trees.items()}}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    spec = RobeSpec(size=SIZE, block_size=32, seed=0)
    memory = init_memory(gen, spec, dev)
    tids = tuple(range(F))
    s = torch.cuda.current_stream().cuda_stream
    tt_off = [0]
    for v in CRITEO_TB_VOCABS[:-1]:
        tt_off.append(tt_off[-1] + v)
    (n1, n2, n3), (d1, d2, d3), r = TT_FACTORS, TT_DIMS, TT_RANK
    cores = [0.3 * torch.randn(shape, generator=gen, device=dev) for shape in
             ((n1, d1, r), (n2, r, d2, r), (n3, r, d3))]
    tt_inst = tt_plan(d1, d2, d3, r, 4, cores)[0]
    codes = torch.randint(-127, 128, (SIZE,), dtype=torch.int8, generator=gen,
                          device=dev)
    qscale = 0.01 + 0.05 * torch.rand(-(-SIZE >> QROBE_GROUP_LOG2),
                                      generator=gen, device=dev)
    delta = torch.zeros(SIZE, device=dev)
    off_arr = _build.field_args(tuple(tt_off))
    forwards = not only or bool(only - set(BACKWARDS))
    for b, n_in in ((512, 8), (262144, 1)) if forwards else ():
        stream = CtrStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                         n_dense=13, batch_size=b, seed=0))
        rows = [torch.from_numpy(stream.batch_at(100 + k)["sparse"]).to(dev)
                for k in range(n_in)]
        feats = [torch.randn((b, F + 1, D), generator=gen, device=dev)
                 for _ in range(n_in)]
        bots = [torch.randn((b, D), generator=gen, device=dev)
                for _ in range(n_in)]
        out = torch.empty((b, (F + 1) * F // 2), device=dev)
        emb = torch.empty((b, F, D), device=dev)
        for k in VARIANTS:
            if k.startswith(BACKWARDS):   # timed by the two below
                continue
            for tag, (csrc, old, fns) in trees.items():
                if k not in fns:
                    continue
                fn, older = fns[k]
                key = f"{tag}_{k}"
                if k.startswith("di"):
                    res[f"{key}_{b}"] = device_ms(
                        lambda x, fn=fn: fn(x.data_ptr(), out.data_ptr(), b,
                                            F + 1, D, 0, 0, s),
                        [(x,) for x in feats])
                elif k.startswith("tt"):
                    extra = () if older else (tt_inst,)
                    res[f"{key}_{b}"] = device_ms(
                        lambda x, fn=fn, extra=extra: fn(
                            *(c.data_ptr() for c in cores), x.data_ptr(),
                            emb.data_ptr(), b * F, 0, off_arr, F, n2, n3, d1,
                            d2, d3, r, *extra, s),
                        [(x,) for x in rows])
                elif k.startswith("qb"):
                    co, ta = hash_coeffs(spec, tids, old)
                    for dl in (None,) if older else (None, delta):
                        extra = () if older else \
                            (None if dl is None else dl.data_ptr(),)
                        sfx = "" if dl is None else "_delta"
                        res[f"{key}{sfx}_{b}"] = device_ms(
                            lambda x, fn=fn, co=co, ta=ta, extra=extra: fn(
                                codes.data_ptr(), qscale.data_ptr(), *extra,
                                x.data_ptr(), emb.data_ptr(), b * F, 0, co,
                                ta, F, D, spec.log2_z, 0, QROBE_GROUP_LOG2,
                                s),
                            [(x,) for x in rows])
                elif k.startswith("rl"):
                    co, ta = hash_coeffs(spec, tids, old)
                    res[f"{key}_{b}"] = device_ms(
                        lambda x, fn=fn, co=co, ta=ta: fn(
                            memory.data_ptr(), x.data_ptr(), emb.data_ptr(),
                            b * F, 0, co, ta, F, D, spec.log2_z, 0, s),
                        [(x,) for x in rows])
                else:
                    for sign in (False, True):
                        if k.endswith("nosign") and not sign:
                            continue
                        sp = RobeSpec(size=SIZE, block_size=32, seed=0,
                                      use_sign=sign)
                        co, ta = hash_coeffs(sp, tids, old)
                        res[f"{key}_sign{int(sign)}_{b}"] = device_ms(
                            lambda x, bt, fn=fn, co=co, ta=ta, sign=sign: fn(
                                memory.data_ptr(), x.data_ptr(),
                                bt.data_ptr(), out.data_ptr(), b, 1, 0, 0,
                                co, ta, F, D, sp.log2_z, int(sign), s),
                            list(zip(rows, bots)))
        torch.cuda.synchronize()
        res[f"bmm_{b}"] = device_ms(lambda x: torch.bmm(x, x.transpose(1, 2)),
                                    [(x,) for x in feats])
        del rows, feats, bots, out, emb
        torch.cuda.empty_cache()
    if not only or only & {"db", "rb"}:
        time_backwards(trees, res, spec, tids, gen, dev, s)
    if not only or only & {"tb", "qd", "qg"}:
        time_sub_backwards(trees, res, gen, dev, s)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
