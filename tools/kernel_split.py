"""Split the time of the dot_interaction and serve_fused kernels.

    python3 tools/kernel_split.py [CSRC_DIR]

Builds variants of the two kernels from the sources in CSRC_DIR (by default
``src/repro_torch/kernels/csrc``; an older tree works too, e.g. from ``git
archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/old``):
each as it is, with the gram skipped (the kernel writes one value per
sample instead, so its loads stay live), and serve_fused with the sign hash
replaced by a constant.  Each variant is compiled with nvcc into its own
library under ``build/kernel_split/`` and timed at B=512 and B=262144 on
the ``dlrm-criteo-tb`` widths (F=26, d=128, Z=32, |M| = 26,135,627) with
CUDA events (median of 21 runs of 8 back-to-back launches), beside
``torch.bmm`` on the same [B, 27, 128] input.  Prints one JSON object, the
card's name and power limit included.  The variants are made at run time
and never kept in the repository.  Needs one CUDA card and nvcc.
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

OUT = ROOT / "build" / "kernel_split"
NVCC = ("/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared")
F, D, SIZE = 26, 128, 26_135_627

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


def is_old(csrc: Path) -> bool:
    return "gram_tril" in (csrc / "robe_common.cuh").read_text()


def variant(csrc: Path, name: str, src: str, nogram=False, nosign=False):
    text = (csrc / src).read_text()
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
    out = OUT / (name + ".cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def build(csrc: Path, cu: Path):
    lib = cu.with_suffix(".so")
    cmd = [*NVCC, "-I", str(csrc), "-o", str(lib), str(cu)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA card", file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1] if len(sys.argv) > 1 else
                ROOT / "src/repro_torch/kernels/csrc").resolve()
    old = is_old(csrc)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    specs = {
        "di": ("dot_interaction.cu", {}),
        "di_nogram": ("dot_interaction.cu", {"nogram": True}),
        "sf": ("serve_fused.cu", {}),
        "sf_nogram": ("serve_fused.cu", {"nogram": True}),
        "sf_nosign": ("serve_fused.cu", {"nosign": True}),
        "sf_nogram_nosign": ("serve_fused.cu", {"nogram": True,
                                                "nosign": True}),
    }
    t0 = time.time()
    procs = {k: build(csrc, variant(csrc, k, s, **kw))
             for k, (s, kw) in specs.items()}
    libs = {}
    for k, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(out, file=sys.stderr)
            return 1
        libs[k] = ctypes.CDLL(str(lib))
        name = ("dot_interaction_launch" if k.startswith("di")
                else "serve_fused_launch")
        fn = getattr(libs[k], name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    res = {"card": smi, "csrc": str(csrc), "build_s": time.time() - t0}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    spec = RobeSpec(size=SIZE, block_size=32, seed=0)
    memory = init_memory(gen, spec, dev)
    tids = tuple(range(F))
    s = torch.cuda.current_stream().cuda_stream
    for b, n_in in ((512, 8), (262144, 1)):
        stream = CtrStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                         n_dense=13, batch_size=b, seed=0))
        rows = [torch.from_numpy(stream.batch_at(100 + k)["sparse"]).to(dev)
                for k in range(n_in)]
        feats = [torch.randn((b, F + 1, D), generator=gen, device=dev)
                 for _ in range(n_in)]
        bots = [torch.randn((b, D), generator=gen, device=dev)
                for _ in range(n_in)]
        out = torch.empty((b, (F + 1) * F // 2), device=dev)
        for k, lib in libs.items():
            if k.startswith("di"):
                fn = lambda x, lib=lib: lib.dot_interaction_launch(
                    x.data_ptr(), out.data_ptr(), b, F + 1, D, 0, 0, s)
                res[f"{k}_{b}"] = device_ms(fn, [(x,) for x in feats])
                continue
            for sign in (False, True):
                if k.endswith("nosign") and not sign:
                    continue
                sp = RobeSpec(size=SIZE, block_size=32, seed=0,
                              use_sign=sign)
                co, ta = hash_coeffs(sp, tids, old)
                fn = lambda r, bt, lib=lib, co=co, ta=ta, sign=sign: \
                    lib.serve_fused_launch(
                        memory.data_ptr(), r.data_ptr(), bt.data_ptr(),
                        out.data_ptr(), b, 1, 0, 0, co, ta, F, D,
                        sp.log2_z, int(sign), s)
                res[f"{k}_sign{int(sign)}_{b}"] = device_ms(
                    fn, list(zip(rows, bots)))
        res[f"bmm_{b}"] = device_ms(lambda x: torch.bmm(x, x.transpose(1, 2)),
                                    [(x,) for x in feats])
        del rows, feats, bots, out
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
