"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` (a plain C interface, no PyTorch headers) are
compiled with ``nvcc`` for ``sm_90a`` into
``<repo>/build/kernels/librepro_torch_kernels.so`` at first use, one
``nvcc -c`` per source, all started together, then linked once.  The
library is rebuilt whenever a source, a header or the flags change (a
SHA-256 stamp sits beside it) and replaced atomically, so concurrent
processes never load a half-written file.  A failed build raises with the
compiler's output; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _ll, _u64p, _u32p, _i32p = (ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_uint64),
                                    ctypes.POINTER(ctypes.c_uint32),
                                    ctypes.POINTER(ctypes.c_int32))
MAX_FIELDS = 128      # ROBE_MAX_FIELDS in csrc/robe_common.cuh
#: shared memory a block may use on Hopper (bytes): kSmemLimit in
#: csrc/robe_common.cuh
MAX_SMEM = 227 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: argtypes of every entry point: pointers and the stream as c_void_p, or
#: ctypes would pass them as 32-bit ints and cut them
SIGNATURES = {
    "robe_lookup_launch": (_p, _p, _p, _i, _i, _u64p, _u32p, _i, _i, _i, _i,
                           _p),
    "dot_interaction_launch": (_p, _p, _i, _i, _i, _i, _i, _p),
    "serve_fused_launch": (_p, _p, _p, _p, _i, _i, _i, _i, _u64p, _u32p, _i,
                           _i, _i, _i, _p),
    "qrobe_lookup_launch": (_p, _p, _p, _p, _p, _i, _i, _u64p, _u32p, _i, _i,
                            _i, _i, _i, _p),
    "qr_lookup_launch": (_p, _p, _p, _p, _i, _i, _i32p, _i32p, _i, _i, _i,
                         _p),
    "tt_lookup_launch": (_p, _p, _p, _p, _p, _i, _i, _i32p, _i, _i, _i, _i,
                         _i, _i, _i, _i, _p),
    "robe_lookup_bwd_launch": (_p, _p, _p, _p, _p, _ll, _i, _i, _ll, _ll,
                               _u64p, _u32p, _i, _i, _i, _i, _p),
    "dot_interaction_bwd_launch": (_p, _ll, _p, _p, _i, _i, _i, _i, _i, _p),
    "qrobe_lookup_bwd_launch": (_p, _p, _p, _p, _p, _p, _ll, _i, _i, _ll,
                                _ll, _u64p, _u32p, _i, _i, _i, _i, _i, _p),
    "qr_lookup_bwd_launch": (_p, _p, _p, _p, _p, _p, _p, _p, _p, _ll, _i, _i,
                             _ll, _ll, _i32p, _i32p, _i, _i, _i, _ll, _ll,
                             _p),
    "tt_lookup_bwd_launch": (_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
                             _ll, _i, _i, _ll, _ll, _i32p, _i, _i, _i, _i,
                             _i, _i, _i, _i, _p),
}


def align(n: int, a: int = 256) -> int:
    """n rounded up to a multiple of a: the parts of the kernels' scratch
    are 256-byte aligned."""
    return -(-n // a) * a


#: keys of a tile of the sorts' scan: kRsTile in csrc/row_sort.cuh
SORT_TILE = 4096


def row_sort_bytes(n_keys: int, n_items: int) -> int:
    """Scratch bytes of one sort of ``n_items`` items by ``n_keys`` keys in
    the backwards of the compressed substrates (``rs_scratch_bytes`` in
    csrc/row_sort.cuh): a count a key, a sum a tile of the scan, then an
    (item, key) pair an item, each part 256-byte aligned."""
    return (align(4 * n_keys) + align(4 * -(-n_keys // SORT_TILE))
            + align(8 * n_items))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def _stamp(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library if it is missing or stale; return its path."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    stamp = _stamp(sources)
    lib = build_dir / LIB_NAME
    stamp_file = build_dir / (LIB_NAME + ".sha256")
    if (lib.exists() and stamp_file.exists()
            and stamp_file.read_text() == stamp):
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tmp = Path(tmp)
        procs = []
        for src in (s for s in sources if s.suffix == ".cu"):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        (build_dir / "build.log").write_text("\n".join(log))
        failed = [src.name for src, _, proc in procs if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
        tmp_stamp = tmp / "stamp"
        tmp_stamp.write_text(stamp)
        os.replace(tmp_stamp, stamp_file)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype code: 0 = float32, 1 = bfloat16."""
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"the kernels take float32 or bfloat16, got "
                        f"{t.dtype}") from None


def fastmod_const(m: int) -> int:
    """Lemire's fastmod constant ceil(2^64 / m) mod 2^64 for a divisor
    1 <= m < 2^32: the kernels take ``r % m`` as ``((c * r) mod 2^64) * m
    >> 64``, exact for every 32-bit ``r``."""
    if not 1 <= m < 2 ** 32:
        raise ValueError(f"fastmod needs 1 <= m < 2^32, got {m}")
    return ((2 ** 64 - 1) // m + 1) % 2 ** 64


@functools.lru_cache(maxsize=64)
def hash_args(spec, tids: tuple) -> tuple:
    """ctypes arrays of the slot and sign hash coefficients -- (a_t, a2,
    a1, a0, b, m, fastmod_const(m)) of each, 14 uint64 -- and the per-field
    table ids (uint32) for a launcher; cached, since drawing the
    coefficients costs more than a launch.  The arrays are only read."""
    if not 0 < len(tids) <= MAX_FIELDS or min(tids) < 0 or \
            max(tids) >= 2 ** 31:
        raise ValueError(f"need 1..{MAX_FIELDS} table ids in [0, 2^31), "
                         f"got {len(tids)}")
    coeffs = []
    for h in (spec.hash_fn(), spec.sign_fn()):
        c = h.coefficients()
        coeffs += [*c, fastmod_const(c[-1])]
    return ((ctypes.c_uint64 * len(coeffs))(*coeffs),
            (ctypes.c_uint32 * len(tids))(*tids))


@functools.lru_cache(maxsize=64)
def field_args(values: tuple):
    """A ctypes int32 array of per-field row offsets for a launcher (1 to
    MAX_FIELDS of them, each in [0, 2^31)); cached, and only read."""
    if not 0 < len(values) <= MAX_FIELDS or min(values) < 0 or \
            max(values) >= 2 ** 31:
        raise ValueError(f"need 1..{MAX_FIELDS} offsets in [0, 2^31), got "
                         f"{len(values)}")
    return (ctypes.c_int32 * len(values))(*values)


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an int for c_void_p."""
    return torch.cuda.current_stream(t.device).cuda_stream
