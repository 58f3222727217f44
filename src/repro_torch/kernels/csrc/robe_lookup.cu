// ROBE lookup: [B, F] row ids -> [B, F, d] embeddings gathered through the
// hashed circular array M, with the optional ±1 sign.
//
// Replaces: src/repro/kernels/robe_lookup.py, robe_lookup_pallas (bodies
// _aligned_kernel and _general_kernel; helpers _hash_rows, _signs_tile).
//
// Bound on an H100: bytes.  Each output element is one 4-byte read of M and
// one 4-byte write, against about twenty integer operations of hash.  At
// full width M holds 26.1M f32 slots (104.5 MB), more than the 50 MB L2, so
// gathers mostly go to device memory.
//
// Design: one warp per (row, field), its lanes on consecutive elements i.
// With Z >= 32 and d a multiple of 32, the 32 lanes of one step share one
// block, so their slots are contiguous and the warp reads one 128-byte run
// of M (two cache lines when the run is not aligned) -- the coalesced block
// read of the paper's Table 1.  The same code covers both Pallas regimes:
// Z % d == 0 (aligned, one slice per row) and Z < d (general, d/Z blocks
// per row).  The element index x*d + i is 64-bit (x*d passes 2^32 at full
// width) and the circular wrap is taken per element, so no padded copy of M
// is made.  Prime and ragged batches need no padding: the last block masks
// rows past B*F.
#include "robe_common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename T>
__global__ void robe_lookup_kernel(const T* __restrict__ mem,
                                   const int* __restrict__ rows,
                                   T* __restrict__ out, int n_rows,
                                   const RobeParams p) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (r >= n_rows) return;
  const unsigned int t = p.tids[r % p.n_fields];
  const unsigned long long k0 =
      (unsigned long long)(unsigned int)rows[r] * (unsigned long long)p.dim;
  T* o = out + (long long)r * p.dim;
  for (int i = threadIdx.x; i < p.dim; i += 32) {
    const unsigned long long k = k0 + (unsigned long long)i;
    T v = mem[robe_slot(p, t, k)];
    if (p.use_sign) v = from_f32<T>(to_f32(v) * robe_sign(p, t, k));
    o[i] = v;
  }
}

template <typename T>
int launch(const void* mem, const void* rows, void* out, int n_rows,
           const RobeParams& p, cudaStream_t stream) {
  dim3 block(32, kRowsPerBlock);
  dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  robe_lookup_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(mem), static_cast<const int*>(rows),
      static_cast<T*>(out), n_rows, p);
  return (int)cudaGetLastError();
}

}  // namespace

// mem [|M|] (dtype 0 = f32, 1 = bf16), rows [n_rows] int32 (n_rows = B*F,
// field = index % n_fields), out [n_rows, dim] in mem's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int robe_lookup_launch(const void* mem, const void* rows,
                                  void* out, int n_rows, int mem_dtype,
                                  const unsigned long long* coeffs,
                                  const unsigned int* tids, int n_fields,
                                  int dim, int log2_z, int use_sign,
                                  void* stream) {
  RobeParams p;
  int err = robe_make_params(&p, coeffs, tids, n_fields, dim, log2_z,
                             use_sign);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mem_dtype) {
    case 0: return launch<float>(mem, rows, out, n_rows, p, s);
    case 1: return launch<__nv_bfloat16>(mem, rows, out, n_rows, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
