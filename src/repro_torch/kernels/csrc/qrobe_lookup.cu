// int8 ROBE lookup: [B, F] row ids -> [B, F, d] embeddings gathered as int8
// codes through the ROBE hash and dequantized against learned per-group
// scales: out = code[slot] * scale[slot >> group_log2] * sign, computed in
// f32 and rounded once into the scale's dtype.
//
// Replaces: src/repro/kernels/robe_lookup.py, qrobe_lookup_pallas (bodies
// _q_aligned_kernel and _q_general_kernel).
//
// Bound on an H100: bytes.  Each output element reads one 1-byte code and
// (through L1, shared by the 256 slots of a group) one scale, and writes
// one 4-byte (f32) or 2-byte (bf16) value, against about twenty integer
// operations of hash and two multiplies.  The codes of the full-width
// array are 26.1 MB, so unlike the f32 ROBE array they fit the 50 MB L2;
// the output write dominates.
//
// Design: robe_lookup.cu's layout -- one warp per (row, field), lanes on
// consecutive elements i -- so with Z >= 32 one warp step reads 32
// consecutive codes, one 32-byte run.  The scale group comes from the
// WRAPPED slot: robe_slot wraps per element, and its result indexes both
// the code and the scale, so the last, partial group needs no special case
// and no padded copy of the codes is made.  Both Pallas regimes (Z % d == 0
// and Z < d) are this one code path; the last block masks rows past B*F.
#include "robe_common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename T>
__global__ void qrobe_lookup_kernel(const signed char* __restrict__ codes,
                                    const T* __restrict__ scale,
                                    const int* __restrict__ rows,
                                    T* __restrict__ out, int n_rows,
                                    int group_log2, const RobeParams p) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (r >= n_rows) return;
  const unsigned int t = p.tids[r % p.n_fields];
  const unsigned long long k0 =
      (unsigned long long)(unsigned int)rows[r] * (unsigned long long)p.dim;
  T* o = out + (long long)r * p.dim;
  for (int i = threadIdx.x; i < p.dim; i += 32) {
    const unsigned long long k = k0 + (unsigned long long)i;
    const unsigned int slot = robe_slot(p, t, k);
    float v = (float)codes[slot] * to_f32(scale[slot >> group_log2]);
    if (p.use_sign) v *= robe_sign(p, t, k);
    o[i] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* codes, const void* scale, const void* rows, void* out,
           int n_rows, int group_log2, const RobeParams& p,
           cudaStream_t stream) {
  dim3 block(32, kRowsPerBlock);
  dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  qrobe_lookup_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const signed char*>(codes), static_cast<const T*>(scale),
      static_cast<const int*>(rows), static_cast<T*>(out), n_rows,
      group_log2, p);
  return (int)cudaGetLastError();
}

}  // namespace

// codes [|M|] int8, scale [ceil(|M| / 2^group_log2)] (dtype 0 = f32,
// 1 = bf16), rows [n_rows] int32 (n_rows = B*F, field = index % n_fields),
// out [n_rows, dim] in scale's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int qrobe_lookup_launch(const void* codes, const void* scale,
                                   const void* rows, void* out, int n_rows,
                                   int scale_dtype,
                                   const unsigned long long* coeffs,
                                   const unsigned int* tids, int n_fields,
                                   int dim, int log2_z, int use_sign,
                                   int group_log2, void* stream) {
  if (group_log2 < 0 || group_log2 > 30) return (int)cudaErrorInvalidValue;
  RobeParams p;
  int err = robe_make_params(&p, coeffs, tids, n_fields, dim, log2_z,
                             use_sign);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scale_dtype) {
    case 0:
      return launch<float>(codes, scale, rows, out, n_rows, group_log2, p, s);
    case 1:
      return launch<__nv_bfloat16>(codes, scale, rows, out, n_rows,
                                   group_log2, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
