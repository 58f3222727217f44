// Quotient-remainder lookup of the ``hashed`` substrate: [B, F] ids ->
// [B, F, d] embeddings Q[id / m + q_off[f]] * R[id % m + r_off[f]], the
// product taken in f32 and rounded once into the tables' dtype.
//
// Replaces: src/repro/kernels/qr_lookup.py, qr_lookup_pallas (body
// _kernel).
//
// Bound on an H100: bytes.  Each output element reads one element of a Q
// row and one of an R row and writes one, for one multiply.  At full
// dlrm-criteo-tb width (m = 8,192) Q is 12.8 MB and R 109 MB, so R's rows
// mostly come from device memory.
//
// Design: one warp per (row, field), lanes over d, so each warp reads one
// contiguous Q row and one R row and writes one output row, all coalesced.
// The quotient and remainder are computed in the kernel from the int32 id
// with a runtime m (any positive int, not only a power of two), with
// floor semantics as torch's // and % take them; the per-field offsets
// ride in the kernel parameters, so a launch copies nothing to the card.
// Row addresses are 64-bit.  The last block masks rows past B*F.
#include "robe_common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

struct QrParams {
  int n_fields;
  int m;
  int dim;
  int q_off[ROBE_MAX_FIELDS];
  int r_off[ROBE_MAX_FIELDS];
};

template <typename T>
__global__ void qr_lookup_kernel(const T* __restrict__ q,
                                 const T* __restrict__ rt,
                                 const int* __restrict__ idx,
                                 T* __restrict__ out, int n_rows,
                                 const QrParams p) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (r >= n_rows) return;
  const int f = r % p.n_fields;
  const int id = idx[r];
  int quo = id / p.m, rem = id - quo * p.m;
  if (rem < 0) {          // C truncates toward zero; torch and jnp floor
    rem += p.m;
    --quo;
  }
  const T* qa = q + (long long)(quo + p.q_off[f]) * p.dim;
  const T* ra = rt + (long long)(rem + p.r_off[f]) * p.dim;
  T* o = out + (long long)r * p.dim;
  for (int i = threadIdx.x; i < p.dim; i += 32)
    o[i] = from_f32<T>(to_f32(qa[i]) * to_f32(ra[i]));
}

template <typename T>
int launch(const void* q, const void* rt, const void* idx, void* out,
           int n_rows, const QrParams& p, cudaStream_t stream) {
  dim3 block(32, kRowsPerBlock);
  dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  qr_lookup_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(rt),
      static_cast<const int*>(idx), static_cast<T*>(out), n_rows, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q [sum q_rows, dim] and r [m * n_fields, dim] (dtype 0 = f32, 1 = bf16),
// idx [n_rows] int32 (n_rows = B*F, field = index % n_fields), per-field
// row offsets q_off / r_off [n_fields], out [n_rows, dim] in the tables'
// dtype.  Returns cudaGetLastError() after the launch.
extern "C" int qr_lookup_launch(const void* q, const void* r, const void* idx,
                                void* out, int n_rows, int dtype,
                                const int* q_off, const int* r_off,
                                int n_fields, int m, int dim, void* stream) {
  if (n_fields < 1 || n_fields > ROBE_MAX_FIELDS || m < 1 || dim < 1)
    return (int)cudaErrorInvalidValue;
  QrParams p;
  p.n_fields = n_fields;
  p.m = m;
  p.dim = dim;
  for (int f = 0; f < n_fields; ++f) {
    p.q_off[f] = q_off[f];
    p.r_off[f] = r_off[f];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, r, idx, out, n_rows, p, s);
    case 1: return launch<__nv_bfloat16>(q, r, idx, out, n_rows, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
