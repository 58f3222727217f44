// Tensor-train lookup of the ``tt`` substrate: [B, F] ids -> [B, F, d]
// embeddings G1[i1] . G2[i2] . G3[i3], with (i1, i2, i3) the mixed-radix
// split of the global row g = id + off[f] over (n1, n2, n3), i3 fastest.
// Cores G1 [n1, d1, r], G2 [n2, r, d2, r], G3 [n3, r, d3]; d = d1*d2*d3.
//
// Replaces: src/repro/kernels/tt_lookup.py, tt_lookup_pallas (body
// _kernel).
//
// Bound on an H100: bytes.  At full dlrm-criteo-tb width (d = 2*8*8,
// r = 8) a row costs 2*(d1*d2*r*r + d*r) = 4,096 FLOP against a 512-byte
// f32 output row: 8 FLOP per byte, below the card's f32 ratio of
// 67 TFLOP/s over 3.35 TB/s = 20.  The cores are 1.4 MB and stay in L2.
//
// Design: one warp per (row, field), eight per block.  The warp gathers its
// three core slices into its own part of shared memory as f32
// (d1*r + r*d2*r + r*d3 floats, 592 at full width), computes
// t[a,b,q] = sum_p c1[a,p] * c2[p,b,q] into shared memory in f32 (kept
// unrounded), then e[a,b,c] = sum_q t[a,b,q] * c3[q,c], each lane writing
// elements lane, lane+32, ... of the output row (coalesced), rounded once.
// All shapes are runtime ints; the wrapper checks the shared memory a block
// needs and that g stays below 2^31.  Warps share nothing, so a warp past
// B*F simply returns.
#include "robe_common.cuh"

namespace {

constexpr int kWarps = 8;

struct TtParams {
  int n_fields;
  int n2, n3;
  int d1, d2, d3, r;
  int off[ROBE_MAX_FIELDS];
};

// Shared-memory floats one (row, field) uses: the three core slices and t.
__host__ __device__ inline int tt_item_floats(const TtParams& p) {
  return p.d1 * p.r + p.r * p.d2 * p.r + p.r * p.d3 + p.d1 * p.d2 * p.r;
}

template <typename T>
__global__ void tt_lookup_kernel(const T* __restrict__ c0,
                                 const T* __restrict__ c1,
                                 const T* __restrict__ c2,
                                 const int* __restrict__ idx,
                                 T* __restrict__ out, int n_rows,
                                 const TtParams p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;
  const int r = p.r, d2 = p.d2, d3 = p.d3;
  const int n1c = p.d1 * r, n2c = r * d2 * r, n3c = r * d3;
  float* s1 = smem + warp * tt_item_floats(p);
  float* s2 = s1 + n1c;
  float* s3 = s2 + n2c;
  float* st = s3 + n3c;                                  // t [d1, d2, r]

  const int g = idx[row] + p.off[row % p.n_fields];
  const int i3 = g % p.n3, rest = g / p.n3;
  const int i2 = rest % p.n2, i1 = rest / p.n2;
  const T* g1 = c0 + (long long)i1 * n1c;
  const T* g2 = c1 + (long long)i2 * n2c;
  const T* g3 = c2 + (long long)i3 * n3c;
  for (int e = lane; e < n1c; e += 32) s1[e] = to_f32(g1[e]);
  for (int e = lane; e < n2c; e += 32) s2[e] = to_f32(g2[e]);
  for (int e = lane; e < n3c; e += 32) s3[e] = to_f32(g3[e]);
  __syncwarp();

  // t[a, b, q] = sum_p c1[a, p] * c2[p, b, q], element e = (a*d2 + b)*r + q
  const int nt = p.d1 * d2 * r;
  for (int e = lane; e < nt; e += 32) {
    const int q = e % r, ab = e / r;
    const int b = ab % d2, a = ab / d2;
    float acc = 0.f;
    for (int k = 0; k < r; ++k)
      acc = fmaf(s1[a * r + k], s2[(k * d2 + b) * r + q], acc);
    st[e] = acc;
  }
  __syncwarp();

  // e[a, b, c] = sum_q t[a, b, q] * c3[q, c], element e = (a*d2 + b)*d3 + c
  const int dim = p.d1 * d2 * d3;
  T* o = out + (long long)row * dim;
  for (int e = lane; e < dim; e += 32) {
    const int c = e % d3, ab = e / d3;
    float acc = 0.f;
    for (int q = 0; q < r; ++q) acc = fmaf(st[ab * r + q], s3[q * d3 + c], acc);
    o[e] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* c0, const void* c1, const void* c2, const void* idx,
           void* out, int n_rows, const TtParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kWarps * tt_item_floats(p);
  cudaError_t err = robe_set_smem(tt_lookup_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + kWarps - 1) / kWarps;
  tt_lookup_kernel<T><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), static_cast<const int*>(idx),
      static_cast<T*>(out), n_rows, p);
  return (int)cudaGetLastError();
}

}  // namespace

// core0 [n1, d1, r], core1 [n2, r, d2, r], core2 [n3, r, d3] (dtype 0 = f32,
// 1 = bf16), idx [n_rows] int32 (n_rows = B*F, field = index % n_fields),
// per-field row offsets [n_fields], out [n_rows, d1*d2*d3] in the cores'
// dtype.  Returns cudaGetLastError() after the launch.
extern "C" int tt_lookup_launch(const void* core0, const void* core1,
                                const void* core2, const void* idx, void* out,
                                int n_rows, int dtype, const int* offsets,
                                int n_fields, int n2, int n3, int d1, int d2,
                                int d3, int rank, void* stream) {
  if (n_fields < 1 || n_fields > ROBE_MAX_FIELDS || n2 < 1 || n3 < 1 ||
      d1 < 1 || d2 < 1 || d3 < 1 || rank < 1)
    return (int)cudaErrorInvalidValue;
  TtParams p;
  p.n_fields = n_fields;
  p.n2 = n2;
  p.n3 = n3;
  p.d1 = d1;
  p.d2 = d2;
  p.d3 = d3;
  p.r = rank;
  for (int f = 0; f < n_fields; ++f) p.off[f] = offsets[f];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(core0, core1, core2, idx, out, n_rows, p, s);
    case 1:
      return launch<__nv_bfloat16>(core0, core1, core2, idx, out, n_rows, p,
                                   s);
    default: return (int)cudaErrorInvalidValue;
  }
}
