// Backward of the DLRM dot interaction: g [B, P], the cotangent of the gram
// triangle (P = F(F-1)/2, or F(F+1)/2 with the diagonal, in np.tril_indices
// order), and feats [B, F, D] -> dfeats [B, F, D] = sym(g) . feats per
// sample, where sym puts g_ij at (i, j) and (j, i) and, with the diagonal,
// 2 g_ii at (i, i).  Accumulated in f32 and rounded once into feats' dtype.
//
// Replaces: src/repro/kernels/ops.py, _dot_bwd (the custom-VJP backward of
// dot_interaction: a symmetric scatter of the triangle, then one
// contraction; the TPU kernel dot_interaction_pallas has no backward of
// its own).
//
// Bound on an H100: bytes.  At F=27, D=128 a sample reads 13.8 KB of feats
// and 1.4 KB of g and writes 13.8 KB for 2*27*27*128 = 187 kFLOP, about 6
// FLOP per byte, below the card's f32 ratio of 67 TFLOP/s over 3.35 TB/s.
//
// Design: blocks of kThreads threads walk the samples (blockIdx.x, +
// gridDim.x, ...; the grid is the blocks that fit on the card at once).
// Per sample the block builds sym in shared memory as f32, [F][Fp] with Fp
// the F rounded up to four and zeros past F (sym is symmetric, so row j
// holds column j), then stages feats a chunk of at most kChunk columns at
// a time, widened to f32.  A thread owns four output rows i0..i0+3 of one
// column d: per j it reads feats[j][d] (lanes on consecutive columns:
// conflict-free) and sym[j][i0..i0+3] as one float4 (the same address
// across the warp: a broadcast), for four FMAs.  Outputs leave as stores
// of consecutive columns across lanes.
#include "robe_common.cuh"

namespace {

constexpr int kThreads = 128;  // threads of a block
constexpr int kChunk = 128;    // columns of feats staged at once
constexpr int kRows = 4;       // output rows a thread accumulates

__host__ __device__ __forceinline__ int round_rows(int n) {
  return (n + kRows - 1) / kRows * kRows;
}

// Shared memory of a block: sym [n][round_rows(n)] and a chunk of feats.
static inline size_t smem_bytes(int n, int dim) {
  const int cw = dim < kChunk ? dim : kChunk;
  return sizeof(float) * (size_t)n * (round_rows(n) + cw);
}

// First pair of row i of the triangle: pair (i, j), j < i + self, is
// pairs(i, self) + j.
__device__ __forceinline__ int pairs(int i, int self) {
  return self ? i * (i + 1) / 2 : i * (i - 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dot_interaction_bwd_kernel(const T* __restrict__ g, long long g_stride,
                               const T* __restrict__ feats,
                               T* __restrict__ out, int batch, int n,
                               int dim, int self) {
  extern __shared__ float4 smem4[];
  const int np = round_rows(n);
  float* sym = reinterpret_cast<float*>(smem4);   // [n][np]
  float* fs = sym + n * np;                       // [n][cw]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = np / kRows;
  const long long tile = (long long)n * dim;
  for (int s = blockIdx.x; s < batch; s += gridDim.x) {
    const T* gs = g + s * g_stride;
    for (int e = tid; e < n * np; e += kThreads) {
      const int j = e / np, i = e - j * np;
      float v = 0.f;
      if (i < n) {
        if (i > j)
          v = to_f32(gs[pairs(i, self) + j]);
        else if (i < j)
          v = to_f32(gs[pairs(j, self) + i]);
        else if (self)
          v = 2.f * to_f32(gs[pairs(i, 1) + i]);
      }
      sym[e] = v;
    }
    const T* x = feats + s * tile;
    T* y = out + s * tile;
    for (int e0 = 0; e0 < dim; e0 += kChunk) {
      const int cw = min(kChunk, dim - e0);
      for (int r = warp; r < n; r += kThreads / 32)
        for (int c = lane; c < cw; c += 32)
          fs[r * cw + c] = to_f32(x[(long long)r * dim + e0 + c]);
      __syncthreads();  // sym and the chunk are in place
      for (int w = tid; w < groups * cw; w += kThreads) {
        const int rg = w / cw, d = w - rg * cw;
        float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
        const float* sj = sym + rg * kRows;
        for (int j = 0; j < n; ++j) {
          const float fj = fs[j * cw + d];
          const float4 sv = *reinterpret_cast<const float4*>(sj + j * np);
          acc[0] = fmaf(sv.x, fj, acc[0]);
          acc[1] = fmaf(sv.y, fj, acc[1]);
          acc[2] = fmaf(sv.z, fj, acc[2]);
          acc[3] = fmaf(sv.w, fj, acc[3]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = rg * kRows + r;
          if (i < n) y[(long long)i * dim + e0 + d] = from_f32<T>(acc[r]);
        }
      }
      __syncthreads();  // the chunk (and, last, sym) are free again
    }
  }
}

template <typename T>
int launch(const void* g, long long g_stride, const void* feats, void* out,
           int batch, int n, int dim, int self, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, dim);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = dot_interaction_bwd_kernel<T>;
  cudaError_t err = robe_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  if ((err = robe_resident_grid(kernel, kThreads, smem, batch, &grid)) !=
      cudaSuccess)
    return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), g_stride, static_cast<const T*>(feats),
      static_cast<T*>(out), batch, n, dim, self);
  return (int)cudaGetLastError();
}

}  // namespace

// g [batch, n_pairs] at row stride g_stride elements (dtype 0 = f32, 1 =
// bf16, as feats), feats [batch, n, dim] contiguous -> out [batch, n, dim]
// in feats' dtype.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when a block's shared memory would pass the card's.
extern "C" int dot_interaction_bwd_launch(const void* g, long long g_stride,
                                          const void* feats, void* out,
                                          int batch, int n, int dim,
                                          int dtype, int self,
                                          void* stream) {
  if (batch < 1 || n < 1 || dim < 1 || g_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(g, g_stride, feats, out, batch, n, dim, self, s);
    case 1:
      return launch<__nv_bfloat16>(g, g_stride, feats, out, batch, n, dim,
                                   self, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
