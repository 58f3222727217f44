// DLRM dot interaction: [B, F, D] -> [B, F(F-1)/2] (or F(F+1)/2 with the
// diagonal), the lower triangle of each sample's gram matrix in
// np.tril_indices order, accumulated in f32 and stored in the input dtype.
//
// Replaces: src/repro/kernels/dot_interaction.py, dot_interaction_pallas
// (body _kernel).
//
// Bound on an H100: bytes.  At F=27, D=128 a sample reads 13.8 KB (f32) and
// writes 1.4 KB for 2*351*128 = 90 kFLOP, about 6 FLOP per byte, far below
// the card's f32 ratio of 67 TFLOP/s over 3.35 TB/s = 20.
//
// Design: one block per sample.  The [F, D] tile is read once, coalesced,
// into shared memory as f32 (13.8 KB at full width), each row zero-padded
// to a multiple of four and strided four floats further so that a warp's
// float4 reads of different rows fall in different banks.  Each thread then
// computes whole pairs (i, j) of the triangle from shared memory; the
// [B, F, F] gram never exists in device memory.  A block per sample needs
// no batch padding, so prime batches cost nothing extra.
#include "robe_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void dot_interaction_kernel(const T* __restrict__ feats,
                                       T* __restrict__ out, int n, int dim,
                                       int self) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int ld = gram_ld(dim);
  const T* x = feats + (long long)blockIdx.x * n * dim;
  for (int e = threadIdx.x; e < n * ld; e += blockDim.x) {
    const int row = e / ld, col = e - row * ld;
    s[e] = col < dim ? to_f32(x[row * dim + col]) : 0.f;
  }
  __syncthreads();
  gram_tril<T>(s, n, dim, self,
               out + (long long)blockIdx.x * gram_pairs(n, self));
}

template <typename T>
int launch(const void* feats, void* out, int batch, int n, int dim,
           int self, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)n * gram_ld(dim);
  cudaError_t err = robe_set_smem(dot_interaction_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dot_interaction_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<T*>(out), n, dim, self);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [batch, n, dim] (dtype 0 = f32, 1 = bf16) -> out [batch, n_pairs].
// Returns cudaGetLastError() after the launch.
extern "C" int dot_interaction_launch(const void* feats, void* out,
                                      int batch, int n, int dim, int dtype,
                                      int self, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(feats, out, batch, n, dim, self, s);
    case 1:
      return launch<__nv_bfloat16>(feats, out, batch, n, dim, self, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
