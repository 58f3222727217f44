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
// Design: one warp per block, walking samples blockIdx.x, + gridDim.x, ...;
// the launcher sizes the grid to the blocks that fit on the card at once
// (or to B, if smaller), so B=512 still spreads over every SM.  Each
// sample's [F, D] tile is copied into shared memory with cp.async, 16-byte
// copies when rows are whole float4s and 4-byte copies otherwise, straight
// into the padded rows of gram.cuh, with no division per element; then the
// register-tiled gram of gram.cuh.  bf16 tiles are widened to f32 as they
// land, through registers (cp.async cannot convert).  One row buffer per
// warp, 14 warps per SM at F=27, D=128 (15.3 KB of shared memory a warp,
// 96 registers a thread): other resident warps' grams hide a warp's copy;
// two buffers per warp (7 warps per SM), the next tile in flight behind
// the gram, were slower in trials on the card.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_split.py):
// 1.72 ms at B=262,144 against the 1.19 ms byte bound, of which the tile
// copies alone take 1.30 ms; the gram adds 0.41 ms.  What bounds it now is
// the copy, then the gram's shared-memory reads (the tiles read 32
// wavefronts per four columns for 28 tiles).
#include "gram.cuh"

namespace {

// Start copying one sample's [n, dim] tile into the rows at `rows`: the
// warp walks the tile in units of `u` floats (4 with `vec`, else 1),
// row-major, without a division per unit.
__device__ __forceinline__ void load_tile(float* rows, const float* x,
                                          const GramLayout& L, bool vec,
                                          int lane) {
  const int u = vec ? 4 : 1, per_row = L.dim / u, total = L.n * per_row;
  const int step_r = 32 / per_row, step_c = 32 - step_r * per_row;
  int r = lane / per_row, c = lane - r * per_row;
  for (int e = lane; e < total; e += 32) {
    float* dst = rows + gram_row(L.w4, r) + c * u;
    if (vec)
      cp_async16(dst, x + 4 * e);
    else
      cp_async4(dst, x + e);
    c += step_c;
    r += step_r;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

__device__ __forceinline__ void load_tile(float* rows,
                                          const __nv_bfloat16* x,
                                          const GramLayout& L, bool,
                                          int lane) {
  const int total = L.n * L.dim;
  const int step_r = 32 / L.dim, step_c = 32 - step_r * L.dim;
  int r = lane / L.dim, c = lane - r * L.dim;
  for (int e = lane; e < total; e += 32) {
    rows[gram_row(L.w4, r) + c] = to_f32(x[e]);
    c += step_c;
    r += step_r;
    if (c >= L.dim) {
      c -= L.dim;
      ++r;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32)
    dot_interaction_kernel(const T* __restrict__ feats, T* __restrict__ out,
                           int batch, const GramLayout L, int vec) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);
  T* stage = reinterpret_cast<T*>(rows + L.rows_floats);
  const int lane = threadIdx.x;
  // the padding (columns dim..4*w4) is zeroed once; copies never touch it
  for (int e = lane; e < L.rows_floats; e += 32) rows[e] = 0.f;
  __syncwarp();
  const long long tile = (long long)L.n * L.dim;
  const int n_pairs = gram_pairs(L.n, L.self);
  for (int s = blockIdx.x; s < batch; s += gridDim.x) {
    load_tile(rows, feats + s * tile, L, vec, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    gram_warp<T>(rows, L, stage, out + (long long)s * n_pairs, lane);
  }
}

template <typename T>
int launch(const void* feats, void* out, int batch, int n, int dim,
           int self, cudaStream_t stream) {
  GramLayout L = gram_layout(n, dim, self);
  const size_t rows = sizeof(float) * (size_t)L.rows_floats;
  if (!gram_fit_stage<T>(&L, rows)) return (int)cudaErrorInvalidValue;
  const size_t smem = rows + gram_stage_bytes<T>(L.stage);
  const int vec = sizeof(T) == 4 && dim % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  auto kernel = dot_interaction_kernel<T>;
  cudaError_t err = robe_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  if ((err = robe_resident_grid(kernel, 32, smem, batch, &grid)) !=
      cudaSuccess)
    return (int)err;
  kernel<<<grid, 32, smem, stream>>>(static_cast<const T*>(feats),
                                     static_cast<T*>(out), batch, L, vec);
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
