// One-pass serve kernel: ROBE hash and gather for every field, -1-padded
// bag pooling, and the dot-interaction triangle of [bot; pooled] -- the
// whole sparse half of a DLRM score, [B, F(, bag)] ids + bot [B, d] ->
// [B, (F+1)F/2] in bot's dtype.
//
// Replaces: src/repro/kernels/serve_fused.py, serve_fused_pallas (body
// _kernel).
//
// Bound on an H100: bytes.  A sample reads F*bag ids, d bot values and
// F*bag*d slots of M (26.1M f32 slots at full width, beyond the 50 MB L2),
// and writes (F+1)F/2 values; the gram is about 6 FLOP per byte read.
//
// Design: one block per sample, one warp per field.  Lanes walk the
// embedding's elements, hash each (bag entry, element) to its slot, gather
// with the sign and sum the bag in f32; -1 pads contribute nothing (the
// Pallas kernel hashes them as id 0 and zeroes them).  Each pooled value
// is rounded once to bot's dtype and kept, as f32, in shared memory rows
// 1..F beside bot in row 0 (14.3 KB at full width), so the [B, F, d]
// embeddings never reach device memory.  The block then computes the
// strict-lower gram triangle from shared memory in f32.  The Pallas kernel
// streams M through VMEM in chunks; here M stays in device memory and each
// slot is read where it is used, so there is no chunk size to depend on.
#include "robe_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename TM, typename TB>
__global__ void serve_fused_kernel(const TM* __restrict__ mem,
                                   const int* __restrict__ idx,
                                   const TB* __restrict__ bot,
                                   TB* __restrict__ out, int bag,
                                   const RobeParams p) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int f_all = p.n_fields, dim = p.dim, ld = gram_ld(dim);
  const long long b = blockIdx.x;
  for (int e = threadIdx.x; e < ld; e += blockDim.x)
    s[e] = e < dim ? to_f32(bot[b * dim + e]) : 0.f;
  const int* ib = idx + b * f_all * bag;
  const int lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int f = threadIdx.x >> 5; f < f_all; f += n_warps) {
    const unsigned int t = p.tids[f];
    float* row = s + (1 + f) * ld;
    for (int e = lane; e < ld; e += 32) {
      float acc = 0.f;
      if (e < dim) {
        for (int j = 0; j < bag; ++j) {
          const int x = ib[f * bag + j];
          if (x < 0) continue;
          const unsigned long long k =
              (unsigned long long)(unsigned int)x * (unsigned long long)dim +
              (unsigned long long)e;
          float v = to_f32(mem[robe_slot(p, t, k)]);
          if (p.use_sign) v *= robe_sign(p, t, k);
          acc += v;
        }
      }
      // the single rounding: pooled values enter the gram in bot's dtype
      row[e] = to_f32(from_f32<TB>(acc));
    }
  }
  __syncthreads();
  gram_tril<TB>(s, f_all + 1, dim, 0, out + b * gram_pairs(f_all + 1, 0));
}

template <typename TM, typename TB>
int launch(const void* mem, const void* idx, const void* bot, void* out,
           int batch, int bag, const RobeParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(p.n_fields + 1) * gram_ld(p.dim);
  cudaError_t err = robe_set_smem(serve_fused_kernel<TM, TB>, smem);
  if (err != cudaSuccess) return (int)err;
  serve_fused_kernel<TM, TB><<<batch, kThreads, smem, stream>>>(
      static_cast<const TM*>(mem), static_cast<const int*>(idx),
      static_cast<const TB*>(bot), static_cast<TB*>(out), bag, p);
  return (int)cudaGetLastError();
}

}  // namespace

// mem [|M|] (mem_dtype 0 = f32, 1 = bf16), idx [batch, n_fields, bag] int32
// (-1 = pad), bot [batch, dim] (bot_dtype 0 = f32, 1 = bf16) -> out
// [batch, (n_fields+1) n_fields / 2] in bot's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int serve_fused_launch(const void* mem, const void* idx,
                                  const void* bot, void* out, int batch,
                                  int bag, int mem_dtype, int bot_dtype,
                                  const unsigned long long* coeffs,
                                  const unsigned int* tids, int n_fields,
                                  int dim, int log2_z, int use_sign,
                                  void* stream) {
  RobeParams p;
  int err = robe_make_params(&p, coeffs, tids, n_fields, dim, log2_z,
                             use_sign);
  if (err) return err;
  if (mem_dtype < 0 || mem_dtype > 1 || bot_dtype < 0 || bot_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (mem_dtype * 2 + bot_dtype) {
    case 0: return launch<float, float>(mem, idx, bot, out, batch, bag, p, s);
    case 1: return launch<float, bf16>(mem, idx, bot, out, batch, bag, p, s);
    case 2: return launch<bf16, float>(mem, idx, bot, out, batch, bag, p, s);
    case 3: return launch<bf16, bf16>(mem, idx, bot, out, batch, bag, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
