// Backward of the int8 ROBE lookup of the ``qrobe`` substrate.  The
// forward gives out = from_f32(code[slot] * scale[slot >> G] * sign) (+
// delta[slot] * sign); its cotangent g [B, F, d] (in the scale's dtype)
// gives
//   gdelta[s] = sum over the elements that read slot s of g * sign   (f32)
//   gscale[k] = sum over the elements whose slot lies in group k of
//               g * sign * code[slot]                  (in scale's dtype)
// The int8 codes take no gradient.
//
// Replaces: src/repro/kernels/ops.py:120, _qrobe_bwd (the custom-VJP
// backward of qrobe_lookup, an XLA scatter-add into the scales), and the
// gradient JAX's autodiff gives the qrobe backend's delta term (the
// ``jnp.take(delta, ...)`` of src/repro/nn/embedding_backends/qrobe.py).
//
// Design: no atomics of the scales' own.  Since gdelta[s] sums g * sign over
// the elements of slot s, gscale[k] = sum over slots s of group k of
// code[s] * gdelta[s] holds exactly in real arithmetic.  So:
//  - robe_scatter (robe_scatter.cuh, the bucketed scatter of
//    robe_lookup_bwd) adds every element's g * sign into the f32 workspace,
//    which is delta's gradient as it stands.  Items that share a slot are
//    combined there: pairs are bucketed by band of M, and the warps of the
//    scatter sum the duplicates of a window of 32 pairs before one line of
//    atomics (chains shrink by up to 32x);
//  - qrobe_group_kernel then streams the |M| codes and the workspace once,
//    a warp per group of 2^G slots (eight slots a lane at G = 8), sums
//    code * gdelta in f32 and writes the group's gradient rounded once into
//    the scale's dtype.  A group never meets the ROBE blocks: the partial
//    last group (|M| mod 256 = 75 slots at full width), a group shorter than
//    Z and the wrap at |M| need nothing of their own.
// The f32 sums over a slot's and a group's terms come in no fixed order:
// results agree with the plain version within a bound scaled by the sum of
// |g| (and |g * code|) a slot (a group) receives, never bit for bit.
//
// Bound on an H100: bytes (g read once, delta's |M| f32 gradient written,
// the touched codes read).  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, torch.profiler): 0.95 ms at B = 65,536 on the zipf batch
// of the CTR stream against a 0.30 ms bound: the scatter 0.75, place
// 0.072, the group pass 0.047, count 0.032, zeroing 0.032, scan 0.013; at
// B = 512 0.117 against 0.034, most of it the zeroing and the group pass
// over all of |M|.  Its hottest slot receives 2,703 atomics, against
// 36,767 terms uncombined (counted by tools/atomic_chains.py).
#include "robe_scatter.cuh"

namespace {

constexpr int kGroupWarps = 8;   // warps of a block of the group pass

// gscale[k] = sum_{s in group k} code[s] * ws[s], one warp a group, rounded
// once into T.
template <typename T>
__global__ void __launch_bounds__(32 * kGroupWarps)
    qrobe_group_kernel(const signed char* __restrict__ codes,
                       const float* __restrict__ ws, T* __restrict__ gscale,
                       long long size, int group_log2, long long n_groups) {
  const int lane = threadIdx.x & 31;
  const long long gs = 1LL << group_log2;
  for (long long k = (long long)blockIdx.x * kGroupWarps + (threadIdx.x >> 5);
       k < n_groups; k += (long long)gridDim.x * kGroupWarps) {
    const long long lo = k * gs;
    const long long hi = lo + gs < size ? lo + gs : size;
    float acc = 0.f;
    for (long long s = lo + lane; s < hi; s += 32)
      acc = fmaf((float)codes[s], __ldcs(ws + s), acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    if (lane == 0) gscale[k] = from_f32<T>(acc);
  }
}

template <typename T>
int launch_groups(const void* codes, const float* ws, void* gscale,
                  long long size, int group_log2, long long n_groups,
                  cudaStream_t st) {
  const long long blocks = (n_groups + kGroupWarps - 1) / kGroupWarps;
  const int grid = (int)(blocks < 65535 * 8 ? blocks : 65535 * 8);
  qrobe_group_kernel<T><<<grid, 32 * kGroupWarps, 0, st>>>(
      static_cast<const signed char*>(codes), ws, static_cast<T*>(gscale),
      size, group_log2, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// g: the lookup's cotangent, n_rows = B*F rows of dim elements in the
// scale's dtype (0 = f32, 1 = bf16), row (b, f) at element b*stride_b +
// f*stride_f, its elements contiguous; rows [n_rows] int32 (field = index
// % n_fields); codes [|M|] int8; ws [|M|] f32, zeroed by the caller,
// receives delta's gradient; gscale [ceil(|M| / 2^group_log2)] in the
// scale's dtype receives the scales' gradient; scratch as for
// robe_lookup_bwd_launch.  Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for bad shapes or a scratch too small.
extern "C" int qrobe_lookup_bwd_launch(
    const void* g, const void* rows, const void* codes, void* ws,
    void* gscale, void* scratch, long long scratch_bytes_, int n_rows,
    int dtype, long long stride_b, long long stride_f,
    const unsigned long long* coeffs, const unsigned int* tids, int n_fields,
    int dim, int log2_z, int use_sign, int group_log2, void* stream) {
  RobeParams p;
  int err = robe_make_params(&p, coeffs, tids, n_fields, dim, log2_z,
                             use_sign);
  if (err) return err;
  if (group_log2 < 0 || group_log2 > 30) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f32 = static_cast<float*>(ws);
  err = robe_scatter(g, rows, f32, scratch, scratch_bytes_, n_rows, dtype,
                     stride_b, stride_f, p, st);
  if (err) return err;
  const long long size = p.h.m;
  const long long n_groups = ((size - 1) >> group_log2) + 1;
  switch (dtype) {
    case 0:
      return launch_groups<float>(codes, f32, gscale, size, group_log2,
                                  n_groups, st);
    case 1:
      return launch_groups<__nv_bfloat16>(codes, f32, gscale, size,
                                          group_log2, n_groups, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
