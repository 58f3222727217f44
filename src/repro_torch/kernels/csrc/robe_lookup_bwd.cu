// Backward of the ROBE lookup: the paper's Fig.-2 scatter-add.  Every
// element's cotangent g[b, f, i], times the element's ±1 sign, is added into
// the slot of M its forward read: gM[slot(t_f, x, i)] += g[b, f, i] *
// sign(t_f, x, i), accumulated in f32 and delivered in M's dtype.
//
// Replaces: src/repro/kernels/ops.py, _lookup_bwd (the custom-VJP backward
// of robe_lookup, an XLA scatter-add; the TPU kernel robe_lookup_pallas has
// no backward of its own).
//
// Bound on an H100: bytes.  Each element's cotangent is read once; the f32
// workspace of |M| slots is zeroed (by the wrapper) and each touched slot is
// read and written once by the atomics (8 bytes).  At full width M holds
// 26.1M f32 slots (104.5 MB), more than the 50 MB L2.
//
// Design: robe_lookup.cu's walk, with the gathers turned into atomics.
// Blocks of kWarps warps; each warp walks groups of kItems consecutive
// (row, field) items, blockIdx.x * kWarps + warp, + the grid's warps, ...
// (a persistent grid).  Per group and chunk of at most 128 elements of each
// row:
//  - the lanes hash, in one pass, every ROBE block the group's rows span
//    into a table in shared memory (robe_chunk_hash): one slot hash per
//    block, not per element, in every regime (Z < d, Z = d, Z > d, Z = 1);
//  - lanes take consecutive elements, so at Z >= 32 the 32 atomic adds of
//    one warp instruction hit one block's contiguous run of slots: the
//    paper's Table-1 coalescing, applied to the scatter.  Every load of g
//    of the group is issued before any atomic;
//  - each atomicAdd's result is unused, so it compiles to a reduction
//    (RED) that the L2 performs; no warp waits for it.
// A row of g may sit at any (batch, field) strides with its elements
// contiguous, so the cotangent that autograd hands over after the model's
// concat is read in place.  bf16 arrays accumulate into the f32 workspace
// and a second kernel rounds it once into the output.
//
// The f32 sum over a slot's aliased elements has no fixed order (the
// atomics land as they come): results agree with the plain version within
// a bound scaled by the sum of |g| a slot receives, never bit for bit.
#include "robe_common.cuh"

namespace {

constexpr int kWarps = 4;   // warps of a block
constexpr int kItems = 4;   // (row, field) items a warp takes at once

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    robe_lookup_bwd_kernel(const T* __restrict__ g,
                           const int* __restrict__ rows,
                           float* __restrict__ ws, int n_rows,
                           long long stride_b, long long stride_f,
                           const RobeParams p, const RobePlan q) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* base = reinterpret_cast<char*>(smem4) + warp * q.warp_bytes;
  unsigned int* table = reinterpret_cast<unsigned int*>(base);
  int* xs = reinterpret_cast<int*>(base + q.table);          // rows
  unsigned int* ts = reinterpret_cast<unsigned int*>(xs + kItems);  // tables
  long long* offs = reinterpret_cast<long long*>(base + q.warp_bytes) -
                    kItems;                                  // rows of g
  const int dim = p.dim, nblk = q.nblk, n_fields = p.n_fields;
  const long long warps = (long long)gridDim.x * kWarps;
  // the first (item, block) pair of each table pass: lane = u * nblk + m
  const int u0 = lane / nblk, m0 = lane - u0 * nblk;

  for (long long grp = (long long)blockIdx.x * kWarps + warp;
       grp < q.groups; grp += warps) {
    const long long first = grp * kItems;
    const int n_valid = (int)min((long long)kItems, n_rows - first);
    if (lane < n_valid) {
      const long long item = first + lane;
      const long long b = item / n_fields;
      const int f = (int)(item - b * n_fields);
      xs[lane] = rows[item];
      ts[lane] = p.tids[f];
      offs[lane] = b * stride_b + f * stride_f;
    }
    __syncwarp();
    for (int e0 = 0; e0 < dim; e0 += kRobeChunk) {
      const int cw = min(kRobeChunk, dim - e0);
      // one slot hash per block the group's rows span in this chunk
      for (int u = u0, m = m0; u < n_valid;) {
        table[u * nblk + m] = robe_chunk_hash(p, ts[u], xs[u], e0, m);
        u += q.pass_u;
        m += q.pass_m;
        if (m >= nblk) {
          m -= nblk;
          ++u;
        }
      }
      __syncwarp();
      // every load of the group's cotangents before any atomic
      float v[kItems][kRobeChunk / 32];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
#pragma unroll
        for (int i = 0; i < kRobeChunk / 32; ++i) {
          const int e = lane + 32 * i;
          v[u][i] = u < n_valid && e < cw ? to_f32(g[offs[u] + e0 + e])
                                          : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        if (u >= n_valid) break;
        const int x = xs[u];
        const unsigned long long k0 =
            (unsigned long long)(unsigned int)x * (unsigned)dim + e0;
#pragma unroll
        for (int i = 0; i < kRobeChunk / 32; ++i) {
          const int e = lane + 32 * i;
          if (e >= cw) break;
          float val = v[u][i];
          if (p.use_sign) val *= robe_sign(p, ts[u], k0 + e);
          atomicAdd(ws + robe_chunk_slot(p, table + u * nblk, x, e0, e),
                    val);
        }
      }
      __syncwarp();  // the table is free again
    }
    __syncwarp();    // xs, ts and offs are free again
  }
}

// out[s] = the f32 workspace rounded once into bf16.
__global__ void robe_round_kernel(const float* __restrict__ ws,
                                  __nv_bfloat16* __restrict__ out,
                                  long long n) {
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x)
    out[s] = __float2bfloat16(ws[s]);
}

template <typename T>
int launch(const void* g, const void* rows, float* ws, int n_rows,
           long long stride_b, long long stride_f, const RobeParams& p,
           cudaStream_t stream) {
  // no output stage: the shared memory of a warp is its table, its rows
  // and table ids, and the 8-byte offsets of its rows of g
  RobePlan q = robe_make_plan(p, n_rows, kItems, 0);
  q.warp_bytes += kItems * (int)sizeof(long long);
  const size_t smem = (size_t)kWarps * q.warp_bytes;
  auto kernel = robe_lookup_bwd_kernel<T>;
  int grid = 0;
  cudaError_t err = robe_plan_grid(kernel, kWarps, kItems, smem, p, &q,
                                   &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const int*>(rows), ws, n_rows,
      stride_b, stride_f, p, q);
  return (int)cudaGetLastError();
}

}  // namespace

// g: the lookup's cotangent, n_rows = B*F rows of dim elements (dtype 0 =
// f32, 1 = bf16), row (b, f) at element b*stride_b + f*stride_f, its
// elements contiguous; rows [n_rows] int32 (field = index % n_fields);
// ws [|M|] f32, zeroed by the caller, receives the scatter-add.  For bf16,
// out [|M|] bf16 then receives ws rounded once; for f32 the sum stays in ws
// and out is not read.
// Returns cudaGetLastError() after the launches.
extern "C" int robe_lookup_bwd_launch(const void* g, const void* rows,
                                      void* ws, void* out, int n_rows,
                                      int dtype, long long stride_b,
                                      long long stride_f,
                                      const unsigned long long* coeffs,
                                      const unsigned int* tids, int n_fields,
                                      int dim, int log2_z, int use_sign,
                                      void* stream) {
  RobeParams p;
  int err = robe_make_params(&p, coeffs, tids, n_fields, dim, log2_z,
                             use_sign);
  if (err) return err;
  if (n_rows < 1 || stride_b < 0 || stride_f < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  switch (dtype) {
    case 0:
      return launch<float>(g, rows, w, n_rows, stride_b, stride_f, p, s);
    case 1: {
      err = launch<__nv_bfloat16>(g, rows, w, n_rows, stride_b, stride_f, p,
                                  s);
      if (err) return err;
      const long long n = p.h.m;
      const int threads = 256;
      const long long blocks = (n + threads - 1) / threads;
      robe_round_kernel<<<(int)(blocks < 65535 * 8 ? blocks : 65535 * 8),
                          threads, 0, s>>>(
          w, static_cast<__nv_bfloat16*>(out), n);
      return (int)cudaGetLastError();
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
