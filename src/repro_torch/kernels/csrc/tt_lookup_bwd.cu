// Backward of the tensor-train lookup of the ``tt`` substrate.  The forward
// gives e[a, b, c] = sum_{p, q} c1[a, p] c2[p, b, q] c3[q, c] for the item's
// core rows c1 = G1[i1] [d1, r], c2 = G2[i2] [r, d2, r], c3 = G3[i3]
// [r, d3]; its cotangent g [B, F, d1*d2*d3] gives, item by item,
//   t = c1.c2,  dc3 = t^T.g,  dt = g.c3^T,  dc1 = dt.c2^T,  dc2 = c1^T.dt
// and each core row's gradient sums its items', in f32, delivered in the
// cores' dtype.
//
// Replaces: src/repro/kernels/ops.py:322, _tt_bwd (the custom-VJP backward
// of tt_lookup, three XLA scatter-adds; the TPU kernel tt_lookup_pallas
// has no backward of its own).
//
// Bound on an H100: at full dlrm-criteo-tb width (factors 589^3, dims
// (2, 8, 8), rank 8) an item costs 5 x 1,024 multiply-adds, 17 GFLOP at
// B = 65,536 (0.26 ms at 67 TFLOP/s f32), and g is 872 MB (0.26 ms at
// 3.35 TB/s); core1's 512-float rows dominate the gradients' bytes.
//
// Design: combining by bucket (row_sort.cuh).  Each core has 589 rows at
// full width, and the zipf head sends 527,853 of a batch's 1.7M items to
// one row of core0 (125,603 to one of core1, 38,840 to one of core2), so
// the items are sorted by their row of one core, then walked, once for
// each core: the walk of core k computes, for each item, what that core's
// gradient needs -- core0: dt, then dc1; core1: dt, then dc2; core2: t,
// then dc3 -- and sums it into the warp's accumulator of the row while the
// key stays the same.
//  - A walk's warp takes kRsChunk = 128 consecutive sorted items.  Lane l
//    decodes item l of each window of 32 (key, the three core rows, its
//    row of g); then, item by item, the warp copies the item's row of g and
//    the two slices the core needs into its shared memory (as f32; g's
//    row is read through L1 instead where a block of kWalkWarps warps
//    would not hold it, so every shape the forward takes fits), forms
//    t or dt there, and adds its contribution into the accumulator, a row
//    of the core's gradient in shared memory of which each lane owns the
//    elements lane, lane + 32, ... .  The row goes to the f32 workspace by
//    one atomic an element when the key changes and at the end of the
//    chunk: a row receives at most ceil(items / 128) + 1 atomics an element
//    (4,125 for core0's hottest row at B = 65,536, counted by
//    tools/atomic_chains.py, against 527,862 terms uncombined).
//  - Every shape is a runtime int, so the backward takes every (dims,
//    rank) the forward takes, ranked instance or not; a block holds up to
//    kWalkWarps warps, fewer when a warp's shared memory is large.  An
//    element's indices come from multiply-based division (tt_quo), not a
//    divide per element.
//  - bf16 cores accumulate into the f32 workspaces and a last kernel rounds
//    each once into its output.
// A row of g may sit at any (batch, field) strides with its elements
// contiguous.  The f32 sums of a row come in no fixed order across chunks:
// results agree with the plain version within a bound scaled by the sum of
// the magnitudes a row receives, never bit for bit.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// torch.profiler): 8.0 ms at B = 65,536 on the zipf batch against the
// 0.26 ms bound, the walks of cores 1, 0 and 2 3.1, 2.4 and 1.8 and the
// sort passes 0.68; multiply-based index splits and core0's rotated dot
// took it from 12.6, staging the slices' loads ahead of their stores
// moved nothing.  What holds the walks is unmeasured.
#include "row_sort.cuh"

namespace {

constexpr int kWalkWarps = 8;   // warps of a block of a walk, at most

// A divisor below 2^16 and its constant m = ceil(2^32 / d): e / d is
// __umulhi(e, m) for every e below 2^16 (e * (m * d - 2^32) < 2^32).
struct TtDiv {
  unsigned d, m;
};

static inline TtDiv tt_div(int d) {
  return TtDiv{(unsigned)d, d == 1 ? 0u : 0xFFFFFFFFu / (unsigned)d + 1u};
}

// e / v.d and e % v.d for 0 <= e < 2^16.
__device__ __forceinline__ int tt_quo(int e, TtDiv v, int* rem) {
  const int q = v.d == 1 ? e : (int)__umulhi((unsigned)e, v.m);
  *rem = e - q * (int)v.d;
  return q;
}

struct TtBwdParams {
  int n_fields, batch;
  int n1, n2, n3, d1, d2, d3, r;
  TtDiv div_r, div_d2, div_d3;
  int stage_g;   // the item's row of g staged in shared memory, or read
                 // through L1 (dims too wide for kWalkWarps warps)
  long long stride_b, stride_f;
  int off[ROBE_MAX_FIELDS];
};

// The three core rows of an item: the mixed-radix split of g = id + off[f]
// over (n1, n2, n3), i3 fastest.
__device__ __forceinline__ void tt_rows(const int* idx, const TtBwdParams& p,
                                        int item, unsigned* i1, unsigned* i2,
                                        unsigned* i3) {
  const unsigned g = (unsigned)(idx[item] + p.off[item % p.n_fields]);
  const unsigned rest = g / (unsigned)p.n3;
  *i3 = g - rest * (unsigned)p.n3;
  *i1 = rest / (unsigned)p.n2;
  *i2 = rest - *i1 * (unsigned)p.n2;
}

// An item's row of core K.
template <int K>
struct TtKey {
  const int* idx;
  TtBwdParams p;
  __device__ __forceinline__ unsigned operator()(int item) const {
    unsigned i1, i2, i3;
    tt_rows(idx, p, item, &i1, &i2, &i3);
    return K == 0 ? i1 : K == 1 ? i2 : i3;
  }
};

// Floats of a row of core K's gradient.
__host__ __device__ __forceinline__ int tt_row_floats(const TtBwdParams& p,
                                                      int k) {
  return k == 0 ? p.d1 * p.r : k == 1 ? p.r * p.d2 * p.r : p.r * p.d3;
}

// Shared-memory floats of a warp: the item's row of g when staged, the
// three slices, t (or dt) and the accumulator (the largest row of the
// three).  Without g a warp holds no more than twice what an item of the
// forward's any-rank path holds, so every shape the forward takes fits.
__host__ __device__ __forceinline__ int tt_warp_floats(const TtBwdParams& p) {
  const int r0 = tt_row_floats(p, 0), r1 = tt_row_floats(p, 1),
            r2 = tt_row_floats(p, 2);
  const int row = r0 > r1 ? (r0 > r2 ? r0 : r2) : (r1 > r2 ? r1 : r2);
  return (p.stage_g ? p.d1 * p.d2 * p.d3 : 0) + p.d1 * p.r +
         p.r * p.d2 * p.r + p.r * p.d3 + p.d1 * p.d2 * p.r + row;
}

template <typename T>
__device__ __forceinline__ void tt_load(float* dst, const T* src, int n,
                                        int lane) {
  for (int e = lane; e < n; e += 32) dst[e] = to_f32(src[e]);
}

// The walk of the items sorted by their row of core K; kG: g's row staged
// in shared memory (p.stage_g).
template <typename T, int K, bool kG>
__global__ void tt_walk_kernel(const T* __restrict__ c0,
                               const T* __restrict__ c1,
                               const T* __restrict__ c2,
                               const T* __restrict__ g,
                               const int* __restrict__ idx,
                               float* __restrict__ ws,
                               const uint2* __restrict__ sorted, int n_items,
                               const TtBwdParams p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d1 = p.d1, d2 = p.d2, d3 = p.d3, r = p.r;
  const int dim = d1 * d2 * d3, n1c = d1 * r, n2c = r * d2 * r, n3c = r * d3;
  const int nt = d1 * d2 * r;
  float* sg = smem + warp * tt_warp_floats(p);   // g [d1, d2, d3] if kG
  float* s1 = sg + (kG ? dim : 0);               // c1 [d1, r]
  float* s2 = s1 + n1c;                          // c2 [r, d2, r]
  float* s3 = s2 + n2c;                          // c3 [r, d3]
  float* st = s3 + n3c;                          // t or dt [d1, d2, r]
  float* sa = st + nt;                           // the row's gradient
  const int row = tt_row_floats(p, K);
  const long long lo =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * kRsChunk;
  if (lo >= n_items) return;
  const int hi = (int)(lo + kRsChunk < n_items ? lo + kRsChunk : n_items);
  for (int e = lane; e < row; e += 32) sa[e] = 0.f;
  unsigned cur = kRsNone;
  auto flush = [&]() {
    if (cur == kRsNone) return;
    float* dst = ws + (long long)cur * row;
    for (int e = lane; e < row; e += 32) {
      if (sa[e] != 0.f) atomicAdd(dst + e, sa[e]);
      sa[e] = 0.f;
    }
  };
  for (int w0 = (int)lo; w0 < hi; w0 += 32) {
    const int n = min(32, hi - w0);
    unsigned key = kRsNone, i1 = 0, i2 = 0, i3 = 0;
    long long goff = 0;
    if (lane < n) {
      const uint2 rec = sorted[w0 + lane];
      const int item = (int)rec.x;
      const int b = item / p.n_fields, f = item - b * p.n_fields;
      tt_rows(idx, p, item, &i1, &i2, &i3);
      key = rec.y;
      goff = (long long)b * p.stride_b + (long long)f * p.stride_f;
    }
    for (int q = 0; q < n; ++q) {
      const unsigned kq = __shfl_sync(kRsFull, key, q);
      const unsigned a1 = __shfl_sync(kRsFull, i1, q);
      const unsigned a2 = __shfl_sync(kRsFull, i2, q);
      const unsigned a3 = __shfl_sync(kRsFull, i3, q);
      const long long gq = __shfl_sync(kRsFull, goff, q);
      if (kq != cur) {
        flush();
        cur = kq;
      }
      __syncwarp();   // the last item's reads of the stage are done
      const T* gi = g + gq;   // the item's row of g
      // element i of the item's row of g, from the stage or through L1
      auto gv = [&](int i) {
        if constexpr (kG) return sg[i];
        else return to_f32(__ldg(gi + i));
      };
      if (kG) tt_load(sg, gi, dim, lane);
      if (K != 0) tt_load(s1, c0 + (long long)a1 * n1c, n1c, lane);
      if (K != 1) tt_load(s2, c1 + (long long)a2 * n2c, n2c, lane);
      if (K != 2) tt_load(s3, c2 + (long long)a3 * n3c, n3c, lane);
      __syncwarp();
      // st[(a*d2 + b)*r + q']: t = c1.c2 for core2, dt = g.c3^T otherwise
      for (int e = lane; e < nt; e += 32) {
        int qq, b;
        const int ab = tt_quo(e, p.div_r, &qq);
        float acc = 0.f;
        if (K == 2) {
          const int a = tt_quo(ab, p.div_d2, &b);
          for (int pp = 0; pp < r; ++pp)
            acc = fmaf(s1[a * r + pp], s2[(pp * d2 + b) * r + qq], acc);
        } else {
          for (int c = 0; c < d3; ++c)
            acc = fmaf(gv(ab * d3 + c), s3[qq * d3 + c], acc);
        }
        st[e] = acc;
      }
      __syncwarp();
      for (int e = lane; e < row; e += 32) {
        float acc = sa[e];
        if (K == 0) {
          // dc1[a, p] = sum_{b, q} dt[a, b, q] c2[p, b, q]: a dot product
          // of two runs of d2*r, read from a lane-rotated start so that the
          // lanes' c2 rows fall on other banks, into four partial sums
          int pp;
          const int a = tt_quo(e, p.div_r, &pp);
          const int len = d2 * r;
          const float* x = st + a * len;
          const float* y = s2 + pp * len;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          int j = lane;
          while (j >= len) j -= len;
          for (int t = 0; t < len; ++t) {
            part[t & 3] = fmaf(x[j], y[j], part[t & 3]);
            if (++j == len) j = 0;
          }
          acc += (part[0] + part[1]) + (part[2] + part[3]);
        } else if (K == 1) {   // dc2[p, b, q] = sum_a c1[a, p] dt[a, b, q]
          int qq, b;
          const int pp = tt_quo(tt_quo(e, p.div_r, &qq), p.div_d2, &b);
          for (int a = 0; a < d1; ++a)
            acc = fmaf(s1[a * r + pp], st[(a * d2 + b) * r + qq], acc);
        } else {               // dc3[q, c] = sum_{a, b} t[a, b, q] g[a, b, c]
          int c;
          const int qq = tt_quo(e, p.div_d3, &c);
          for (int ab = 0; ab < d1 * d2; ++ab)
            acc = fmaf(st[ab * r + qq], gv(ab * d3 + c), acc);
        }
        sa[e] = acc;
      }
    }
  }
  flush();
}

template <typename T, int K>
int walk(const void* c0, const void* c1, const void* c2, const void* g,
         const int* idx, float* ws, const RowSort& w, int n_items,
         const TtBwdParams& p, int warps, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)warps * tt_warp_floats(p);
  auto kernel = p.stage_g ? tt_walk_kernel<T, K, true>
                          : tt_walk_kernel<T, K, false>;
  cudaError_t err = robe_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = ((long long)n_items + kRsChunk - 1) / kRsChunk;
  const long long blocks = (chunks + warps - 1) / warps;
  kernel<<<(int)blocks, 32 * warps, smem, st>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), static_cast<const T*>(g), idx, ws, w.sorted,
      n_items, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const void* c0, const void* c1, const void* c2,
           const int* idx, float* const ws[3], void* const out[3],
           const RowSort& w, int n_items, const TtBwdParams& p, int warps,
           cudaStream_t st) {
  const long long rows[3] = {p.n1, p.n2, p.n3};
  int err;
  if ((err = rs_sort(TtKey<0>{idx, p}, n_items, p.batch, p.n_fields,
                     rows[0], w, st)) ||
      (err = walk<T, 0>(c0, c1, c2, g, idx, ws[0], w, n_items, p, warps,
                        st)) ||
      (err = rs_sort(TtKey<1>{idx, p}, n_items, p.batch, p.n_fields,
                     rows[1], w, st)) ||
      (err = walk<T, 1>(c0, c1, c2, g, idx, ws[1], w, n_items, p, warps,
                        st)) ||
      (err = rs_sort(TtKey<2>{idx, p}, n_items, p.batch, p.n_fields,
                     rows[2], w, st)) ||
      (err = walk<T, 2>(c0, c1, c2, g, idx, ws[2], w, n_items, p, warps,
                        st)))
    return err;
  if (sizeof(T) == 4) return 0;
  for (int k = 0; k < 3; ++k)
    if ((err = rs_round(ws[k], out[k], rows[k] * tt_row_floats(p, k), st)))
      return err;
  return 0;
}

}  // namespace

// g: the lookup's cotangent, n_rows = B*F rows of d1*d2*d3 elements (dtype
// 0 = f32, 1 = bf16), row (b, f) at element b*stride_b + f*stride_f, its
// elements contiguous; core0 [n1, d1, r], core1 [n2, r, d2, r], core2
// [n3, r, d3] in g's dtype (any alignment); idx [n_rows] int32 ids (field =
// index % n_fields) with id + offsets[f] below n1*n2*n3; ws0, ws1, ws2 f32
// of the cores' shapes, zeroed by the caller, receive the gradients; for
// bf16, out0..2 then receive them rounded once (for f32 they are not
// read); scratch, scratch_bytes long (at least rs_scratch_bytes(max(n1,
// n2, n3), n_rows)), need not be zeroed.  Returns cudaGetLastError() after
// the launches, or cudaErrorInvalidValue for bad shapes, a warp's shared
// memory past the limit, or a scratch too small.
extern "C" int tt_lookup_bwd_launch(
    const void* g, const void* core0, const void* core1, const void* core2,
    const void* idx, void* ws0, void* ws1, void* ws2, void* out0, void* out1,
    void* out2, void* scratch, long long scratch_bytes_, int n_rows,
    int dtype, long long stride_b, long long stride_f, const int* offsets,
    int n_fields, int n1, int n2, int n3, int d1, int d2, int d3, int rank,
    void* stream) {
  if (n_fields < 1 || n_fields > ROBE_MAX_FIELDS || n1 < 1 || n2 < 1 ||
      n3 < 1 || d1 < 1 || d2 < 1 || d3 < 1 || rank < 1 || n_rows < 1 ||
      n_rows % n_fields || stride_b < 0 || stride_f < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_keys = n1 > n2 ? (n1 > n3 ? n1 : n3)
                                  : (n2 > n3 ? n2 : n3);
  if (scratch_bytes_ < (long long)rs_scratch_bytes(n_keys, n_rows))
    return (int)cudaErrorInvalidValue;
  TtBwdParams p;
  p.n_fields = n_fields;
  p.batch = n_rows / n_fields;
  p.n1 = n1;
  p.n2 = n2;
  p.n3 = n3;
  p.d1 = d1;
  p.d2 = d2;
  p.d3 = d3;
  p.r = rank;
  p.div_r = tt_div(rank);
  p.div_d2 = tt_div(d2);
  p.div_d3 = tt_div(d3);
  p.stride_b = stride_b;
  p.stride_f = stride_f;
  for (int f = 0; f < n_fields; ++f) p.off[f] = offsets[f];
  // g's row staged when kWalkWarps warps still fit (every config's shape),
  // else read through L1
  p.stage_g = 1;
  p.stage_g = (size_t)kWalkWarps * sizeof(float) * tt_warp_floats(p) <=
              kSmemLimit;
  const size_t per_warp = sizeof(float) * (size_t)tt_warp_floats(p);
  // a warp's stage stays below 2^16 floats, as tt_quo needs
  if (per_warp > kSmemLimit) return (int)cudaErrorInvalidValue;
  int warps = (int)(kSmemLimit / per_warp);
  if (warps > kWalkWarps) warps = kWalkWarps;
  const RowSort w = rs_carve(scratch, n_keys);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* const ws[3] = {static_cast<float*>(ws0), static_cast<float*>(ws1),
                        static_cast<float*>(ws2)};
  void* const out[3] = {out0, out1, out2};
  switch (dtype) {
    case 0:
      return launch<float>(g, core0, core1, core2, ix, ws, out, w, n_rows, p,
                           warps, st);
    case 1:
      return launch<__nv_bfloat16>(g, core0, core1, core2, ix, ws, out, w,
                                   n_rows, p, warps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
