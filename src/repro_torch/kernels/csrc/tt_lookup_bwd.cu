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
// 3.35 TB/s); core1's 512-float rows dominate the gradients' bytes.  The
// zipf head sends 527,853 of a batch's 1.7M items to one row of core0
// (125,603 to one of core1, 38,840 to one of core2), so a row's items are
// summed before they reach its atomics.
//
// What held the first design back (three sorts by the row of each core,
// three walks, each item's contraction staged in shared memory one item a
// warp; 8.04 ms at B = 65,536 and 1.35 at B = 512 on an NVIDIA H100 80GB
// HBM3 at 700 W): split by tools/kernel_split.py, the contractions took
// 2.8 ms, the sorts 0.71, the atomics 0.06, and the rest, ~4.5 ms, was the
// walks staging g and the slices through shared memory one item at a time
// (each walk read g whole and re-fetched a 512-float core1 slice an item);
// at B = 512 the walks' 128-place chunks filled 13 of the 132 SMs.
//
// Design of the ranked walk (tt_ranked_bwd_kernel<T, R, kVec>, R = 4 and
// 8, d1 <= 2, d2 <= kTbLanes, r * d3 a multiple of 8 up to kTbMaxRow3:
// every shape of the repo's configs):
//  - One sort, by (i2, i3) (row_sort.cuh; 346,921 keys at full width).
//    Items that share i2 share the slice c2 and core1's gradient row, the
//    largest of the three; within an i2 run the items of one core2 row,
//    the zipf head's repeated rows above all, come together.
//  - One walk.  Lanes come in groups of kTbLanes = 8, one item a group at
//    a time, four items a warp; lane j of a group owns rows (0, j) and
//    (1, j) of the item, so c2[:, j, :] (R x R), its gradient's sum over
//    the run, t[., j, :] and dt[., j, :] stay in registers.  A group
//    takes a contiguous share of the sorted places (the grid is the
//    blocks the card holds at once, one an SM at ~240 registers a thread,
//    each place's group found by proportion, so a batch of 512 still
//    spreads over every SM), loads c2 once per run of equal i2, and sends
//    the run's dc2 by one atomic an element when i2 changes and at the end
//    of its share.
//  - Each item reads its row of g once in the whole backward (16-byte
//    loads where the shapes and pointers allow: kVec), its c1 and c3 rows
//    from L1 or L2, and forms t and dt once.  A group decodes eight places
//    at a time, one a lane, and asks L2 for their rows of g ahead of use.
//  - dc3 and dc1 are summed across the group's lanes by a butterfly of
//    shuffles (tb_red8: 7 shuffles for 8 values, each lane left with one
//    sum), then in registers while their row repeats: dc3's goes to
//    core2's gradient by one atomic an element when i3 changes; dc1's is
//    parked, when i1 changes, in the group's slot i1 % kTbSlots in shared
//    memory (a lane's own elements, so plain adds), a slot's other row
//    going into the block's copy of core0's gradient in shared memory
//    (37.7 KB at full width), which goes to the workspace once a block at
//    the end.  The zipf head's 527,853 items on one core0 row become at
//    most one atomic a block (sending evictions straight to the gradient
//    saved 0.07 ms but gave its hottest element 22,023 atomics).
//  - Shared-memory float atomics are compare-and-swap loops on this card
//    (ATOMS.CAST.SPIN): adding every item's dc1 and dc3 into block copies
//    of both gradients that way took 2.89 ms, 1.6 of them in those loops,
//    so only the slots' rare evictions take them.
// Measured (tools/kernel_split.py; NVIDIA H100 80GB HBM3, 700 W) at B =
// 65,536 / 512: 1.32 / 0.100 ms; contractions skipped 1.19, gradient
// atomics skipped 1.22, the sort 0.14 / 0.024.  Without the block copy of
// core0 1.25 ms, but a core0 element then takes one atomic a group.
// Other ranks and shapes take the first design, the three sorts and walks
// of tt_walk_kernel, with every shape a runtime int (an item's row of g
// staged in shared memory while a block of kWalkWarps warps holds it,
// else read through L1).  kernels/tt_lookup.py's bwd_plan mirrors the
// choice.
// A row of g may sit at any (batch, field) strides with its elements
// contiguous.  bf16 cores accumulate into the f32 workspaces and a last
// kernel rounds each once into its output.  The f32 sums of a row come in
// no fixed order: results agree with the plain version within a bound
// scaled by the sum of the magnitudes a row receives, never bit for bit.
#include "row_sort.cuh"

namespace {

constexpr int kWalkWarps = 8;   // warps of a block of a walk, at most
constexpr int kTbWarps = 8;     // warps of a block of the ranked walk
constexpr int kTbLanes = 8;     // lanes of one item of the ranked walk
constexpr int kTbGroups = 32 / kTbLanes;   // items a warp takes at once
constexpr int kTbRanks[] = {4, 8};         // ranks with a ranked walk

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

// The first design's walk of the items sorted by their row of core K, for
// the shapes no ranked instance takes: a warp takes kRsChunk consecutive
// places; lane l decodes item l of each window of 32; then, item by item,
// the warp copies the item's row of g (kG: staged, p.stage_g) and the two
// slices the core needs into its shared memory as f32, forms t (core2) or
// dt there, and adds its contribution into the accumulator, a row of the
// core's gradient in shared memory, sent by one atomic an element when the
// key changes and at the end of the chunk.
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

// ---------------------------------------------------------------------------
// the ranked walk: one sort by (i2, i3), one walk
// ---------------------------------------------------------------------------

constexpr int kTbMaxRow3 = 64;   // a core2 row of the ranked walk (r * d3)
constexpr long long kTbMaxKeys = 1LL << 24;   // its sort's keys, n2 * n3
constexpr int kTbSlots = 8;      // core0 rows a group keeps (<= kTbLanes)
constexpr int kTbMaxCopy = 16384;   // floats of a block's copy of core0's
                                    // gradient, at most

// Shared memory of a block of the ranked walk: its groups' slots of core0
// rows, and a copy of core0's whole gradient where it fits (priv).
static inline size_t tb_smem_bytes(const TtBwdParams& p, bool priv) {
  return sizeof(float) *
         ((size_t)kTbWarps * kTbGroups * kTbSlots * 2 * p.r +
          (priv ? (size_t)p.n1 * p.d1 * p.r : 0));
}

static inline bool tb_priv(const TtBwdParams& p) {
  return (long long)p.n1 * p.d1 * p.r <= kTbMaxCopy;
}

// The ranked walk's rank for these shapes, or 0: the first design's walks.
// A lane keeps its share of a core2 row's gradient, r * d3 / 8 sums, in
// registers, so r * d3 is a multiple of 8 up to kTbMaxRow3.
static inline int tb_instance(const TtBwdParams& p) {
  bool ranked = false;
  for (int r : kTbRanks) ranked |= p.r == r;
  const int row3 = p.r * p.d3;
  if (!ranked || p.d1 > 2 || p.d2 > kTbLanes || row3 > kTbMaxRow3 ||
      row3 % 8 || (long long)p.n2 * p.n3 > kTbMaxKeys)
    return 0;
  return p.r;
}

// The ranked walk's sort key, (i2, i3) with i3 fastest: an i2 run's items
// of one core2 row, the zipf head's repeated rows above all, come together.
struct TtKey23 {
  const int* idx;
  TtBwdParams p;
  __device__ __forceinline__ unsigned operator()(int item) const {
    unsigned i1, i2, i3;
    tt_rows(idx, p, item, &i1, &i2, &i3);
    return i2 * (unsigned)p.n3 + i3;
  }
};

// V consecutive elements as floats: one 16-byte (f32) or 8-byte (bf16)
// load for V = 4, which the caller has aligned.
template <int V>
__device__ __forceinline__ void tb_load(const float* s, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(s));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(s + k);
  }
}
template <int V>
__device__ __forceinline__ void tb_load(const __nv_bfloat16* s,
                                        float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(s));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_f32(__ldg(s + k));
  }
}

// S consecutive elements as floats, V at a time.
template <int S, int V, typename T>
__device__ __forceinline__ void tb_loads(const T* s, float (&v)[S]) {
#pragma unroll
  for (int k = 0; k < S; k += V) {
    float w[V];
    tb_load<V>(s + k, w);
#pragma unroll
    for (int i = 0; i < V; ++i) v[k + i] = w[i];
  }
}

// v summed over the kTbLanes = 8 lanes of an item: lane j of the eight
// gets the sum of v[j].  A butterfly that halves the values each round
// (4 + 2 + 1 shuffles): a lane keeps the half its bit selects and adds its
// partner's copy of that half.
__device__ __forceinline__ float tb_red8(const float (&v)[8], int j) {
  float w[4], x[2];
  bool up = j & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (up ? v[i + 4] : v[i]) +
           __shfl_xor_sync(kRsFull, up ? v[i] : v[i + 4], 4);
  up = j & 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = (up ? w[i + 2] : w[i]) +
           __shfl_xor_sync(kRsFull, up ? w[i] : w[i + 2], 2);
  up = j & 1;
  return (up ? x[1] : x[0]) + __shfl_xor_sync(kRsFull, up ? x[0] : x[1], 1);
}

// A block's copy of a gradient into the f32 workspace, one atomic a
// nonzero element.
__device__ __forceinline__ void tb_flush(float* __restrict__ dst,
                                         const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float v = src[e];
    if (v != 0.f) atomicAdd(dst + e, v);
  }
}

// t[a, j, q] = sum_p c1[a, p] c2[p, j, q] for a = 0 (x) and 1 (y).
template <int R>
__device__ __forceinline__ void tb_chain(const float (&x)[R],
                                         const float (&y)[R],
                                         const float (&c2)[R][R],
                                         float (&tx)[R], float (&ty)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    float u = 0.f, w = 0.f;
#pragma unroll
    for (int p = 0; p < R; ++p) {
      u = fmaf(x[p], c2[p][q], u);
      w = fmaf(y[p], c2[p][q], w);
    }
    tx[q] = u;
    ty[q] = w;
  }
}

// The lane's share of dc1[a, p] = sum_q dt[a, j, q] c2[p, j, q]: out[a * R
// + p] for a = 0 (x) and 1 (y).
template <int R>
__device__ __forceinline__ void tb_dc1(const float (&x)[R],
                                       const float (&y)[R],
                                       const float (&c2)[R][R],
                                       float (&out)[2 * R]) {
#pragma unroll
  for (int p = 0; p < R; ++p) {
    float u = 0.f, w = 0.f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      u = fmaf(x[q], c2[p][q], u);
      w = fmaf(y[q], c2[p][q], w);
    }
    out[p] = u;
    out[R + p] = w;
  }
}

// dc2[p, j, q] += c1[0, p] dt[0, j, q] + c1[1, p] dt[1, j, q].
template <int R>
__device__ __forceinline__ void tb_dc2(const float (&c1x)[R],
                                       const float (&c1y)[R],
                                       const float (&x)[R],
                                       const float (&y)[R],
                                       float (&dc2)[R][R]) {
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < R; ++q)
      dc2[p][q] = fmaf(c1x[p], x[q], fmaf(c1y[p], y[q], dc2[p][q]));
}

// The ranked walk over the items sorted by (i2, i3) (see the header):
// `groups` groups of kTbLanes lanes, group k taking the sorted places [k *
// n / groups, (k + 1) * n / groups).
template <typename T, int R, bool kVec>
__global__ void __launch_bounds__(32 * kTbWarps, 1)
    tt_ranked_bwd_kernel(const T* __restrict__ core0,
                         const T* __restrict__ core1,
                         const T* __restrict__ core2,
                         const T* __restrict__ g, const int* __restrict__ idx,
                         float* __restrict__ ws0, float* __restrict__ ws1,
                         float* __restrict__ ws2,
                         const uint2* __restrict__ sorted, int n_items,
                         long long groups, bool priv, const TtBwdParams p) {
  constexpr int V = kVec ? 4 : 1;       // columns a load takes
  constexpr int S = V > 8 / R ? V : 8 / R;   // columns of g a step takes
  constexpr int kPer = R * S / 8;       // dc3 sums a step leaves a lane
  constexpr int kSteps = kTbMaxRow3 / (R * S);   // steps of a row, at most
  constexpr int kSums3 = kTbMaxRow3 / 8;         // a lane's dc3 sums
  constexpr int kSums1 = 2 * R / 8;              // and dc1 sums
  extern __shared__ float smem[];
  const int d1 = p.d1, d2 = p.d2, d3 = p.d3;
  const int n0 = p.n1 * d1 * R;
  const int lane = threadIdx.x & 31, j = lane & (kTbLanes - 1);
  // the group's slots of core0 rows (slot s: dc1[x / R, x % R] at [s][x],
  // x = 8 t + j held by lane j), then the block's copy of core0's gradient
  float* slots = smem + ((threadIdx.x >> 5) * kTbGroups + lane / kTbLanes) *
                            kTbSlots * 2 * R;
  float* sm0 = smem + kTbWarps * kTbGroups * kTbSlots * 2 * R;
  if (priv) {
    for (int e = threadIdx.x; e < n0; e += blockDim.x) sm0[e] = 0.f;
    __syncthreads();
  }
  const int first = lane & ~(kTbLanes - 1);   // the group's lane 0
  const long long gid =
      ((long long)blockIdx.x * kTbWarps + (threadIdx.x >> 5)) * kTbGroups +
      lane / kTbLanes;
  const long long lo = gid * n_items / groups;
  const long long hi = (gid + 1) * n_items / groups;
  const int steps = (int)((n_items + groups - 1) / groups);  // most places
  const bool mine = j < d2;   // the lane owns rows (0, j) and (1, j)
  const bool two = d1 == 2;
  const int sums3 = R * d3 / 8;   // the lane's dc3 sums of this shape
  const long long row_g = (long long)d1 * d2 * d3 * sizeof(T);
  // c2[:, j, :] of core1's row cur2 and its gradient's sum, sent on when
  // the row changes; the lane's sums of core2's row cur3 (value x = 8 s +
  // j: dc3[x % R, x / R]), sent on when it changes; and of core0's row
  // cur1 (x = 8 s + j: dc1[x / R, x % R]), parked in the group's slot
  // cur1 % kTbSlots when it changes
  float c2r[R][R], dc2[R][R], acc3[kSums3], acc1[kSums1];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) c2r[a][b] = dc2[a][b] = 0.f;
#pragma unroll
  for (int x = 0; x < kSums3; ++x) acc3[x] = 0.f;
#pragma unroll
  for (int x = 0; x < kSums1; ++x) acc1[x] = 0.f;
  unsigned cur1 = kRsNone, cur2 = kRsNone, cur3 = kRsNone;
  unsigned tag = kRsNone;   // lane j: the core0 row the group's slot j holds
  // the run's dc2[:, j, :] into core1's gradient row cur2
  auto flush2 = [&]() {
    if (cur2 == kRsNone || !mine) return;
    float* dst = ws1 + ((long long)cur2 * R * d2 + j) * R;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float v = dc2[a][b];
        if (v != 0.f) atomicAdd(dst + a * d2 * R + b, v);
        dc2[a][b] = 0.f;
      }
  };
  // the lane's dc3 sums into core2's gradient row cur3
  auto flush3 = [&]() {
    if (cur3 == kRsNone) return;
    float* dst = ws2 + (long long)cur3 * R * d3;
#pragma unroll
    for (int s = 0; s < kSums3; ++s) {
      const int x = s * 8 + j;
      if (s < sums3 && acc3[s] != 0.f)
        atomicAdd(dst + (x % R) * d3 + x / R, acc3[s]);
      acc3[s] = 0.f;
    }
  };
  // a slot's sums (the lane's) into core0's row r: the block's copy where
  // it has one, else the gradient
  auto send1 = [&](unsigned r, const float* slot) {
    float* dst = ws0 + (long long)r * d1 * R;
#pragma unroll
    for (int s = 0; s < kSums1; ++s) {
      const int x = s * 8 + j;
      const float v = slot[x];
      if (x / R >= d1 || v == 0.f) continue;
      if (priv)
        atomicAdd(sm0 + (int)r * d1 * R + x, v);
      else
        atomicAdd(dst + x, v);
    }
  };
  // acc1 into slot cur1 % kTbSlots, which holds row `held`: added where
  // that is cur1, else that row's sums are sent on and acc1 takes the slot
  auto park1 = [&](unsigned held) {
    if (cur1 == kRsNone) return;
    const int sl = (int)(cur1 & (kTbSlots - 1));
    float* slot = slots + sl * 2 * R;
    const bool hit = held == cur1;
    if (!hit && held != kRsNone) send1(held, slot);
#pragma unroll
    for (int h = 0; h < kSums1; ++h)
      slot[h * 8 + j] = hit ? slot[h * 8 + j] + acc1[h] : acc1[h];
    if (j == sl) tag = cur1;
  };

  for (int k0 = 0; k0 < steps; k0 += kTbLanes) {
    // lane j decodes place lo + k0 + j and asks L2 for its row of g
    unsigned i1 = 0, i2 = kRsNone, i3 = 0;
    long long goff = 0;
    if (lo + k0 + j < hi) {
      const int item = (int)sorted[lo + k0 + j].x;
      const int b = item / p.n_fields, f = item - b * p.n_fields;
      tt_rows(idx, p, item, &i1, &i2, &i3);
      goff = (long long)b * p.stride_b + (long long)f * p.stride_f;
      const char* gp = reinterpret_cast<const char*>(g + goff);
      for (long long o = 0; o < row_g; o += 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(gp + o));
    }
    const int n = min(kTbLanes, steps - k0);   // the same in every group
    for (int u = 0; u < n; ++u) {
      const unsigned a1 = __shfl_sync(kRsFull, i1, first + u);
      const unsigned a2 = __shfl_sync(kRsFull, i2, first + u);
      const unsigned a3 = __shfl_sync(kRsFull, i3, first + u);
      const long long gq = __shfl_sync(kRsFull, goff, first + u);
      const bool on = a2 != kRsNone;
      if (on && a2 != cur2) {
        flush2();
        cur2 = a2;
        if (mine) {
          const T* src = core1 + ((long long)cur2 * R * d2 + j) * R;
#pragma unroll
          for (int a = 0; a < R; ++a) tb_loads<R, V>(src + a * d2 * R, c2r[a]);
        }
      }
      if (on && a3 != cur3) {
        flush3();
        cur3 = a3;
      }
      {   // the slot of the row cur1 leaves, looked up by every lane
        const unsigned held = __shfl_sync(
            kRsFull, tag, first + (int)(cur1 & (kTbSlots - 1)));
        if (on && a1 != cur1) {
          park1(held);
          cur1 = a1;
#pragma unroll
          for (int h = 0; h < kSums1; ++h) acc1[h] = 0.f;
        }
      }
      // t[a, j, :] = c1[a, :] . c2[:, j, :] for a = 0, 1
      float c1a[R], c1b[R], t0[R], t1[R];
#pragma unroll
      for (int a = 0; a < R; ++a) c1a[a] = c1b[a] = 0.f;
      if (on) {
        const T* src = core0 + (long long)a1 * d1 * R;
        tb_loads<R, V>(src, c1a);
        if (two) tb_loads<R, V>(src + R, c1b);
      }
      tb_chain<R>(c1a, c1b, c2r, t0, t1);
      // dt[a, j, q] = sum_c g[a, j, c] c3[q, c], and dc3[q, c] = sum over
      // the group of t[a, j, q] g[a, j, c], S columns a step
      float dt0[R], dt1[R];
#pragma unroll
      for (int q = 0; q < R; ++q) dt0[q] = dt1[q] = 0.f;
      const bool gl = on && mine;
      const T* g0 = g + gq + (long long)j * d3;   // row (0, j) of g
      const T* c3 = core2 + (long long)a3 * R * d3;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int c = st * S;
        if (c >= d3) break;
        float ga[S], gb[S];
#pragma unroll
        for (int k = 0; k < S; ++k) ga[k] = gb[k] = 0.f;
        if (gl) {
          tb_loads<S, V>(g0 + c, ga);
          if (two) tb_loads<S, V>(g0 + d2 * d3 + c, gb);
#pragma unroll
          for (int q = 0; q < R; ++q) {
            float cc[S];
            tb_loads<S, V>(c3 + q * d3 + c, cc);
#pragma unroll
            for (int k = 0; k < S; ++k) {
              dt0[q] = fmaf(ga[k], cc[k], dt0[q]);
              dt1[q] = fmaf(gb[k], cc[k], dt1[q]);
            }
          }
        }
        // R * S values, value x = k * R + q, eight to a butterfly
#pragma unroll
        for (int h = 0; h < kPer; ++h) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int x = h * 8 + i, q = x % R, k = x / R;
            v[i] = fmaf(t0[q], ga[k], t1[q] * gb[k]);
          }
          acc3[st * kPer + h] += tb_red8(v, j);
        }
      }
      // dc1[a, p] = sum over the group of dt[a, j, :] . c2[p, j, :]: 2R
      // values, value x = a * R + p, eight to a butterfly
      float d1v[2 * R];
      tb_dc1<R>(dt0, dt1, c2r, d1v);
#pragma unroll
      for (int h = 0; h < kSums1; ++h) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = d1v[h * 8 + i];
        acc1[h] += tb_red8(v, j);
      }
      tb_dc2<R>(c1a, c1b, dt0, dt1, dc2);
    }
  }
  flush2();
  flush3();
  park1(__shfl_sync(kRsFull, tag, first + (int)(cur1 & (kTbSlots - 1))));
  for (int sl = 0; sl < kTbSlots; ++sl) {
    const unsigned held = __shfl_sync(kRsFull, tag, first + sl);
    if (held != kRsNone) send1(held, slots + sl * 2 * R);
  }
  if (priv) {
    __syncthreads();
    tb_flush(ws0, sm0, n0);
  }
}

template <typename T, int R, bool kVec>
int launch_ranked(const void* g, const void* c0, const void* c1,
                  const void* c2, const int* idx, float* const ws[3],
                  const RowSort& w, int n_items, const TtBwdParams& p,
                  cudaStream_t st) {
  int err = rs_sort(TtKey23{idx, p}, n_items, p.batch, p.n_fields,
                    (long long)p.n2 * p.n3, w, st);
  if (err) return err;
  auto kernel = tt_ranked_bwd_kernel<T, R, kVec>;
  const bool priv = tb_priv(p);
  const size_t smem = tb_smem_bytes(p, priv);
  int grid = 0;
  cudaError_t e = robe_set_smem(kernel, smem);
  // no more blocks than give each group an item
  if (e == cudaSuccess)
    e = robe_resident_grid(kernel, 32 * kTbWarps, smem,
                           (n_items + 32 * kTbWarps / kTbLanes - 1) /
                               (32 * kTbWarps / kTbLanes),
                           &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 32 * kTbWarps, smem, st>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), static_cast<const T*>(g), idx, ws[0], ws[1],
      ws[2], w.sorted, n_items, (long long)grid * kTbWarps * kTbGroups, priv,
      p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ranked(const void* g, const void* c0, const void* c1,
                  const void* c2, const int* idx, float* const ws[3],
                  const RowSort& w, int n_items, const TtBwdParams& p,
                  bool vec, cudaStream_t st) {
  if (p.r == 4)
    return vec ? launch_ranked<T, 4, true>(g, c0, c1, c2, idx, ws, w,
                                           n_items, p, st)
               : launch_ranked<T, 4, false>(g, c0, c1, c2, idx, ws, w,
                                            n_items, p, st);
  return vec ? launch_ranked<T, 8, true>(g, c0, c1, c2, idx, ws, w, n_items,
                                         p, st)
             : launch_ranked<T, 8, false>(g, c0, c1, c2, idx, ws, w,
                                          n_items, p, st);
}

template <typename T>
int launch(const void* g, const void* c0, const void* c1, const void* c2,
           const int* idx, float* const ws[3], void* const out[3],
           const RowSort& w, int n_items, const TtBwdParams& p, int warps,
           bool vec, cudaStream_t st) {
  const long long rows[3] = {p.n1, p.n2, p.n3};
  int err;
  if (tb_instance(p)) {
    if ((err = launch_ranked<T>(g, c0, c1, c2, idx, ws, w, n_items, p, vec,
                                st)))
      return err;
  } else if ((err = rs_sort(TtKey<0>{idx, p}, n_items, p.batch,
                            p.n_fields, rows[0], w, st)) ||
             (err = walk<T, 0>(c0, c1, c2, g, idx, ws[0], w, n_items, p,
                               warps, st)) ||
             (err = rs_sort(TtKey<1>{idx, p}, n_items, p.batch,
                            p.n_fields, rows[1], w, st)) ||
             (err = walk<T, 1>(c0, c1, c2, g, idx, ws[1], w, n_items, p,
                               warps, st)) ||
             (err = rs_sort(TtKey<2>{idx, p}, n_items, p.batch,
                            p.n_fields, rows[2], w, st)) ||
             (err = walk<T, 2>(c0, c1, c2, g, idx, ws[2], w, n_items, p,
                               warps, st))) {
    return err;
  }
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
// n2, n3), n_rows), and rs_scratch_bytes(n2 * n3, n_rows) where the
// ranked walk is taken), need not be zeroed.  The ranked walk is taken where
// tb_instance allows it, with 16-byte loads where d3 and g's strides are
// multiples of 4 and g and the cores start on 4 elements.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for bad
// shapes, a warp of the first design's walks past the shared memory limit
// (as the walks always checked), or a scratch too small.
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
  // the sorts' keys: each core's rows, and (i2, i3) for the ranked walk
  long long n_keys = n1 > n2 ? (n1 > n3 ? n1 : n3) : (n2 > n3 ? n2 : n3);
  if (tb_instance(p) && (long long)n2 * n3 > n_keys)
    n_keys = (long long)n2 * n3;
  if (scratch_bytes_ < (long long)rs_scratch_bytes(n_keys, n_rows))
    return (int)cudaErrorInvalidValue;
  const RowSort w = rs_carve(scratch, n_keys);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* const ws[3] = {static_cast<float*>(ws0), static_cast<float*>(ws1),
                        static_cast<float*>(ws2)};
  void* const out[3] = {out0, out1, out2};
  const unsigned long long elem = dtype == 0 ? 4 : 2, al = 4 * elem;
  const bool vec = d3 % 4 == 0 && stride_b % 4 == 0 && stride_f % 4 == 0 &&
                   (uintptr_t)g % al == 0 && (uintptr_t)core0 % al == 0 &&
                   (uintptr_t)core1 % al == 0 && (uintptr_t)core2 % al == 0;
  switch (dtype) {
    case 0:
      return launch<float>(g, core0, core1, core2, ix, ws, out, w, n_rows, p,
                           warps, vec, st);
    case 1:
      return launch<__nv_bfloat16>(g, core0, core1, core2, ix, ws, out, w,
                                   n_rows, p, warps, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
