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
// What held the first design back (one warp per item, its three slices
// and t in shared memory; 9.18 ms at B=262,144 against a 1.05 ms bound on
// an NVIDIA H100 80GB HBM3 at 700 W) was instruction issue: runtime
// divisions per item and per element, two shared-memory loads per FMA,
// 4-byte copies and stores, and nothing of the next item in flight.
//
// Design of the ranked instances (tt_ranked_kernel<T, R>, R = 4 and 8):
//  - Blocks of kWarps warps; a lane holds a pair of rows (a, b) and
//    (a+1, b) of t, so a warp takes `items` = 32 / min(pairs, 32) items at
//    once (four at full width, 8 lanes each; pairs = d2 * ceil(d1 / 2)),
//    and walks the batch's steps blockIdx.x * kWarps + warp, + the grid's
//    warps, ... (the launcher sizes the grid to the blocks that fit).
//  - No division per item: g splits by multiply-based constants that the
//    launcher computes (tt_divmod), and a lane's role (its item slot and
//    first row pair) and its item's field are set once and stepped after.
//  - The three slices land in shared memory by cp.async, 16 bytes at a
//    time where the slice sizes allow (8 otherwise), kept in L1 too since
//    the cores are read again and again; two buffers, so the next step's
//    slices are in flight while this step computes.
//  - The chain is bound by shared-memory bandwidth, so each value read
//    feeds two FMAs: a lane keeps its two rows of t = c1 . c2 in registers
//    (f32, unrounded), each c2[p, b, :] read once as vectors for both, then
//    forms e[a(+1), b, c] = sum_q t[a(+1), b, q] c3[q, c], four columns
//    at a time when d3 % 4 == 0, in the order of the plain version.  In
//    f32 at rank 8 the rows of c2 are swizzled so that a quarter-warp's
//    reads hit eight bank groups.
//  - Each output is rounded once and stored from registers: 16-byte
//    streaming stores when d3 % 4 == 0 (every shape of the repo's configs
//    and tests whose dim is a multiple of four), lanes on consecutive
//    32-byte rows, so every sector of an item's output row is written by
//    one warp in two stores.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_split.py),
// at B=262,144: 2.93 ms; with plain stores 3.67; with every item reading
// row 0's slices (no split, gathers from L1) 2.33; gathers and one store
// per item 1.61 -- 16 GB of slices from L2 -- and stores alone 1.10.  The
// chain's shared-memory reads and the slices' L2 traffic are what is left.
// Any other rank, or cores that are not 16-byte aligned, take
// tt_any_kernel: one warp per item, the slices and t in shared memory, all
// shapes runtime ints.  The wrapper picks the instance from the shapes
// (kernels/tt_lookup.py, plan) and checks shared memory and g < 2^31.
#include <stdint.h>

#include "robe_common.cuh"

namespace {

constexpr int kWarps = 2;     // warps of a block of the ranked instances
constexpr int kAnyWarps = 8;  // warps of a block of the any-rank path
constexpr int kRanks[] = {4, 8};  // ranks with an instance of their own

struct TtParams {
  int n_fields;
  int n2, n3;
  int d1, d2, d3, r;
  int off[ROBE_MAX_FIELDS];
};

// ---------------------------------------------------------------------------
// any rank: one warp per item
// ---------------------------------------------------------------------------

// Shared-memory floats one (row, field) uses: the three core slices and t.
__host__ __device__ inline int tt_item_floats(const TtParams& p) {
  return p.d1 * p.r + p.r * p.d2 * p.r + p.r * p.d3 + p.d1 * p.d2 * p.r;
}

template <typename T>
__global__ void tt_any_kernel(const T* __restrict__ c0,
                              const T* __restrict__ c1,
                              const T* __restrict__ c2,
                              const int* __restrict__ idx,
                              T* __restrict__ out, int n_rows,
                              const TtParams p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kAnyWarps + warp;
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

// ---------------------------------------------------------------------------
// ranked instances
// ---------------------------------------------------------------------------

// What the launcher derives once from the shapes.
struct TtPlan {
  unsigned long long k2, k3;  // ceil(2^64 / n2), ceil(2^64 / n3) (mod 2^64)
  int pairs;             // row pairs of an item: d2 * ceil(d1 / 2)
  int lanes, items;      // lanes of one item, items a warp takes at once
  int da, db;            // a lane's step between its pairs (a by 2s, b)
  int b1, b2, b3;        // bytes of one slice of each core
  int o2, o3, slot;      // offsets of slices 2 and 3 in a slot; its bytes
  int ch1, ch2, ch3;     // cp.async bytes per copy, per core (16 or 8)
  int warp_bytes;        // shared memory of one warp
  int f_step;            // (warps of the grid * items) % n_fields
  long long steps;       // warp steps: ceil(n_rows / items)
};

// g / m and g % m for g < 2^32, from k = ceil(2^64 / m) mod 2^64: the
// quotient is the high half of k*g, the remainder robe_fastmod's ((k*g mod
// 2^64) * m) >> 64 (exact for every 32-bit g; m == 1 wraps k to 0, and
// gives g and 0).  kernels/tt_lookup.py, split_rows, is the same formula.
__device__ __forceinline__ unsigned int tt_divmod(unsigned int g,
                                                  unsigned long long k,
                                                  unsigned int m,
                                                  unsigned int* rem) {
  *rem = robe_fastmod(g, k, m);
  if (m == 1) return g;
  return (unsigned int)(((k >> 32) * g + __umulhi((unsigned int)k, g)) >>
                        32);
}

// Four consecutive elements of shared memory as floats (16 bytes of f32,
// 8 of bf16; aligned by the layout).
__device__ __forceinline__ void ld4(const float* s, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* s, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(s);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}
// Four floats rounded into four consecutive output elements, one
// streaming (evict-first) store: the output is written once and should
// not push the cores out of L2.
__device__ __forceinline__ void st4(float* d, const float* v) {
  __stcs(reinterpret_cast<float4*>(d), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void st4(__nv_bfloat16* d, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const unsigned int*>(&lo);
  x.y = *reinterpret_cast<const unsigned int*>(&hi);
  __stcs(reinterpret_cast<uint2*>(d), x);
}

// In f32 at rank 8 a row c2[p, b, :] is two 16-byte chunks, so the rows of
// eight consecutive b (the lanes of a quarter-warp) would fall on four
// bank groups; the copy swaps the two chunks of every row whose bit 2 is
// set, and the reads undo it, so they fall on eight.
template <typename T, int R>
constexpr bool kSwizzle = R * sizeof(T) == 32;

// cp.async of `bytes` bytes from src to dst by lanes jl, jl + lanes, ...,
// `ch` (16 or 8) bytes a copy; with kSwz, 16-byte chunk k lands at
// k ^ bit 3 of k.
template <bool kSwz = false>
__device__ __forceinline__ void tt_copy_slice(char* dst, const char* src,
                                              int bytes, int ch, int jl,
                                              int lanes) {
  if (ch == 16) {
    for (int o = jl * 16; o < bytes; o += lanes * 16)
      cp_async_ca<16>(dst + (kSwz ? o ^ ((o >> 3) & 16) : o), src + o);
  } else {
    for (int o = jl * 8; o < bytes; o += lanes * 8)
      cp_async_ca<8>(dst + o, src + o);
  }
}

// Start the copies of one item's three slices into its slot.
template <typename T, int R>
__device__ __forceinline__ void tt_copy(char* slot, const char* c0,
                                        const char* c1, const char* c2,
                                        unsigned int i1, unsigned int i2,
                                        unsigned int i3, const TtPlan& q,
                                        int jl) {
  tt_copy_slice(slot, c0 + (size_t)i1 * q.b1, q.b1, q.ch1, jl, q.lanes);
  tt_copy_slice<kSwizzle<T, R>>(slot + q.o2, c1 + (size_t)i2 * q.b2, q.b2,
                                q.ch2, jl, q.lanes);
  tt_copy_slice(slot + q.o3, c2 + (size_t)i3 * q.b3, q.b3, q.ch3, jl,
                q.lanes);
}

// Elements 4h .. 4h+3 of row rho of the c2 slice in shared memory.
template <typename T, int R>
__device__ __forceinline__ const T* tt_c2(const T* s2, int rho, int h) {
  if constexpr (kSwizzle<T, R>)
    return s2 + 4 * ((2 * rho + h) ^ ((rho >> 2) & 1));
  else
    return s2 + rho * R + 4 * h;
}

// A lane's row pairs of one item, from its landed slot, into the item's
// output row `o`: for rows (a, b) and (a+1, b) -- the second masked when
// d1 is odd -- t = c1[a(+1), :] . c2[:, b, :] in registers, each c2 value
// feeding both rows, then e[a(+1), b, :] = t . c3, rounded once and
// stored, 16 bytes at a time when d3 % 4 == 0.
template <typename T, int R>
__device__ __forceinline__ void tt_chain(const char* slot, T* o,
                                         const TtParams& p, const TtPlan& q,
                                         int jl, int a0, int b0) {
  const T* s1 = reinterpret_cast<const T*>(slot);
  const T* s2 = reinterpret_cast<const T*>(slot + q.o2);
  const T* s3 = reinterpret_cast<const T*>(slot + q.o3);
  const int d1 = p.d1, d2 = p.d2, d3 = p.d3;
  for (int pi = jl, a = a0, b = b0; pi < q.pairs; pi += q.lanes) {
    const bool two = a + 1 < d1;
    float c1r[2][R], t[2][R];
#pragma unroll
    for (int k = 0; k < R; k += 4) {
      ld4(s1 + a * R + k, c1r[0] + k);
      if (two) {
        ld4(s1 + (a + 1) * R + k, c1r[1] + k);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) c1r[1][k + i] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) t[0][k] = t[1][k] = 0.f;
#pragma unroll
    for (int pp = 0; pp < R; ++pp) {
      float c2r[R];
#pragma unroll
      for (int h = 0; h < R / 4; ++h)
        ld4(tt_c2<T, R>(s2, pp * d2 + b, h), c2r + 4 * h);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        t[0][k] = fmaf(c1r[0][pp], c2r[k], t[0][k]);
        t[1][k] = fmaf(c1r[1][pp], c2r[k], t[1][k]);
      }
    }
    T* o0 = o + (a * d2 + b) * d3;
    T* o1 = o0 + d2 * d3;
    if ((d3 & 3) == 0) {
      for (int c = 0; c < d3; c += 4) {
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int k = 0; k < R; ++k) {
          float c3v[4];
          ld4(s3 + k * d3 + c, c3v);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[0][i] = fmaf(t[0][k], c3v[i], acc[0][i]);
            acc[1][i] = fmaf(t[1][k], c3v[i], acc[1][i]);
          }
        }
        st4(o0 + c, acc[0]);
        if (two) st4(o1 + c, acc[1]);
      }
    } else {
      for (int c = 0; c < d3; ++c) {
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float v = to_f32(s3[k * d3 + c]);
          acc0 = fmaf(t[0][k], v, acc0);
          acc1 = fmaf(t[1][k], v, acc1);
        }
        o0[c] = from_f32<T>(acc0);
        if (two) o1[c] = from_f32<T>(acc1);
      }
    }
    b += q.db;
    a += q.da;
    if (b >= d2) {
      b -= d2;
      a += 2;
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(32 * kWarps)
    tt_ranked_kernel(const T* __restrict__ c0, const T* __restrict__ c1,
                     const T* __restrict__ c2, const int* __restrict__ idx,
                     T* __restrict__ out, int n_rows, const TtParams p,
                     const TtPlan q) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* bufs = reinterpret_cast<char*>(smem4) + warp * q.warp_bytes;
  const int dim = p.d1 * p.d2 * p.d3, n_fields = p.n_fields;
  // the lane's role, set once: item slot j, lane jl of it, first row pair
  // (a, b), b fastest
  const int j = lane / q.lanes, jl = lane - j * q.lanes;
  const bool active = j < q.items;
  const int a0 = 2 * (jl / p.d2), b0 = jl - (jl / p.d2) * p.d2;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long stride = warps * q.items;   // items between steps
  long long s = (long long)blockIdx.x * kWarps + warp;
  // the item of slot j this step, and of the step after (ids one further)
  long long item = s * q.items + j;
  int f = (int)((unsigned int)item % (unsigned int)n_fields);
  const char* cb0 = reinterpret_cast<const char*>(c0);
  const char* cb1 = reinterpret_cast<const char*>(c1);
  const char* cb2 = reinterpret_cast<const char*>(c2);

  // start the copies of a step's item `it` (field ff, id x) into buffer bb
  auto fetch = [&](long long it, int ff, int x, int bb) {
    if (active && it < n_rows) {
      const unsigned int g = (unsigned int)(x + p.off[ff]);
      unsigned int i1, i2, i3;
      const unsigned int rest = tt_divmod(g, q.k3, p.n3, &i3);
      i1 = tt_divmod(rest, q.k2, p.n2, &i2);
      tt_copy<T, R>(bufs + (bb * q.items + j) * q.slot, cb0, cb1, cb2, i1,
                    i2, i3, q, jl);
    }
    cp_async_commit();
  };
  auto step_field = [&](int ff) {
    ff += q.f_step;
    return ff >= n_fields ? ff - n_fields : ff;
  };

  if (s < q.steps) fetch(item, f, active && item < n_rows ? idx[item] : 0, 0);
  long long item1 = item + stride;
  int f1 = step_field(f);
  int x1 = active && item1 < n_rows ? idx[item1] : 0;
  for (int bb = 0; s < q.steps; s += warps, bb ^= 1) {
    fetch(item1, f1, x1, bb ^ 1);   // the next step's slices, in flight
    const long long item2 = item1 + stride;
    x1 = active && item2 < n_rows ? idx[item2] : 0;  // ids a step further
    cp_async_wait<1>();
    __syncwarp();
    if (active && item < n_rows)
      tt_chain<T, R>(bufs + (bb * q.items + j) * q.slot, out + item * dim,
                     p, q, jl, a0, b0);
    __syncwarp();  // buffer bb is free again
    item = item1;
    item1 = item2;
    f1 = step_field(f1);
  }
  cp_async_wait<0>();
}

template <typename T, int R>
int launch_ranked(const void* c0, const void* c1, const void* c2,
                  const void* idx, void* out, int n_rows, const TtParams& p,
                  cudaStream_t stream) {
  TtPlan q;
  const int isz = (int)sizeof(T);
  q.k2 = robe_fastmod_const(p.n2);
  q.k3 = robe_fastmod_const(p.n3);
  q.pairs = p.d2 * ((p.d1 + 1) / 2);
  q.lanes = q.pairs < 32 ? q.pairs : 32;
  q.items = 32 / q.lanes;
  q.db = q.lanes % p.d2;
  q.da = 2 * (q.lanes / p.d2);
  q.b1 = p.d1 * R * isz;
  q.b2 = R * p.d2 * R * isz;
  q.b3 = R * p.d3 * isz;
  q.o2 = (q.b1 + 15) & ~15;
  q.o3 = q.o2 + ((q.b2 + 15) & ~15);
  q.slot = q.o3 + ((q.b3 + 15) & ~15);
  const void* cores[3] = {c0, c1, c2};
  const int bytes[3] = {q.b1, q.b2, q.b3};
  int* chs[3] = {&q.ch1, &q.ch2, &q.ch3};
  // slices of R = 4 or 8 elements a row are multiples of 8 bytes, and the
  // wrapper sends only 16-byte aligned cores here
  for (int k = 0; k < 3; ++k) {
    const int low = bytes[k] | (int)(reinterpret_cast<uintptr_t>(cores[k]) &
                                     15);
    if (low & 7) return (int)cudaErrorInvalidValue;
    *chs[k] = low & 15 ? 8 : 16;
  }
  // the swizzled rows of c2 need whole 16-byte copies
  if (kSwizzle<T, R> && q.ch2 != 16) return (int)cudaErrorInvalidValue;
  q.warp_bytes = 2 * q.items * q.slot;
  const size_t smem = (size_t)kWarps * q.warp_bytes;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  q.steps = ((long long)n_rows + q.items - 1) / q.items;
  auto kernel = tt_ranked_kernel<T, R>;
  cudaError_t err = robe_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  const long long blocks = (q.steps + kWarps - 1) / kWarps;
  if ((err = robe_resident_grid(kernel, 32 * kWarps, smem, (int)blocks,
                                &grid)) != cudaSuccess)
    return (int)err;
  q.f_step = (int)(((long long)grid * kWarps * q.items) % p.n_fields);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), static_cast<const int*>(idx),
      static_cast<T*>(out), n_rows, p, q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* c0, const void* c1, const void* c2, const void* idx,
           void* out, int n_rows, const TtParams& p, int instance,
           cudaStream_t stream) {
  static_assert(sizeof(kRanks) == 2 * sizeof(int) && kRanks[0] == 4 &&
                    kRanks[1] == 8,
                "one ranked instance per entry of kRanks");
  if (instance == kRanks[0] && p.r == kRanks[0])
    return launch_ranked<T, kRanks[0]>(c0, c1, c2, idx, out, n_rows, p,
                                       stream);
  if (instance == kRanks[1] && p.r == kRanks[1])
    return launch_ranked<T, kRanks[1]>(c0, c1, c2, idx, out, n_rows, p,
                                       stream);
  if (instance != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kAnyWarps * tt_item_floats(p);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = robe_set_smem(tt_any_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + kAnyWarps - 1) / kAnyWarps;
  tt_any_kernel<T><<<grid, 32 * kAnyWarps, smem, stream>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), static_cast<const int*>(idx),
      static_cast<T*>(out), n_rows, p);
  return (int)cudaGetLastError();
}

}  // namespace

// core0 [n1, d1, r], core1 [n2, r, d2, r], core2 [n3, r, d3] (dtype 0 = f32,
// 1 = bf16), idx [n_rows] int32 (n_rows = B*F, field = index % n_fields),
// per-field row offsets [n_fields], out [n_rows, d1*d2*d3] in the cores'
// dtype.  `instance` is the rank of a ranked instance (4 or 8, equal to
// `rank`, cores 16-byte aligned) or 0 for the any-rank path; anything else
// is refused.  Returns cudaGetLastError() after the launch.
extern "C" int tt_lookup_launch(const void* core0, const void* core1,
                                const void* core2, const void* idx, void* out,
                                int n_rows, int dtype, const int* offsets,
                                int n_fields, int n2, int n3, int d1, int d2,
                                int d3, int rank, int instance,
                                void* stream) {
  if (n_fields < 1 || n_fields > ROBE_MAX_FIELDS || n2 < 1 || n3 < 1 ||
      d1 < 1 || d2 < 1 || d3 < 1 || rank < 1 || n_rows < 1)
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
    case 0:
      return launch<float>(core0, core1, core2, idx, out, n_rows, p,
                           instance, s);
    case 1:
      return launch<__nv_bfloat16>(core0, core1, core2, idx, out, n_rows, p,
                                   instance, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
