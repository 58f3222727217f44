// The bucketed scatter-add of a ROBE lookup's cotangent into an f32
// workspace of |M| slots: every element's g[b, f, i] * sign(t_f, x, i) is
// added into the slot its forward read.  Only robe_lookup_bwd.cu (the
// gradient of M) includes it: qrobe_lookup_bwd.cu sorts its pairs by band
// with row_sort.cuh and walks them in registers instead.
// The design (count, scan, place, then a band-ordered scatter whose warps
// combine a window's duplicates before their atomics) is described in
// robe_lookup_bwd.cu.  Header only, as robe_common.cuh: each .cu that
// includes it compiles its own copy.
#pragma once

#include "robe_common.cuh"

namespace {


constexpr int kBandLog2 = 22;       // slots a band spans, log2 (16 MiB f32)
constexpr int kMaxBuckets = 4096;   // (band, field) buckets at most
constexpr int kSegLog2 = 5;         // a pair spans at most 32 elements
constexpr int kSortBlocks = 256;    // blocks of the count and place passes
constexpr int kSortThreads = 512;
constexpr int kScanThreads = 1024;
constexpr int kStagePairs = 2048;   // pairs a place tile orders on chip
constexpr int kWarps = 8;           // warps of a scatter block
constexpr unsigned kNone = 0xFFFFFFFFu;  // a pair the item does not have
constexpr unsigned kFull = 0xFFFFFFFFu;

// What the launcher derives from the shapes (kernels/robe_lookup.py's
// bwd_plan mirrors it).
struct BwdPlan {
  int lw;                    // pair width W = 2^lw
  int n_seg;                 // pairs an item can span
  int band_log2;
  int n_buckets;             // bands * fields
  int n_items;
  int sort_blocks;           // blocks of the count and place passes
  int sort_chunk;            // items each takes
  unsigned long long fm_items, fm_fields;  // fastmod constants
};

__host__ __device__ __forceinline__ size_t align256(size_t n) {
  return (n + 255) & ~(size_t)255;
}

// The scratch: every sort block's count of every bucket (bucket-major),
// scanned in place into its start there; the total; each pair's first slot
// (j-major: pair q = j * n_items + item); the sorted pairs.
struct Scratch {
  int* starts;
  int* total;
  unsigned* first;
  uint2* sorted;   // (q, first slot)
};

static inline size_t scratch_bytes(const BwdPlan& s) {
  const size_t pairs = (size_t)s.n_items * s.n_seg;
  return align256(4 * (size_t)s.n_buckets * s.sort_blocks) + 256 +
         align256(4 * pairs) + align256(8 * pairs);
}

static inline Scratch carve(void* base, const BwdPlan& s) {
  char* c = static_cast<char*>(base);
  const size_t nb = align256(4 * (size_t)s.n_buckets * s.sort_blocks);
  const size_t pairs = (size_t)s.n_items * s.n_seg;
  Scratch r;
  r.starts = reinterpret_cast<int*>(c);
  r.total = reinterpret_cast<int*>(c + nb);
  r.first = reinterpret_cast<unsigned*>(c + nb + 256);
  r.sorted = reinterpret_cast<uint2*>(c + nb + 256 + align256(4 * pairs));
  return r;
}

// n / d for a 32-bit n, from the fastmod constant of d (Lemire).
__device__ __forceinline__ unsigned fastdiv(unsigned n, unsigned long long fm,
                                            unsigned d) {
  return d == 1 ? n : (unsigned)__umul64hi(fm, (unsigned long long)n);
}

// The bucket of a pair of field f whose first slot is `slot`.
__device__ __forceinline__ int bucket_of(unsigned slot, int f, int n_fields,
                                         const BwdPlan& s) {
  return (int)(slot >> s.band_log2) * n_fields + f;
}

// Hash every pair of this block's items once: its first slot into `first`,
// and the block's count of each bucket into starts[bucket][block].
__global__ void __launch_bounds__(kSortThreads)
    rb_count_kernel(const int* __restrict__ rows, const RobeParams p,
                    const BwdPlan s, Scratch w) {
  extern __shared__ int hist[];
  for (int k = threadIdx.x; k < s.n_buckets; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const int nf = p.n_fields, zl = p.log2_z - s.lw;
  const unsigned zm = (1u << p.log2_z) - 1u;
  const int lo = blockIdx.x * s.sort_chunk;
  const int hi = min(lo + s.sort_chunk, s.n_items);
  for (int item = lo + threadIdx.x; item < hi; item += blockDim.x) {
    const int f = (int)robe_fastmod((unsigned)item, s.fm_fields, nf);
    const unsigned t = p.tids[f];
    const unsigned long long k0 =
        (unsigned long long)(unsigned)rows[item] * (unsigned)p.dim;
    const unsigned long long kend = k0 + p.dim;
    const unsigned long long seg0 = k0 >> s.lw;
    for (int j = 0; j < s.n_seg; ++j) {
      const unsigned long long seg = seg0 + j;
      unsigned slot = kNone;
      if ((seg << s.lw) < kend) {
        const unsigned hb = robe_uhash(p.h, t, seg >> zl);
        slot = robe_slot_in(p, hb, (unsigned)(seg << s.lw) & zm);
        atomicAdd(&hist[bucket_of(slot, f, nf, s)], 1);
      }
      w.first[(size_t)j * s.n_items + item] = slot;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < s.n_buckets; k += blockDim.x)
    w.starts[k * s.sort_blocks + blockIdx.x] = hist[k];
}

// Exclusive scan of a[0, n) into out[0, n) (which may be a) by one warp,
// each lane over a contiguous run; returns the sum to every lane.
__device__ __forceinline__ int warp_scan(const int* a, int* out, int n,
                                         int lane) {
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += a[k];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  int run = x - sum;
  for (int k = lo; k < hi; ++k) {
    const int c = a[k];
    out[k] = run;
    run += c;
  }
  return __shfl_sync(kFull, x, 31);
}

// starts[bucket][block]: the exclusive scan of the counts in that order,
// and the total, by one block: a warp scans each bucket's counts (all read
// at once, coalesced), one warp scans the buckets' totals, and each
// bucket's entries get its start.
__global__ void __launch_bounds__(kScanThreads)
    rb_scan_kernel(const BwdPlan s, Scratch w) {
  __shared__ int tot[kMaxBuckets];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kScanWarps = kScanThreads / 32;
  constexpr int kPer = kSortBlocks / 32;
  const int nb = s.sort_blocks;
  for (int k = warp; k < s.n_buckets; k += kScanWarps) {
    int* c = w.starts + (size_t)k * nb;
    int v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      v[i] = 32 * i + lane < nb ? c[32 * i + lane] : 0;
    int carry = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      int x = v[i];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (32 * i + lane < nb) c[32 * i + lane] = carry + x - v[i];
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) tot[k] = carry;
  }
  __syncthreads();
  if (warp == 0) {
    const int total = warp_scan(tot, tot, s.n_buckets, lane);
    if (lane == 0) *w.total = total;
  }
  __syncthreads();
  for (int k = warp; k < s.n_buckets; k += kScanWarps)
    for (int b = lane; b < nb; b += 32) w.starts[(size_t)k * nb + b] += tot[k];
}

// Write each pair of this block's items at the block's next place in its
// bucket, a tile of at most kStagePairs pairs at a time (kStagePairs /
// kSortThreads a thread, held in registers): the tile's pairs are counted
// and ordered by bucket in shared memory, then leave in runs of
// consecutive places (coalesced), not one 8-byte store at a time.
__global__ void __launch_bounds__(kSortThreads)
    rb_place_kernel(const BwdPlan s, int n_fields, Scratch w) {
  constexpr int kPer = kStagePairs / kSortThreads;
  extern __shared__ float4 smem4[];
  uint2* stage = reinterpret_cast<uint2*>(smem4);         // [kStagePairs]
  int* bk = reinterpret_cast<int*>(stage + kStagePairs);  // their buckets
  int* next = bk + kStagePairs;       // the block's next place a bucket
  int* cnt = next + s.n_buckets;      // the tile's count a bucket
  int* start = cnt + s.n_buckets;     // the tile's first stage place
  __shared__ int n_tile;
  const int nb = s.n_buckets, tid = threadIdx.x;
  for (int k = tid; k < nb; k += kSortThreads)
    next[k] = w.starts[(size_t)k * s.sort_blocks + blockIdx.x];
  const int lo = blockIdx.x * s.sort_chunk;
  const int hi = min(lo + s.sort_chunk, s.n_items);
  // a tile is `tile` items of n_seg pairs; this thread's pairs of a tile,
  // p = tid + k * kSortThreads = j * tile + u
  const int tile = kStagePairs / s.n_seg;
  int pj[kPer], pu[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int pp = tid + k * kSortThreads;
    pj[k] = pp / tile;
    pu[k] = pp - pj[k] * tile;
  }
  for (int t0 = lo; t0 < hi; t0 += tile) {
    for (int k = tid; k < nb; k += kSortThreads) cnt[k] = 0;
    __syncthreads();
    unsigned slot[kPer];
    int rank[kPer], bkt[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int item = t0 + pu[k];
      slot[k] = pj[k] < s.n_seg && item < hi
                    ? w.first[(size_t)pj[k] * s.n_items + item] : kNone;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (slot[k] != kNone) {
        const int f = (int)robe_fastmod((unsigned)(t0 + pu[k]), s.fm_fields,
                                        n_fields);
        bkt[k] = bucket_of(slot[k], f, n_fields, s);
        rank[k] = atomicAdd(&cnt[bkt[k]], 1);
      }
    __syncthreads();
    if (tid < 32) {
      const int n = warp_scan(cnt, start, nb, tid);
      if (tid == 0) n_tile = n;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (slot[k] != kNone) {
        const int at = start[bkt[k]] + rank[k];
        stage[at] = make_uint2(
            (unsigned)pj[k] * (unsigned)s.n_items + t0 + pu[k], slot[k]);
        bk[at] = bkt[k];
      }
    __syncthreads();
    for (int i = tid; i < n_tile; i += kSortThreads) {
      const int k = bk[i];
      w.sorted[next[k] + i - start[k]] = stage[i];
    }
    __syncthreads();
    for (int k = tid; k < nb; k += kSortThreads) next[k] += cnt[k];
  }
}

__device__ __forceinline__ float load_stream(const float* x) {
  return __ldcs(x);
}
__device__ __forceinline__ float load_stream(const __nv_bfloat16* x) {
  return __bfloat162float(__ldcs(x));
}

// A pair as the scatter decodes it: where its element for lane 0 sits in
// g (lane l's is gp + l), the lanes whose elements the item has, its first
// slot, its group's first lane; for the sign, its table id and segment.
template <typename T>
struct Pair {
  const T* gp;
  unsigned mask;
  unsigned slot0;
  unsigned long long seg;
  unsigned t;
  int leader;
};

// Walk the sorted pairs a window of 32 at a time, one window a warp.  Lane
// l decodes pair l into shared memory; then each pair is read by the
// whole warp from there (a broadcast), not by shuffles.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    rb_scatter_kernel(const T* __restrict__ g, const int* __restrict__ rows,
                      float* __restrict__ ws, long long stride_b,
                      long long stride_f, const RobeParams p,
                      const BwdPlan s, Scratch w) {
  __shared__ float sums[kWarps][32][33];
  __shared__ Pair<T> pairs[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float(*acc)[33] = sums[warp];
  Pair<T>* pw = pairs[warp];
  const int n_pairs = *w.total;
  const int width = 1 << s.lw, dim = p.dim, nf = p.n_fields;
  const unsigned m = p.h.m;
  const long long windows = ((long long)n_pairs + 31) >> 5;
  for (long long win = (long long)blockIdx.x * kWarps + warp; win < windows;
       win += (long long)gridDim.x * kWarps) {
    const int first = (int)(win << 5);
    const int n = min(32, n_pairs - first);
    unsigned long long key = ~0ULL - lane;   // distinct past the window
    Pair<T> d{};
    if (lane < n) {
      const uint2 rec = w.sorted[first + lane];
      const unsigned j = fastdiv(rec.x, s.fm_items, s.n_items);
      const unsigned item = rec.x - j * (unsigned)s.n_items;
      const unsigned b = fastdiv(item, s.fm_fields, nf);
      const int f = (int)(item - b * (unsigned)nf);
      const unsigned long long k0 =
          (unsigned long long)(unsigned)rows[item] * (unsigned)dim;
      d.seg = (k0 >> s.lw) + j;
      // element e = efirst + lane of the item; lanes [lo, hi) have one
      const int efirst = (int)((long long)(d.seg << s.lw) - (long long)k0);
      const int lo = efirst < 0 ? -efirst : 0;
      const int hi = min(width, dim - efirst);
      d.mask = (hi >= 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
      d.gp = g + ((long long)b * stride_b + (long long)f * stride_f + efirst);
      d.slot0 = rec.y;
      d.t = p.tids[f];
      key = ((unsigned long long)f << 56) | d.seg;
    }
    // the pairs of one (field, segment) share every slot and sign
    const unsigned grp = __match_any_sync(kFull, key);
    d.leader = __ffs(grp) - 1;
    const bool dup = __any_sync(kFull, grp != (1u << lane));
    const unsigned leaders =
        __ballot_sync(kFull, d.leader == lane && lane < n);
    pw[lane] = d;
    __syncwarp();
    // every load of the window before any atomic: lane l takes element l
    // of each pair
    float v[32];
#pragma unroll
    for (int q = 0; q < 32; ++q)
      v[q] = (pw[q].mask >> lane) & 1u ? load_stream(pw[q].gp + lane) : 0.f;
    if (dup) {   // sum each group's elements into its first pair's row
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q][lane] = v[q];
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int to = pw[q].leader;
        if (to != q) acc[to][lane] += v[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      if (!((leaders >> q) & 1u)) continue;
      float val = dup ? acc[q][lane] : v[q];
      if (p.use_sign) val *= robe_sign(p, pw[q].t, (pw[q].seg << s.lw) + lane);
      unsigned slot = pw[q].slot0 + lane;
      slot = slot >= m ? slot - m : slot;
      if (val != 0.f) atomicAdd(ws + slot, val);
    }
    __syncwarp();   // the window's pairs and sums are free again
  }
}

static inline BwdPlan make_plan(const RobeParams& p, int n_items) {
  BwdPlan s;
  s.lw = p.log2_z < kSegLog2 ? p.log2_z : kSegLog2;
  const int width = 1 << s.lw;
  s.n_seg = p.dim % width == 0 ? p.dim / width
            : width % p.dim == 0 ? 1 : ((p.dim - 1) >> s.lw) + 2;
  s.band_log2 = kBandLog2;
  while ((long long)(((p.h.m - 1) >> s.band_log2) + 1) * p.n_fields >
         kMaxBuckets)
    ++s.band_log2;
  s.n_buckets = (int)(((p.h.m - 1) >> s.band_log2) + 1) * p.n_fields;
  s.n_items = n_items;
  s.sort_blocks = (n_items + kSortThreads - 1) / kSortThreads;
  if (s.sort_blocks > kSortBlocks) s.sort_blocks = kSortBlocks;
  s.sort_chunk = (n_items + s.sort_blocks - 1) / s.sort_blocks;
  s.fm_items = robe_fastmod_const((unsigned)n_items);
  s.fm_fields = robe_fastmod_const((unsigned)p.n_fields);
  return s;
}

template <typename T>
int rb_launch(const void* g, const void* rows, float* ws, const BwdPlan& s,
           const Scratch& w, long long stride_b, long long stride_f,
           const RobeParams& p, cudaStream_t stream) {
  const int* r = static_cast<const int*>(rows);
  cudaError_t err;
  int grid = 0;
  const size_t hist = sizeof(int) * (size_t)s.n_buckets;
  rb_count_kernel<<<s.sort_blocks, kSortThreads, hist, stream>>>(r, p, s, w);
  rb_scan_kernel<<<1, kScanThreads, 0, stream>>>(s, w);
  const size_t place = (sizeof(uint2) + sizeof(int)) * kStagePairs + 3 * hist;
  if ((err = robe_set_smem(rb_place_kernel, place)) != cudaSuccess)
    return (int)err;
  rb_place_kernel<<<s.sort_blocks, kSortThreads, place, stream>>>(
      s, p.n_fields, w);
  // as many warps as the card holds; they read the pair count on the card
  const long long most = ((long long)s.n_items * s.n_seg + 32 * kWarps - 1) /
                         (32 * kWarps);
  if ((err = robe_resident_grid(rb_scatter_kernel<T>, 32 * kWarps, 0,
                                (int)most, &grid)) != cudaSuccess)
    return (int)err;
  rb_scatter_kernel<T><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(g), r, ws, stride_b, stride_f, p, s, w);
  return (int)cudaGetLastError();
}

// The scatter of n_rows = B*F rows of g (dtype 0 = f32, 1 = bf16; row
// (b, f) at element b*stride_b + f*stride_f, its elements contiguous;
// rows [n_rows] int32, field = index % n_fields) into ws [|M|] f32, zeroed
// by the caller, with `scratch` (scratch_bytes long, at least what
// kernels/robe_lookup.py's bwd_plan gives; need not be zeroed) for the
// bucketed pairs.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a scratch too small, more than 2^31 - 1 pairs,
// or an item of more than kStagePairs pairs.
static inline int robe_scatter(const void* g, const void* rows, float* ws,
                               void* scratch, long long scratch_bytes_,
                               int n_rows, int dtype, long long stride_b,
                               long long stride_f, const RobeParams& p,
                               cudaStream_t st) {
  if (n_rows < 1 || stride_b < 0 || stride_f < 0)
    return (int)cudaErrorInvalidValue;
  const BwdPlan s = make_plan(p, n_rows);
  if ((long long)n_rows * s.n_seg >= (1LL << 31) || s.n_seg > kStagePairs ||
      scratch_bytes_ < (long long)scratch_bytes(s))
    return (int)cudaErrorInvalidValue;
  const Scratch w = carve(scratch, s);
  switch (dtype) {
    case 0:
      return rb_launch<float>(g, rows, ws, s, w, stride_b, stride_f, p, st);
    case 1:
      return rb_launch<__nv_bfloat16>(g, rows, ws, s, w, stride_b, stride_f,
                                      p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
