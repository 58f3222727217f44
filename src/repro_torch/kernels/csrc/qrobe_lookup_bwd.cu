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
// Bound on an H100: bytes.  g is read once (872 MB in f32 at B = 65,536
// and full width); delta's |M| f32 gradient (104.5 MB) is zeroed by the
// wrapper, each touched slot read and written once by the atomics and its
// code read once.  The zipf head of a CTR batch sends tens of thousands of
// elements to each of a few slots: 1,703,936 items hold only 614,405
// distinct (field, row) pairs, so at most 78.6M of the 218M elements'
// atomics are needed.
//
// Design: the (item, segment) pairs are ordered by band of their first
// slot, a warp sums a band's pairs in registers, and one flush a run of a
// band gives both gradients.
//  - A pair is robe_lookup_bwd's: at most W = min(Z, 32) elements of one
//    item, aligned to W in the table's element index, so inside one ROBE
//    block; its slots are slot0 + lane, wrapped once at |M|.
//  - row_sort.cuh's pair sort (rs_seg_sort with QbKey) hashes every pair
//    and counts it into its band, band = slot0 >> kBandLog2 (32 slots; no
//    field in the key: whatever their field or row, the pairs of one band
//    update slots of one 64-slot window).  Warps walk the batch a field
//    column at a time, so a hot row's pairs meet in a warp and
//    __match_any_sync sends one atomic for all of them.  Its scan turns
//    the counts into each band's first place; its place pass hashes again
//    and writes each pair's index at its band's next place.  The bands
//    then lie in address order, a band's pairs in no particular order:
//    none is needed.
//  - qb_walk_kernel: a warp takes `chunk` consecutive places (256 at the
//    training batch), 32 at a time.  Each lane decodes one pair into
//    shared memory, with the 64 codes of its band's window; every lane
//    then loads its element of all 32 pairs (128 B a pair at W = 32,
//    streamed past the L2) before summing any.  Lane m keeps the band's
//    slots base + m and base + 32 + m in two registers; a pair at o =
//    slot0 - base adds lane l's value (times its sign) into slot o + l:
//    one shuffle.  When the band changes and at the chunk's end the window
//    is flushed: one line of REDs into delta's gradient for each half that
//    holds a value, and code * sum into the lane's share of the scale
//    group's gradient (a 32-aligned line lies in one group of 2^G >= 32
//    slots), which is summed over the warp and sent by one atomicAdd when
//    the group changes.  A line that wraps at |M|, or spans groups
//    narrower than 32 slots, takes a segmented warp sum instead.  So every
//    duplicate of a band in a chunk meets its twins before the atomics,
//    and a slot takes one RED a chunk that touches it.
//  - The bands come in address order, so the resident warps' REDs sweep M
//    in order and land in lines the L2 holds.
//  - gscale[k] = sum over slots s of group k of code[s] * gdelta[s] holds
//    because each flush adds the same sums to both; no pass over all of
//    |M| is left.  bf16 scales take their f32 sums from the scratch and
//    one rounding pass; f32 scales are summed in place.
// The f32 sums over a slot's and a group's terms come in no fixed order:
// results agree with the plain version within a bound scaled by the sum of
// |g| (and |g * code|) a slot (a group) receives, never bit for bit.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// tools/kernel_split.py, tools/atomic_chains.py): 0.87 ms at B = 65,536 on
// the zipf batch of the CTR stream (the first design, robe_lookup_bwd's
// scatter and a pass over all of |M|: 0.93), against a 0.30 ms bound: the
// walk 0.54, of which its atomics 0.07, the place pass 0.20, the count
// 0.09, the zeroing 0.037, the scan 0.01.  Delta's gradient takes 36.7M
// atomics (177M before), its hottest slot 146 (2,703); the scales' 132K.
// What is left is the walk's instructions and latency (a variant that
// reads g in address order instead saves it only 0.03 ms), and
// in the passes their atomics (about 0.10) and the place's scattered
// 4-byte writes (about 0.09).  At B = 512: 0.084 ms, the zeroing and the
// scan over the 816,739 bands the half of it.
#include "row_sort.cuh"

namespace {

constexpr int kBandLog2 = 5;     // slots a band of the order spans, log2
constexpr int kSegLog2 = 5;      // a pair spans at most 32 elements
constexpr int kWalkWarps = 4;    // warps of a block of the walk (its
                                 // shared memory: 7 KiB a warp)
constexpr int kMaxChunk = 256;   // sorted places a warp of the walk takes
constexpr int kMinChunk = 32;
constexpr int kWarpsPerSm = 16;  // the walk's chunks shrink to give each
                                 // SM this many warps at small batches

// What the launcher derives from the shapes (kernels/qrobe_lookup.py's
// bwd_plan mirrors the scratch it sizes).
struct QbPlan {
  int lw;                   // pair width W = 2^lw
  int n_seg;                // pairs an item can span
  int n_items;              // B * F
  int batch;                // B
  int n_bands;              // ceil(|M| / 2^kBandLog2)
  int n_groups;             // ceil(|M| / 2^group_log2)
  int group_log2;
  int chunk;                // sorted places a warp of the walk takes
  unsigned long long fm_items, fm_fields;  // fastmod constants
};

// The scratch: a count (then a cursor, then an end) a band, a sum a tile
// of the scan, each pair's index in band order, and the scales' f32 sums
// (used for bf16 scales).
struct QbScratch {
  int* cnt;
  int* tiles;
  unsigned* sorted;
  float* gsum;
};

static inline size_t qb_scratch_bytes(const QbPlan& s) {
  return rs_align(4 * (size_t)s.n_bands) +
         rs_align(4 * (size_t)rs_tiles(s.n_bands)) +
         rs_align(4 * (size_t)s.n_items * s.n_seg) +
         rs_align(4 * (size_t)s.n_groups);
}

static inline QbScratch qb_carve(void* base, const QbPlan& s) {
  char* c = static_cast<char*>(base);
  QbScratch w;
  w.cnt = reinterpret_cast<int*>(c);
  c += rs_align(4 * (size_t)s.n_bands);
  w.tiles = reinterpret_cast<int*>(c);
  c += rs_align(4 * (size_t)rs_tiles(s.n_bands));
  w.sorted = reinterpret_cast<unsigned*>(c);
  c += rs_align(4 * (size_t)s.n_items * s.n_seg);
  w.gsum = reinterpret_cast<float*>(c);
  return w;
}

// n / d for a 32-bit n, from the fastmod constant of d (Lemire).
__device__ __forceinline__ unsigned qb_fastdiv(unsigned n,
                                               unsigned long long fm,
                                               unsigned d) {
  return d == 1 ? n : (unsigned)__umul64hi(fm, (unsigned long long)n);
}

__device__ __forceinline__ float qb_load(const float* x) { return __ldcs(x); }
__device__ __forceinline__ float qb_load(const __nv_bfloat16* x) {
  return __bfloat162float(__ldcs(x));
}

// The key of a pair for row_sort.cuh's pair sort: the band of its first
// slot, band = slot0 >> kBandLog2 (no field in the key).
struct QbKey {
  const int* rows;
  RobeParams p;
  int lw;
  struct Item {
    unsigned long long k0;   // the item's first element index
    unsigned tid;
  };
  __device__ __forceinline__ Item item(int it, int f) const {
    return {(unsigned long long)(unsigned)__ldg(rows + it) *
                (unsigned)p.dim,
            p.tids[f]};
  }
  __device__ __forceinline__ unsigned seg(const Item& it, int j) const {
    const unsigned long long seg = (it.k0 >> lw) + j;
    if ((seg << lw) >= it.k0 + p.dim) return kRsNone;
    const unsigned hb = robe_uhash(p.h, it.tid, seg >> (p.log2_z - lw));
    return robe_slot_in(p, hb, (unsigned)(seg << lw) &
                                   ((1u << p.log2_z) - 1u)) >> kBandLog2;
  }
};

// A pair as the walk decodes it: where its element for lane 0 sits in g
// (lane l's is gp + l), the lanes whose elements the item has, its first
// slot; for the sign, its segment and table id.
template <typename T>
struct QPair {
  const T* gp;
  unsigned long long seg;
  unsigned mask, slot0, t;
};

// The 64 codes of the window of slot0's band (slots base .. base + 63,
// wrapped at |M|) into dst, 16 bytes a load where they lie in one aligned
// run.
__device__ __forceinline__ void qb_window_codes(
    const signed char* __restrict__ codes, unsigned slot0, unsigned m,
    signed char* dst) {
  const unsigned base = slot0 & ~((1u << kBandLog2) - 1u);
  if (base + 64 <= m && (reinterpret_cast<uintptr_t>(codes) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(codes + base);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      reinterpret_cast<uint4*>(dst)[k] = __ldg(src + k);
  } else {
    for (unsigned k = 0; k < 64; ++k) dst[k] = codes[(base + k) % m];
  }
}

// Add a lane's share x of group grp's gradient, summed over the warp,
// into the scales' f32 sums (grp is the same in every lane).
__device__ __forceinline__ void qb_emit(unsigned grp, float x,
                                        float* ws_scale, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kRsFull, x, o);
  if (lane == 0 && x != 0.f) atomicAdd(ws_scale + grp, x);
}

// The flush of a window whose lines may each span several scale groups
// (groups narrower than a line, or the wrap at |M|): each line's REDs,
// then code * sum reduced over each run of lanes of one group and sent by
// the run's first lane.  A lane that took a value holds a slot below 2|M|
// (slot0 < |M|, lane < W < |M|), so one wrap gives its slot; the others
// send nothing.  Rare, so not inlined.
__device__ __noinline__ void qb_flush_lines(unsigned base, float lo,
                                            float hi, unsigned m,
                                            int group_log2,
                                            const signed char* codes,
                                            float* ws, float* ws_scale,
                                            int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float a = h ? hi : lo;
    unsigned slot = base + 32 * h + lane;
    slot = slot >= m ? slot - m : slot;
    float x = 0.f;
    if (a != 0.f) {
      atomicAdd(ws + slot, a);
      x = a * (float)codes[slot];
    }
    const unsigned grp = slot >> group_log2;
    const unsigned prev = __shfl_up_sync(kRsFull, grp, 1);
    const bool head = lane == 0 || prev != grp;
    const unsigned heads = __ballot_sync(kRsFull, head);
    const unsigned later = heads & ~((2u << lane) - 1u);
    const int end = later ? __ffs(later) - 1 : 32;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(kRsFull, x, o);
      if (lane + o < end) x += y;
    }
    if (head && x != 0.f) atomicAdd(ws_scale + grp, x);
  }
}

// Send a band's window (lane m: slots base + m and base + 32 + m, sums lo
// and hi, codes c_lo and c_hi) into delta's gradient `ws`, one line of
// REDs a line.  Each line is 32-aligned, so with groups of 32 slots or
// more and no wrap it lies in one group: its code * sum goes into the
// lane's running share `sacc` of group `cur` (the bands of a chunk ascend,
// so a group's flushes follow one another), which is summed over the warp
// and sent once when the group changes.  Other windows take
// qb_flush_lines (every window through it: 0.99 ms against 0.87 at B =
// 65,536 on an H100, its codes gathered and a scale atomic a line).
__device__ __forceinline__ void qb_flush(unsigned band, float lo, float hi,
                                         float c_lo, float c_hi,
                                         unsigned& cur, float& sacc,
                                         unsigned m, int group_log2,
                                         const signed char* codes,
                                         float* ws, float* ws_scale,
                                         int lane) {
  const unsigned base = band << kBandLog2;
  if (group_log2 < kBandLog2 || base + 64 > m) {
    qb_flush_lines(base, lo, hi, m, group_log2, codes, ws, ws_scale, lane);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float a = h ? hi : lo;
    const unsigned slot = base + 32 * h + lane;
    if (a != 0.f) atomicAdd(ws + slot, a);
    const float x = a * (h ? c_hi : c_lo);
    const unsigned grp = (base + 32 * h) >> group_log2;
    if (grp != cur) {
      if (cur != kRsNone) qb_emit(cur, sacc, ws_scale, lane);
      cur = grp;
      sacc = 0.f;
    }
    sacc += x;
  }
}

// Walk the sorted pairs, a chunk a warp, 32 at a time: lane l decodes
// pair l into shared memory, every pair is then read by the whole warp
// from there (a broadcast), its 32 elements loaded before any is summed.
// The loads land in shared memory (lane l's column of the warp's 32 x 32
// values), so that the loop that sums them is not unrolled in full: few
// copies of the flush, and an instruction stream that stays in cache.
// The decoding lane also fetches its band window's 64 codes, so that a
// flush finds its codes in registers, read when its band began.
template <typename T, bool kSign>
__global__ void __launch_bounds__(32 * kWalkWarps)
    qb_walk_kernel(const T* __restrict__ g, const int* __restrict__ rows,
                   const signed char* __restrict__ codes,
                   float* __restrict__ ws, float* __restrict__ ws_scale,
                   long long stride_b, long long stride_f, const RobeParams p,
                   const QbPlan s, QbScratch w) {
  __shared__ QPair<T> pairs[kWalkWarps][32];
  __shared__ float vals[kWalkWarps][32][32];
  __shared__ __align__(16) signed char wcodes[kWalkWarps][32][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  QPair<T>* pw = pairs[warp];
  float(*sv)[32] = vals[warp];
  signed char(*pc)[64] = wcodes[warp];
  const int total = w.cnt[s.n_bands - 1];   // the last band's end
  const long long lo =
      ((long long)blockIdx.x * kWalkWarps + warp) * s.chunk;
  if (lo >= total) return;
  const int hi = (int)(lo + s.chunk < total ? lo + s.chunk : total);
  const int width = 1 << s.lw, zl = p.log2_z - s.lw, nf = p.n_fields;
  const unsigned zm = (1u << p.log2_z) - 1u, m = p.h.m;
  unsigned band = kRsNone, cur = kRsNone;
  float acc_lo = 0.f, acc_hi = 0.f, sacc = 0.f, c_lo = 0.f, c_hi = 0.f;
  for (int first = (int)lo; first < hi; first += 32) {
    const int n = min(32, hi - first);
    QPair<T> d{};
    if (lane < n) {
      const unsigned q = w.sorted[first + lane];
      const unsigned j = qb_fastdiv(q, s.fm_items, s.n_items);
      const unsigned item = q - j * (unsigned)s.n_items;
      const unsigned b = qb_fastdiv(item, s.fm_fields, nf);
      const int f = (int)(item - b * (unsigned)nf);
      const unsigned long long k0 =
          (unsigned long long)(unsigned)rows[item] * (unsigned)p.dim;
      d.seg = (k0 >> s.lw) + j;
      // element e = efirst + lane of the item; lanes [e_lo, e_hi) have one
      const int efirst = (int)((long long)(d.seg << s.lw) - (long long)k0);
      const int e_lo = efirst < 0 ? -efirst : 0;
      const int e_hi = min(width, p.dim - efirst);
      d.mask = (e_hi >= 32 ? ~0u : (1u << e_hi) - 1u) & ~((1u << e_lo) - 1u);
      d.gp = g + ((long long)b * stride_b + (long long)f * stride_f + efirst);
      d.t = p.tids[f];
      d.slot0 = robe_slot_in(p, robe_uhash(p.h, d.t, d.seg >> zl),
                             (unsigned)(d.seg << s.lw) & zm);
      qb_window_codes(codes, d.slot0, m, pc[lane]);
    }
    pw[lane] = d;
    __syncwarp();
    {
      float v[32];   // every load issued before the first store
#pragma unroll
      for (int i = 0; i < 32; ++i)
        v[i] = (pw[i].mask >> lane) & 1u ? qb_load(pw[i].gp + lane) : 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) sv[i][lane] = v[i];
    }
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const unsigned s0 = pw[i].slot0;
      if ((s0 >> kBandLog2) != band) {
        if (band != kRsNone)
          qb_flush(band, acc_lo, acc_hi, c_lo, c_hi, cur, sacc, m,
                   s.group_log2, codes, ws, ws_scale, lane);
        band = s0 >> kBandLog2;
        acc_lo = acc_hi = 0.f;
        c_lo = (float)pc[i][lane];
        c_hi = (float)pc[i][32 + lane];
      }
      float x = sv[i][lane];
      if (kSign) x *= robe_sign(p, pw[i].t, (pw[i].seg << s.lw) + lane);
      const int o = (int)(s0 & ((1u << kBandLog2) - 1u));
      const float y = __shfl_sync(kRsFull, x, (lane - o) & 31);
      if (lane >= o) acc_lo += y; else acc_hi += y;
    }
    __syncwarp();   // the window's pairs are free again
  }
  qb_flush(band, acc_lo, acc_hi, c_lo, c_hi, cur, sacc, m, s.group_log2,
           codes, ws, ws_scale, lane);
  if (cur != kRsNone) qb_emit(cur, sacc, ws_scale, lane);
}

static inline QbPlan qb_make_plan(const RobeParams& p, int n_items,
                                  int group_log2) {
  QbPlan s;
  s.lw = p.log2_z < kSegLog2 ? p.log2_z : kSegLog2;
  const int width = 1 << s.lw;
  s.n_seg = p.dim % width == 0 ? p.dim / width
            : width % p.dim == 0 ? 1 : ((p.dim - 1) >> s.lw) + 2;
  s.n_items = n_items;
  s.batch = n_items / p.n_fields;
  s.n_bands = (int)(((p.h.m - 1) >> kBandLog2) + 1);
  s.n_groups = (int)(((p.h.m - 1) >> group_log2) + 1);
  s.group_log2 = group_log2;
  s.chunk = kMaxChunk;
  s.fm_items = robe_fastmod_const((unsigned)n_items);
  s.fm_fields = robe_fastmod_const((unsigned)p.n_fields);
  return s;
}

// The walk's chunk: kMaxChunk, halved (down to kMinChunk) while the
// pairs would give the card fewer than kWarpsPerSm warps an SM.
static inline cudaError_t qb_chunk(long long n_pairs, int* chunk) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  int c = kMaxChunk;
  while (c > kMinChunk && (n_pairs + c - 1) / c < (long long)sms * kWarpsPerSm)
    c >>= 1;
  *chunk = c;
  return cudaSuccess;
}

template <typename T, bool kSign>
int qb_launch_walk(const void* g, const int* rows, const void* codes,
                   float* ws, float* ws_scale, long long stride_b,
                   long long stride_f, const RobeParams& p, const QbPlan& s,
                   const QbScratch& w, cudaStream_t st) {
  const long long warps =
      ((long long)s.n_items * s.n_seg + s.chunk - 1) / s.chunk;
  const int blocks = (int)((warps + kWalkWarps - 1) / kWalkWarps);
  qb_walk_kernel<T, kSign><<<blocks, 32 * kWalkWarps, 0, st>>>(
      static_cast<const T*>(g), rows, static_cast<const signed char*>(codes),
      ws, ws_scale, stride_b, stride_f, p, s, w);
  return (int)cudaGetLastError();
}

}  // namespace

// g: the lookup's cotangent, n_rows = B*F rows of dim elements in the
// scale's dtype (0 = f32, 1 = bf16), row (b, f) at element b*stride_b +
// f*stride_f, its elements contiguous; rows [n_rows] int32 (field = index
// % n_fields); codes [|M|] int8; ws [|M|] f32, zeroed by the caller,
// receives delta's gradient; gscale [ceil(|M| / 2^group_log2)] in the
// scale's dtype receives the scales' gradient (f32: zeroed by the caller,
// summed in place; bf16: written); scratch, scratch_bytes long (at least
// what kernels/qrobe_lookup.py's bwd_plan gives), need not be zeroed.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for bad shapes, a scratch too small or 2^31 pairs or more.
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
  if (n_rows < 1 || n_rows % n_fields || stride_b < 0 || stride_f < 0 ||
      group_log2 < 0 || group_log2 > 30 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  QbPlan s = qb_make_plan(p, n_rows, group_log2);
  const long long n_pairs = (long long)n_rows * s.n_seg;
  if (n_pairs >= (1LL << 31) ||
      scratch_bytes_ < (long long)qb_scratch_bytes(s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t cerr;
  if ((cerr = qb_chunk(n_pairs, &s.chunk)) != cudaSuccess) return (int)cerr;
  const QbScratch w = qb_carve(scratch, s);
  float* ws_scale = dtype == 0 ? static_cast<float*>(gscale) : w.gsum;
  if (dtype == 1 && (cerr = cudaMemsetAsync(w.gsum, 0, 4 * (size_t)s.n_groups,
                                            st)) != cudaSuccess)
    return (int)cerr;
  const int* r = static_cast<const int*>(rows);
  if ((err = rs_seg_sort(QbKey{r, p, s.lw}, n_rows, s.batch, n_fields,
                         s.n_seg, s.n_bands, w.cnt, w.tiles, w.sorted, st)))
    return err;
  float* f32 = static_cast<float*>(ws);
  err = dtype == 0
      ? (p.use_sign ? qb_launch_walk<float, true>
                    : qb_launch_walk<float, false>)(
            g, r, codes, f32, ws_scale, stride_b, stride_f, p, s, w, st)
      : (p.use_sign ? qb_launch_walk<__nv_bfloat16, true>
                    : qb_launch_walk<__nv_bfloat16, false>)(
            g, r, codes, f32, ws_scale, stride_b, stride_f, p, s, w, st);
  if (err || dtype == 0) return err;
  return rs_round(w.gsum, gscale, s.n_groups, st);
}
