// Backward of the quotient-remainder lookup of the ``hashed`` substrate.
// The forward gives e[b, f] = Q[q] * R[r] (q = id // m + q_off[f], r = id %
// m + r_off[f]); its cotangent g [B, F, d] gives, by the product rule,
//   dQ[q] += g[b, f] * R[r]   and   dR[r] += g[b, f] * Q[q],
// summed in f32 and delivered in the tables' dtype, with floor semantics
// and a runtime m, as the forward takes them.
//
// Replaces: src/repro/kernels/ops.py:279, _qr_bwd (the custom-VJP backward
// of qr_lookup, two XLA scatter-adds; the TPU kernel qr_lookup_pallas has
// no backward of its own).
//
// Bound on an H100: bytes.  g is read (872 MB at B = 65,536, full
// dlrm-criteo-tb width), the touched rows of both tables are read and their
// gradients written.  At full width Q has 24,941 rows (12.8 MB, in L2) and
// R 212,992 (109 MB, twice the L2); 13 of the 26 fields have a single Q
// row, so one Q row receives every sample of its field (65,536 items), and
// the hottest R row 36,887.
//
// What held the first design back (a sort and a walk for each table; 1.26
// ms at B = 65,536 on an NVIDIA H100 80GB HBM3 at 700 W): each walk read
// all of g and the other table's row for every item, 1.74 GB, about 0.52
// ms at 3.35 TB/s, so the two walks (0.46 and 0.44 ms) sat at that
// design's floor; the two sorts took 0.31 ms, the R sort's one-block scan
// walking 212,992 counts 52 tiles one after another.
//
// Design: one sort, by R row (row_sort.cuh, its scan one block a tile for
// R's 52 tiles), since R's gradient is the one whose atomics would miss L2;
// then one walk.
//  - A warp takes a chunk of consecutive sorted places (kRsChunk = 128, or
//    fewer where the batch is small, so that the card has kWarpsPerSm
//    warps an SM to run) and 32 V elements of the rows, V = 4 consecutive
//    ones a lane (16-byte loads) where the rows and pointers allow.  Lane l
//    decodes item l of each window of 32 (its R row, its Q row, its row of
//    g), the warp then runs through the window with the decoded values
//    shuffled to every lane, the loads of kBatch / 2 items in flight at a
//    time (kBatch for V = 1).
//  - Each item reads its row of g once in the whole backward and its Q row
//    from L2; a run of equal r loads its R row once (where the key
//    changes), sums g * Q[q] into registers, and sends it to dR when the
//    key changes and at the end of the chunk.
//  - g * R[r] goes to a dQ sum keyed by q: registers while q repeats (the
//    13 single-row fields keep one q through all their R runs), else a
//    slot of a small direct-mapped table in shared memory (kQSlots rows a
//    warp, slot q % kQSlots, the tags one a lane), whose row is sent to dQ
//    when another q takes its slot and at the end of the chunk.
//  - A row goes to its gradient through shared memory, so that each atomic
//    instruction of the warp covers 32 consecutive elements: with four
//    consecutive elements a lane sent straight from registers, the atomics
//    took 0.48 ms (coalesced, ~0.11).
//  - bf16 tables accumulate into the f32 workspaces and a last kernel
//    rounds each once into its output.
// Measured (tools/kernel_split.py; NVIDIA H100 80GB HBM3, 700 W) at B =
// 65,536 / 512: 0.67 / 0.083 ms, against 1.26 / 0.22 for the first design
// (a sort and a walk for each table); atomics skipped 0.56, the sort and
// the workspaces' zeroing alone 0.17 / 0.060 (the zeroing 0.042).
// A row of g may sit at any (batch, field) strides with its elements
// contiguous.  The f32 sums of a row come in no fixed order across chunks:
// results agree with the plain version within a bound scaled by the sum of
// |g * other| a row receives, never bit for bit.
#include "row_sort.cuh"

namespace {

constexpr int kWalkWarps = 4;    // warps of a block of the walk
constexpr int kBatch = 8;        // items whose loads the walk has in flight
constexpr int kQSlots = 16;      // dQ row sums a warp keeps, keyed by q
constexpr int kWarpsPerSm = 32;  // warps an SM the chunk sizing aims at

struct QrBwdParams {
  int n_fields, m, dim, batch;
  long long stride_b, stride_f;
  int q_off[ROBE_MAX_FIELDS];
  int r_off[ROBE_MAX_FIELDS];
};

// id // m and id % m with floor semantics, as the forward takes them.
__device__ __forceinline__ void qr_split(int id, int m, int* quo, int* rem) {
  int q = id / m, r = id - q * m;
  if (r < 0) {
    r += m;
    --q;
  }
  *quo = q;
  *rem = r;
}

// An item's row of R.
struct QrKey {
  const int* idx;
  QrBwdParams p;
  __device__ __forceinline__ unsigned operator()(int item) const {
    int quo, rem;
    qr_split(idx[item], p.m, &quo, &rem);
    return (unsigned)(rem + p.r_off[item % p.n_fields]);
  }
};

// V consecutive elements as floats: one 16-byte (f32) or 8-byte (bf16)
// load for V = 4, which the launcher has aligned.
template <int V>
__device__ __forceinline__ void qr_load(const float* s, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(s));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = __ldg(s);
  }
}
template <int V>
__device__ __forceinline__ void qr_load(const __nv_bfloat16* s,
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
    v[0] = to_f32(__ldg(s));
  }
}

// The walk of the items sorted by their row of R (see the header): dR[r]
// += g * Q[q], dQ[q] += g * R[r].  A warp takes 32 V consecutive elements,
// a lane V of them (16-byte loads for V = 4); a row it sends to a gradient
// goes through shared memory, so that each atomic instruction of the warp
// covers 32 consecutive elements.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kWalkWarps)
    qr_walk_kernel(const T* __restrict__ g, const T* __restrict__ qt,
                   const T* __restrict__ rt, const int* __restrict__ idx,
                   float* __restrict__ ws_q, float* __restrict__ ws_r,
                   const uint2* __restrict__ sorted, int n_items, int chunk,
                   const QrBwdParams p) {
  constexpr int kB = V == 4 ? kBatch / 2 : kBatch;   // items in flight
  // a warp's dQ slots, and a stage for the dR row it sends
  __shared__ float qsum[kWalkWarps][kQSlots + 1][32 * V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = (p.dim + 32 * V - 1) / (32 * V);
  const long long wid = (long long)blockIdx.x * kWalkWarps + warp;
  const long long ch = wid / cols;
  const int base = (int)(wid - ch * cols) * 32 * V;   // the warp's first
  const int e = base + lane * V;                      // the lane's first
  const long long lo = ch * chunk;
  if (lo >= n_items) return;
  const int hi = (int)(lo + chunk < n_items ? lo + chunk : n_items);
  const bool on = e < p.dim;
  float(*slot)[32 * V] = qsum[warp];
  unsigned tag = kRsNone;   // lane s < kQSlots: the Q row slot s holds
  unsigned rcur = kRsNone, qcur = kRsNone;
  // R[rcur] and its dR sum; the dQ sum of row qcur
  float rv[V], racc[V], qacc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) rv[k] = racc[k] = qacc[k] = 0.f;
  // a warp's row (lane l's elements at l V, ...) into the gradient row at
  // dst, element 32 k + l by lane l, one atomic a nonzero element
  auto send = [&](const float* row, float* dst) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int x = 32 * k + lane;
      const float v = row[x];
      if (base + x < p.dim && v != 0.f) atomicAdd(dst + x, v);
    }
    __syncwarp();   // the row may be written again
  };
  auto flush_r = [&]() {
    if (rcur == kRsNone) return;
#pragma unroll
    for (int k = 0; k < V; ++k) slot[kQSlots][lane * V + k] = racc[k];
    send(slot[kQSlots], ws_r + (long long)rcur * p.dim + base);
  };
  // qacc, the sum of row qcur, into its slot, sending the row the slot
  // held if it is another (every lane takes the same branches)
  auto park = [&]() {
    if (qcur == kRsNone) return;
    const int s = (int)(qcur & (kQSlots - 1));
    const unsigned held = __shfl_sync(kRsFull, tag, s);
    float* sv = slot[s] + lane * V;
    if (held == qcur) {
#pragma unroll
      for (int k = 0; k < V; ++k) sv[k] += qacc[k];
      return;
    }
    if (held != kRsNone) send(slot[s], ws_q + (long long)held * p.dim + base);
#pragma unroll
    for (int k = 0; k < V; ++k) sv[k] = qacc[k];
    if (lane == s) tag = qcur;
  };
  for (int w0 = (int)lo; w0 < hi; w0 += 32) {
    const int n = min(32, hi - w0);
    unsigned key = kRsNone, qrow = 0;
    long long goff = 0;
    if (lane < n) {
      const uint2 rec = sorted[w0 + lane];
      const int item = (int)rec.x;
      const int b = item / p.n_fields, f = item - b * p.n_fields;
      int quo, rem;
      qr_split(idx[item], p.m, &quo, &rem);
      key = rec.y;
      qrow = (unsigned)(quo + p.q_off[f]);
      goff = (long long)b * p.stride_b + (long long)f * p.stride_f;
    }
    // kB items at a time: every load of a batch before its sums; an R row
    // only where the key changes
    for (int q0 = 0; q0 < n; q0 += kB) {
      unsigned kr[kB], kq[kB];
      float gv[kB][V], qv[kB][V], rl[kB][V];
      unsigned prev = rcur;
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int q = q0 + u < n ? q0 + u : n - 1;
        kr[u] = __shfl_sync(kRsFull, key, q);
        kq[u] = __shfl_sync(kRsFull, qrow, q);
        const long long gq = __shfl_sync(kRsFull, goff, q);
        const bool take = on && q0 + u < n;
#pragma unroll
        for (int k = 0; k < V; ++k) gv[u][k] = qv[u][k] = rl[u][k] = 0.f;
        if (take) {
          qr_load<V>(g + gq + e, gv[u]);
          qr_load<V>(qt + (long long)kq[u] * p.dim + e, qv[u]);
          if (kr[u] != prev)
            qr_load<V>(rt + (long long)kr[u] * p.dim + e, rl[u]);
        }
        prev = kr[u];
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (q0 + u >= n) break;
        if (kr[u] != rcur) {
          flush_r();
          rcur = kr[u];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            rv[k] = rl[u][k];
            racc[k] = 0.f;
          }
        }
        const bool same = kq[u] == qcur;
        if (!same) park();
#pragma unroll
        for (int k = 0; k < V; ++k) {
          racc[k] = fmaf(gv[u][k], qv[u][k], racc[k]);
          qacc[k] = same ? fmaf(gv[u][k], rv[k], qacc[k]) : gv[u][k] * rv[k];
        }
        qcur = kq[u];
      }
    }
  }
  flush_r();
  park();
  for (int s = 0; s < kQSlots; ++s) {
    const unsigned held = __shfl_sync(kRsFull, tag, s);
    if (held != kRsNone) send(slot[s], ws_q + (long long)held * p.dim + base);
  }
}

template <typename T, int V>
int walk(const void* g, const void* q, const void* r, const int* idx,
         float* ws_q, float* ws_r, const RowSort& w, int n_items,
         const QrBwdParams& p, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  // kRsChunk places a warp, fewer where that would leave the card short
  // of kWarpsPerSm warps an SM (32 at the least)
  const long long cols = (p.dim + 32 * V - 1) / (32 * V);
  const long long want = (long long)sms * kWarpsPerSm;
  long long chunk = ((long long)n_items * cols + want - 1) / want;
  chunk = chunk < 32 ? 32 : chunk > kRsChunk ? kRsChunk : chunk;
  const long long chunks = ((long long)n_items + chunk - 1) / chunk;
  const long long blocks = (chunks * cols + kWalkWarps - 1) / kWalkWarps;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  qr_walk_kernel<T, V><<<(int)blocks, 32 * kWalkWarps, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(q),
      static_cast<const T*>(r), idx, ws_q, ws_r, w.sorted, n_items,
      (int)chunk, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const void* q, const void* r, const int* idx,
           float* ws_q, float* ws_r, void* out_q, void* out_r,
           long long n_q, long long n_r, const RowSort& w, int n_items,
           const QrBwdParams& p, bool vec, cudaStream_t st) {
  int err;
  if ((err = rs_sort(QrKey{idx, p}, n_items, p.batch, p.n_fields, n_r, w,
                     st)) ||
      (err = vec ? walk<T, 4>(g, q, r, idx, ws_q, ws_r, w, n_items, p, st)
                 : walk<T, 1>(g, q, r, idx, ws_q, ws_r, w, n_items, p, st)))
    return err;
  if (sizeof(T) == 4) return 0;
  if ((err = rs_round(ws_q, out_q, n_q * p.dim, st))) return err;
  return rs_round(ws_r, out_r, n_r * p.dim, st);
}

}  // namespace

// g: the lookup's cotangent, n_rows = B*F rows of dim elements (dtype 0 =
// f32, 1 = bf16), row (b, f) at element b*stride_b + f*stride_f, its
// elements contiguous; q [n_q, dim] and r [n_r, dim] in g's dtype; idx
// [n_rows] int32 ids (field = index % n_fields) whose rows lie in the
// tables; q_off / r_off [n_fields]; ws_q [n_q, dim] and ws_r [n_r, dim]
// f32, zeroed by the caller, receive the two gradients; for bf16, out_q
// and out_r then receive them rounded once (for f32 they are not read);
// scratch, scratch_bytes long (at least rs_scratch_bytes(max(n_q, n_r),
// n_rows)), need not be zeroed.  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for bad shapes or a scratch too small.
extern "C" int qr_lookup_bwd_launch(
    const void* g, const void* q, const void* r, const void* idx, void* ws_q,
    void* ws_r, void* out_q, void* out_r, void* scratch,
    long long scratch_bytes_, int n_rows, int dtype, long long stride_b,
    long long stride_f, const int* q_off, const int* r_off, int n_fields,
    int m, int dim, long long n_q, long long n_r, void* stream) {
  if (n_fields < 1 || n_fields > ROBE_MAX_FIELDS || m < 1 || dim < 1 ||
      n_rows < 1 || n_rows % n_fields || n_q < 1 || n_r < 1 ||
      n_q >= (1LL << 31) || n_r >= (1LL << 31) || stride_b < 0 ||
      stride_f < 0)
    return (int)cudaErrorInvalidValue;
  const long long n_keys = n_q > n_r ? n_q : n_r;
  if (scratch_bytes_ < (long long)rs_scratch_bytes(n_keys, n_rows))
    return (int)cudaErrorInvalidValue;
  QrBwdParams p;
  p.n_fields = n_fields;
  p.m = m;
  p.dim = dim;
  p.batch = n_rows / n_fields;
  p.stride_b = stride_b;
  p.stride_f = stride_f;
  for (int f = 0; f < n_fields; ++f) {
    p.q_off[f] = q_off[f];
    p.r_off[f] = r_off[f];
  }
  const RowSort w = rs_carve(scratch, n_keys);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* wq = static_cast<float*>(ws_q);
  float* wr = static_cast<float*>(ws_r);
  // four elements a lane where g's rows, Q and R start on four elements
  const uintptr_t al = dtype == 0 ? 16 : 8;
  const bool vec = dim % 4 == 0 && stride_b % 4 == 0 && stride_f % 4 == 0 &&
                   (uintptr_t)g % al == 0 && (uintptr_t)q % al == 0 &&
                   (uintptr_t)r % al == 0;
  switch (dtype) {
    case 0:
      return launch<float>(g, q, r, ix, wq, wr, out_q, out_r, n_q, n_r, w,
                           n_rows, p, vec, st);
    case 1:
      return launch<__nv_bfloat16>(g, q, r, ix, wq, wr, out_q, out_r, n_q,
                                   n_r, w, n_rows, p, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
