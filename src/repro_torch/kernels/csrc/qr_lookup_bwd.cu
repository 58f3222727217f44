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
// gradients written.
//
// Design: combining by bucket (row_sort.cuh).  At full width 13 of the 26
// fields have a single Q row, so one Q row receives every sample of its
// field (65,536 items), and the hottest R row 36,887.  So the items are
// sorted by Q row, then walked; then sorted by R row, then walked.
//  - A walk's warp takes kRsChunk = 128 consecutive sorted items and one
//    column block of 32 elements (lanes over elements, so each item's row
//    of g and of the other table is one coalesced 128-byte read).  Lane l
//    decodes item l of each window of 32 (its key, the offsets of its row
//    of g and of the other table's row), the warp then runs through the
//    window with the decoded values shuffled to every lane, the loads of
//    kBatch = 8 items in flight at a time, summing g * other into a
//    register while the key stays the same; the sum goes to the row's f32
//    workspace by one atomic a lane when the key changes and at the end of
//    the chunk.  A row receives at most
//    ceil(items / 128) + 1 atomics an element: 513 for a single-row field.
//  - bf16 tables accumulate into the f32 workspaces and a last kernel
//    rounds each once into its output.
// A row of g may sit at any (batch, field) strides with its elements
// contiguous.  The f32 sums of a row come in no fixed order across chunks:
// results agree with the plain version within a bound scaled by the sum of
// |g * other| a row receives, never bit for bit.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// torch.profiler): 1.26 ms at B = 65,536 on the zipf batch against a 0.32
// ms bound: the two walks 0.51 and 0.48 (each reads all of g and an
// other-table row an item, 1.7 GB, about 0.5 ms at 3.35 TB/s), the count
// and place passes 0.21, the two scans 0.12.  The most atomics one
// gradient element receives (counted by tools/atomic_chains.py): 512 on a
// Q-row element, against 65,536 terms uncombined.
#include "row_sort.cuh"

namespace {

constexpr int kWalkWarps = 8;   // warps of a block of a walk
constexpr int kBatch = 8;       // items whose loads a walk has in flight

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

// An item's row of Q (kQ) or of R.
template <bool kQ>
struct QrKey {
  const int* idx;
  QrBwdParams p;
  __device__ __forceinline__ unsigned operator()(int item) const {
    const int f = item % p.n_fields;
    int quo, rem;
    qr_split(idx[item], p.m, &quo, &rem);
    return (unsigned)(kQ ? quo + p.q_off[f] : rem + p.r_off[f]);
  }
};

// The walk of the items sorted by their row of Q (kQ) or R: ws[key] +=
// g * other[the item's row of the other table].
template <typename T, bool kQ>
__global__ void __launch_bounds__(32 * kWalkWarps)
    qr_walk_kernel(const T* __restrict__ g, const T* __restrict__ other,
                   const int* __restrict__ idx, float* __restrict__ ws,
                   const uint2* __restrict__ sorted, int n_items,
                   const QrBwdParams p) {
  const int lane = threadIdx.x & 31;
  const int cols = (p.dim + 31) >> 5;
  const long long wid =
      (long long)blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  const long long chunk = wid / cols;
  const int e = (int)(wid - chunk * cols) * 32 + lane;
  const long long lo = chunk * kRsChunk;
  if (lo >= n_items) return;
  const int hi = (int)(lo + kRsChunk < n_items ? lo + kRsChunk : n_items);
  const bool on = e < p.dim;
  unsigned cur = kRsNone;
  float acc = 0.f;
  for (int w0 = (int)lo; w0 < hi; w0 += 32) {
    const int n = min(32, hi - w0);
    unsigned key = kRsNone;
    long long goff = 0, ooff = 0;
    if (lane < n) {
      const uint2 rec = sorted[w0 + lane];
      const int item = (int)rec.x;
      const int b = item / p.n_fields, f = item - b * p.n_fields;
      int quo, rem;
      qr_split(idx[item], p.m, &quo, &rem);
      key = rec.y;
      goff = (long long)b * p.stride_b + (long long)f * p.stride_f;
      ooff = (long long)(kQ ? rem + p.r_off[f] : quo + p.q_off[f]) * p.dim;
    }
    // kBatch items at a time: every load of a batch before its sums
    for (int q0 = 0; q0 < n; q0 += kBatch) {
      unsigned kq[kBatch];
      float gv[kBatch], ov[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u < n ? q0 + u : n - 1;
        kq[u] = __shfl_sync(kRsFull, key, q);
        const long long gq = __shfl_sync(kRsFull, goff, q);
        const long long oq = __shfl_sync(kRsFull, ooff, q);
        const bool take = on && q0 + u < n;
        gv[u] = take ? to_f32(g[gq + e]) : 0.f;
        ov[u] = take ? to_f32(other[oq + e]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (q0 + u >= n) break;
        if (kq[u] != cur) {
          if (cur != kRsNone && on && acc != 0.f)
            atomicAdd(ws + (long long)cur * p.dim + e, acc);
          cur = kq[u];
          acc = 0.f;
        }
        acc = fmaf(gv[u], ov[u], acc);
      }
    }
  }
  if (cur != kRsNone && on && acc != 0.f)
    atomicAdd(ws + (long long)cur * p.dim + e, acc);
}

template <typename T, bool kQ>
int walk(const void* g, const void* other, const int* idx, float* ws,
         const RowSort& w, int n_items, const QrBwdParams& p,
         cudaStream_t st) {
  const long long chunks = ((long long)n_items + kRsChunk - 1) / kRsChunk;
  const long long warps = chunks * ((p.dim + 31) >> 5);
  const long long blocks = (warps + kWalkWarps - 1) / kWalkWarps;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  qr_walk_kernel<T, kQ><<<(int)blocks, 32 * kWalkWarps, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(other), idx, ws,
      w.sorted, n_items, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const void* q, const void* r, const int* idx,
           float* ws_q, float* ws_r, void* out_q, void* out_r,
           long long n_q, long long n_r, const RowSort& w, int n_items,
           const QrBwdParams& p, cudaStream_t st) {
  const QrKey<true> kq{idx, p};
  const QrKey<false> kr{idx, p};
  int err;
  if ((err = rs_sort(kq, n_items, p.batch, p.n_fields, n_q, w, st)) ||
      (err = walk<T, true>(g, r, idx, ws_q, w, n_items, p, st)) ||
      (err = rs_sort(kr, n_items, p.batch, p.n_fields, n_r, w, st)) ||
      (err = walk<T, false>(g, q, idx, ws_r, w, n_items, p, st)))
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
  switch (dtype) {
    case 0:
      return launch<float>(g, q, r, ix, wq, wr, out_q, out_r, n_q, n_r, w,
                           n_rows, p, st);
    case 1:
      return launch<__nv_bfloat16>(g, q, r, ix, wq, wr, out_q, out_r, n_q,
                                   n_r, w, n_rows, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
