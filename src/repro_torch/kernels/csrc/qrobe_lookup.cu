// int8 ROBE lookup: [B, F] row ids -> [B, F, d] embeddings gathered as int8
// codes through the ROBE hash and dequantized against learned per-group
// scales: out = code[slot] * scale[slot >> group_log2] * sign, computed in
// f32 and rounded once into the scale's dtype.  With the optional f32
// `delta` (the qrobe backend's straight-through carrier) each element adds
// delta[slot] * sign in the same pass, as the backend's two-op sum does:
// out = round(f32(round(code * scale * sign)) + f32(round(delta * sign))).
//
// Replaces: src/repro/kernels/robe_lookup.py, qrobe_lookup_pallas (bodies
// _q_aligned_kernel and _q_general_kernel), and the backend's second
// lookup of delta (src/repro/nn/embedding_backends/qrobe.py, lookup).
//
// Bound on an H100: bytes.  Each output element reads one 1-byte code and
// (through L1, shared by the 256 slots of a group) one scale, and writes
// one 4-byte (f32) or 2-byte (bf16) value; with delta, one more 4-byte
// read.  The codes of the full-width array are 26.1 MB and its scales
// 0.41 MB, so unlike the f32 ROBE array they fit the 50 MB L2; the output
// write dominates.  delta is 104.5 MB, twice the L2, as robe_lookup's M.
//
// What held the first design back (one warp per (row, field), each lane
// hashing each of its elements and loading one byte; 2.46 ms at
// B=262,144 against a 1.06 ms bound on an NVIDIA H100 80GB HBM3 at
// 700 W) was the per-element hash and a byte a load.
//
// Design: robe_lookup.cu's.  Blocks of kWarps warps on a persistent grid;
// each warp walks groups of kItems consecutive (row, field) items, the
// next group's rows loaded a group ahead.  Per group and chunk of at most
// 128 elements of each row:
//  - the lanes hash every ROBE block the group's rows span into a table
//    in shared memory, one slot hash per block in every regime (Z < d,
//    Z = d, Z > d with rows sharing blocks, Z = 1);
//  - a lane takes a run of kVec consecutive elements, the lanes
//    consecutive runs.  A whole run (inside one block and the chunk, its
//    codes in aligned 4-byte words inside the array, so it does not wrap)
//    has consecutive slots: its codes are the one or two words that hold
//    them, lined up by a funnel shift, and its scales those of its first
//    and last slot, split at the next group's first slot (kVec <= 256
//    slots span at most two groups).  Any other run (across a block's
//    edge, past the chunk, across the circular wrap at |M|, Z < kVec)
//    reads element by element, and its elements may reach a third group.
//    The group comes from the WRAPPED slot, so the last, partial group
//    needs no special case;
//  - with delta, the run's delta[slot] too;
//  - every gather of the group (codes, scales, delta) is issued before
//    any is used, and nothing loaded is combined until then;
//  - code * scale in f32, the sign (hashed per element from the whole
//    index; a template flag, so a spec without one pays no branch), one
//    rounding; with delta, delta * sign rounded, added in f32, rounded
//    again.  The values go to a stage in shared memory and leave it as
//    16-byte evict-first stores (robe_copy_out), so the output does not
//    push the codes out of L2.
// A masked element (past the chunk, or of a missing item of a short last
// group) reads slot 0 and is dropped.  The products are __fmul_rn and the
// delta sum __fadd_rn: a contracted multiply-add would round once where
// the plain version rounds twice.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_split.py):
// runs of 4 beat runs of 1 and 2, and 4 items a group beat 2 and 8; with
// every gather an L1 hit the kernel runs as fast as its stores alone, so
// what remains is the gathers' latency: codes from L2, delta (104.5 MB,
// twice the L2) from device memory.
#include "robe_common.cuh"

namespace {

constexpr int kWarps = 4;  // warps of a block
constexpr int kItems = 4;  // (row, field) items a warp takes at once
constexpr int kVec = 4;    // consecutive elements of a lane's run: 1, 2, 4
constexpr int kRuns = kRobeChunk / (32 * kVec);  // runs of a lane a chunk

// What a lane holds of one run between its gathers and their use.
struct QRun {
  unsigned int slot[kVec];  // each element's slot (0 where masked)
  unsigned int word[kVec];  // a whole run: the aligned words that hold its
                            // codes (word[0], word[1]); any other: code j
                            // in word[j]'s low byte
  int shift;                // a whole run: the bit its first code starts
                            // at in word[0]; any other: -1
  float first, last;        // the scales of slot[0]'s and slot[kVec-1]'s
                            // groups
  float delta[kVec];        // delta[slot] (lookups with delta only)
};

// Start the gathers of the run of elements e .. e + kVec - 1 of row x in
// the chunk at e0 (hb: the item's block hashes; cw: the chunk's width;
// valid: the item exists; aligned: codes starts on a 4-byte boundary).
// Nothing loaded is used here, so the gathers of every run of a group are
// in flight together.
template <typename T, bool kDelta>
__device__ __forceinline__ void qrobe_gather(
    const RobeParams& p, const unsigned int* hb, int x, int e0, int e,
    int cw, bool valid, bool aligned, const signed char* __restrict__ codes,
    const T* __restrict__ scale, const float* __restrict__ delta,
    int group_log2, QRun& r) {
  const unsigned int zm = (1u << p.log2_z) - 1u;
  const unsigned int pos =
      (((unsigned int)x * (unsigned)p.dim + e0) & zm) + e;
  bool whole = valid && e + kVec <= cw && (pos & zm) + (kVec - 1) <= zm;
  if (whole) {
    r.slot[0] = robe_slot_in(p, hb[pos >> p.log2_z], pos & zm);
    // the aligned words that hold the run's first and last code lie
    // inside the array (so the run does not wrap either)
    whole = kVec == 1 ||
            (aligned && ((r.slot[0] + kVec - 1) | 3u) < p.h.m);
  }
  if (whole) {
#pragma unroll
    for (int j = 1; j < kVec; ++j) r.slot[j] = r.slot[0] + j;
    if (kVec == 1) {
      r.word[0] = (unsigned char)codes[r.slot[0]];
      r.shift = 0;
    } else {
      const unsigned int* w =
          reinterpret_cast<const unsigned int*>(codes) + (r.slot[0] >> 2);
      r.word[0] = __ldg(w);
      r.word[1] = (r.slot[0] & 3) + kVec > 4 ? __ldg(w + 1) : 0u;
      r.shift = (int)(r.slot[0] & 3) * 8;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool ok = valid && e + j < cw;
      r.slot[j] = ok ? robe_chunk_slot(p, hb, x, e0, e + j) : 0u;
      r.word[j] = (unsigned char)codes[r.slot[j]];
    }
    r.shift = -1;
  }
  r.first = to_f32(scale[r.slot[0] >> group_log2]);
  r.last = to_f32(scale[r.slot[kVec - 1] >> group_log2]);
  if (kDelta) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) r.delta[j] = delta[r.slot[j]];
  }
}

// The run's values in T, from its gathers: code * scale (* sign) in f32,
// rounded once; with delta, plus delta (* sign) rounded, summed in f32 and
// rounded again.  k: the element index x*d + e of the run's first element.
template <typename T, bool kDelta, bool kSign>
__device__ __forceinline__ void qrobe_values(
    const RobeParams& p, const QRun& r, unsigned int t,
    unsigned long long k, const T* __restrict__ scale, int group_log2,
    T (&v)[kVec]) {
  unsigned int codes = r.word[0];
  float s[kVec];
  if (r.shift >= 0) {
    // consecutive slots: those before the next group's first slot take
    // the first scale, the rest the last
    if (kVec > 1)
      codes = __funnelshift_r(r.word[0], r.word[1], (unsigned int)r.shift);
    const unsigned int split =
        (((r.slot[0] >> group_log2) + 1u) << group_log2) - r.slot[0];
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[j] = j < split ? r.first : r.last;
  } else {
    // element by element: a run may reach a third group
    const unsigned int g_first = r.slot[0] >> group_log2,
                       g_last = r.slot[kVec - 1] >> group_log2;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j > 0) codes |= r.word[j] << (8 * j);
      const unsigned int g = r.slot[j] >> group_log2;
      s[j] = g == g_first ? r.first
             : g == g_last ? r.last
                           : to_f32(scale[g]);
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float x = __fmul_rn((float)(signed char)(codes >> (8 * j)), s[j]);
    float d = kDelta ? r.delta[j] : 0.f;
    if (kSign) {
      const float sg = robe_sign(p, t, k + j);
      x = __fmul_rn(x, sg);
      d = __fmul_rn(d, sg);
    }
    v[j] = from_f32<T>(x);
    if (kDelta)
      v[j] = from_f32<T>(__fadd_rn(to_f32(v[j]), to_f32(from_f32<T>(d))));
  }
}

// kVec values of T as one shared-memory store.
template <typename T>
struct alignas(sizeof(T) * kVec) QPack {
  T v[kVec];
};

template <typename T, bool kDelta, bool kSign>
__global__ void __launch_bounds__(32 * kWarps)
    qrobe_lookup_kernel(const signed char* __restrict__ codes,
                        const T* __restrict__ scale,
                        const float* __restrict__ delta,
                        const int* __restrict__ rows, T* __restrict__ out,
                        int n_rows, int group_log2, const RobeParams p,
                        const RobePlan q) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* base = reinterpret_cast<char*>(smem4) + warp * q.warp_bytes;
  unsigned int* table = reinterpret_cast<unsigned int*>(base);
  int* xs = reinterpret_cast<int*>(base + q.table);         // rows of a group
  unsigned int* ts = reinterpret_cast<unsigned int*>(xs + kItems);  // tables
  T* stage = reinterpret_cast<T*>(xs + 2 * kItems);
  const int dim = p.dim, nblk = q.nblk, n_fields = p.n_fields;
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
  const long long warps = (long long)gridDim.x * kWarps;
  long long g = (long long)blockIdx.x * kWarps + warp;

  // lane u < kItems follows item u of the warp's groups: its field, and
  // its row one group ahead
  long long item = g * kItems + lane;
  int f = (int)((unsigned int)item % (unsigned int)n_fields);
  int next = lane < kItems && item < n_rows ? rows[item] : 0;
  // the first (item, block) pair of each table pass: lane = u * nblk + m
  const int u0 = lane / nblk, m0 = lane - u0 * nblk;

  for (; g < q.groups; g += warps) {
    const long long first = g * kItems;
    const int n_valid = (int)min((long long)kItems, n_rows - first);
    if (lane < kItems) {
      xs[lane] = next;
      ts[lane] = p.tids[f];
      item += warps * kItems;
      f += q.f_step;
      if (f >= n_fields) f -= n_fields;
      next = item < n_rows ? rows[item] : 0;  // in flight behind this group
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
      // every gather of the group before any is used
      QRun runs[kItems][kRuns];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
#pragma unroll
        for (int i = 0; i < kRuns; ++i)
          qrobe_gather<T, kDelta>(p, table + u * nblk, xs[u], e0,
                                  (lane + 32 * i) * kVec, cw, u < n_valid,
                                  aligned, codes, scale, delta, group_log2,
                                  runs[u][i]);
      }
      // a run lands as one store when every stage row starts aligned
      const bool packed = cw % kVec == 0;
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        if (u >= n_valid) break;
        const unsigned long long k0 =
            (unsigned long long)(unsigned int)xs[u] * (unsigned)dim + e0;
#pragma unroll
        for (int i = 0; i < kRuns; ++i) {
          const int e = (lane + 32 * i) * kVec;
          if (e >= cw) break;
          QPack<T> v;
          qrobe_values<T, kDelta, kSign>(p, runs[u][i], ts[u], k0 + e,
                                         scale, group_log2, v.v);
          if (packed) {
            *reinterpret_cast<QPack<T>*>(stage + u * cw + e) = v;
          } else {
            for (int j = 0; j < kVec && e + j < cw; ++j)
              stage[u * cw + e + j] = v.v[j];
          }
        }
      }
      __syncwarp();
      if (cw == dim) {  // the group's rows are one contiguous run
        robe_copy_out(out + first * dim, stage, n_valid * dim, lane, 32);
      } else {
        for (int u = 0; u < n_valid; ++u)
          robe_copy_out(out + (first + u) * dim + e0, stage + u * cw, cw,
                        lane, 32);
      }
      __syncwarp();  // the table, the stage and xs are free again
    }
  }
}

template <typename T, bool kDelta, bool kSign>
int launch(const void* codes, const void* scale, const void* delta,
           const void* rows, void* out, int n_rows, int group_log2,
           const RobeParams& p, cudaStream_t stream) {
  RobePlan q = robe_make_plan(p, n_rows, kItems, (int)sizeof(T));
  const size_t smem = (size_t)kWarps * q.warp_bytes;
  auto kernel = qrobe_lookup_kernel<T, kDelta, kSign>;
  int grid = 0;
  cudaError_t err = robe_plan_grid(kernel, kWarps, kItems, smem, p, &q,
                                   &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const signed char*>(codes), static_cast<const T*>(scale),
      static_cast<const float*>(delta), static_cast<const int*>(rows),
      static_cast<T*>(out), n_rows, group_log2, p, q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* codes, const void* scale, const void* delta,
           const void* rows, void* out, int n_rows, int group_log2,
           const RobeParams& p, cudaStream_t stream) {
  auto* fn = delta ? (p.use_sign ? launch<T, true, true>
                                 : launch<T, true, false>)
                   : (p.use_sign ? launch<T, false, true>
                                 : launch<T, false, false>);
  return fn(codes, scale, delta, rows, out, n_rows, group_log2, p, stream);
}

}  // namespace

// codes [|M|] int8, scale [ceil(|M| / 2^group_log2)] (dtype 0 = f32,
// 1 = bf16), delta [|M|] f32 or null, rows [n_rows] int32 (n_rows = B*F,
// field = index % n_fields), out [n_rows, dim] in scale's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int qrobe_lookup_launch(const void* codes, const void* scale,
                                   const void* delta, const void* rows,
                                   void* out, int n_rows, int scale_dtype,
                                   const unsigned long long* coeffs,
                                   const unsigned int* tids, int n_fields,
                                   int dim, int log2_z, int use_sign,
                                   int group_log2, void* stream) {
  if (group_log2 < 0 || group_log2 > 30 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  RobeParams p;
  int err = robe_make_params(&p, coeffs, tids, n_fields, dim, log2_z,
                             use_sign);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scale_dtype) {
    case 0:
      return launch<float>(codes, scale, delta, rows, out, n_rows,
                           group_log2, p, s);
    case 1:
      return launch<__nv_bfloat16>(codes, scale, delta, rows, out, n_rows,
                                   group_log2, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
