// Backward of the ROBE lookup: the paper's Fig.-2 scatter-add.  Every
// element's cotangent g[b, f, i], times the element's ±1 sign, is added into
// the slot of M its forward read: gM[slot(t_f, x, i)] += g[b, f, i] *
// sign(t_f, x, i), accumulated in f32 and delivered in M's dtype.
//
// Replaces: src/repro/kernels/ops.py:67, _lookup_bwd (the custom-VJP
// backward of robe_lookup, an XLA scatter-add; the TPU kernel
// robe_lookup_pallas has no backward of its own).
//
// Bound on an H100: bytes.  Each element's cotangent is read once; the f32
// workspace of |M| slots is zeroed (by the wrapper) and each touched slot is
// read and written once by the atomics (8 bytes).  At full width M holds
// 26.1M f32 slots (104.5 MB), twice the 50 MB L2, and the batch's zipf
// head sends tens of thousands of atomics to each of a few slots.  A walk
// in item order lands its atomics all over M, so most miss the L2, and
// leaves the head's chains whole.
//
// Design: the (item, segment) pairs are bucketed by band of M, then
// scattered band after band, with the duplicates of a window combined
// before their atomics.  The passes live in robe_scatter.cuh, which
// qrobe_lookup_bwd.cu shares; this file adds the bf16 rounding.
//  - A pair is a run of at most W = min(Z, 32) elements of one item,
//    aligned to W in the table's element index, so it lies in one ROBE
//    block: at Z = 32, d = 128 an item is exactly 4 pairs.  Its slots are
//    one run of M from the pair's first slot (wrapped once at |M|).
//  - rb_count_kernel hashes each pair once (robe_uhash of its block, the
//    arithmetic of robe_lookup, so slots stay bit-identical), keeps its
//    first slot, and counts it into the bucket (band, field), band = first
//    slot >> band_log2.  Bands are 2^kBandLog2 = 4M slots (16 MiB of f32),
//    so the atomics of one band and the lines in flight fit the L2; their
//    number follows |M| (7 at full width, 1 below 4M slots; wider bands
//    where (bands x fields) would pass kMaxBuckets).  A pair that wraps at
//    |M| goes to the band of its first slot.  Each of at most
//    kSortBlocks blocks takes one contiguous range of items and writes
//    its own count of every bucket: no atomics outside shared memory.
//  - rb_scan_kernel, one block, scans those counts bucket by bucket,
//    block by block, into each block's start in each bucket;
//    rb_place_kernel (the same blocks, the same ranges) writes each pair,
//    its index and first slot (8 bytes), at its block's next place in its
//    bucket.  A bucket thus holds its pairs in item order.
//  - rb_scatter_kernel: warps walk the sorted pairs 32 at a time (a
//    window).  __match_any_sync finds the pairs of the window with the
//    same (field, segment); every lane loads its element of each of the 32
//    pairs (a coalesced 128 B a pair at W = 32, streamed past the L2),
//    duplicates are summed in shared memory, and only the first of each
//    group sends its warp-wide line of atomics (REDs that no warp waits
//    for), the sign applied once.  The resident warps sit within one or two
//    bands of M at a time, so the REDs land in lines the L2 holds, and the
//    zipf head's chains shrink by up to 32x.
// A row of g may sit at any (batch, field) strides with its elements
// contiguous, so the cotangent that autograd hands over after the model's
// concat is read in place.  bf16 arrays accumulate into the f32 workspace
// and a last kernel rounds it once into the output.
//
// The f32 sum over a slot's aliased elements has no fixed order (the
// atomics land as they come): results agree with the plain version within
// a bound scaled by the sum of |g| a slot receives, never bit for bit.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// tools/kernel_split.py, torch.profiler): 0.87 ms at B=65,536 on the
// zipf batch of the CTR stream against the 0.353 ms byte bound (an
// item-order walk: 1.18).  The zeroing takes 0.032, the count 0.031, the
// scan 0.013, the place 0.072 and the scatter 0.72-0.75: its walk about
// 0.37 and its atomics about 0.34.  The atomics now stay in the L2 (into
// an L2-sized window they are only 0.03 faster) and combining saves 0.40
// of contention; what is left is the L2's atomic throughput and the
// walk's instructions.
#include "robe_scatter.cuh"

namespace {

// out[s] = the f32 workspace rounded once into bf16.
__global__ void robe_round_kernel(const float* __restrict__ ws,
                                  __nv_bfloat16* __restrict__ out,
                                  long long n) {
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += (long long)gridDim.x * blockDim.x)
    out[s] = __float2bfloat16(ws[s]);
}

}  // namespace

// g: the lookup's cotangent, n_rows = B*F rows of dim elements (dtype 0 =
// f32, 1 = bf16), row (b, f) at element b*stride_b + f*stride_f, its
// elements contiguous; rows [n_rows] int32 (field = index % n_fields);
// ws [|M|] f32, zeroed by the caller, receives the scatter-add; scratch,
// scratch_bytes long (at least what kernels/robe_lookup.py's bwd_plan
// gives), holds the bucketed pairs and need not be zeroed.  For bf16, out
// [|M|] bf16 then receives ws rounded once; for f32 the sum stays in ws and
// out is not read.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a scratch too small, more than 2^31 - 1 pairs, or an item of more
// than kStagePairs pairs.
extern "C" int robe_lookup_bwd_launch(const void* g, const void* rows,
                                      void* ws, void* out, void* scratch,
                                      long long scratch_bytes_, int n_rows,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f32 = static_cast<float*>(ws);
  err = robe_scatter(g, rows, f32, scratch, scratch_bytes_, n_rows, dtype,
                     stride_b, stride_f, p, st);
  if (err || dtype == 0) return err;
  const long long n = p.h.m;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  robe_round_kernel<<<(int)(blocks < 65535 * 8 ? blocks : 65535 * 8),
                      threads, 0, st>>>(
      f32, static_cast<__nv_bfloat16*>(out), n);
  return (int)cudaGetLastError();
}
