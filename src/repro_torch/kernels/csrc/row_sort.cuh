// Grouping a batch's (row, field) items by the table row their gradient
// goes to, for the backwards of the compressed substrates' lookups
// (qr_lookup_bwd.cu, tt_lookup_bwd.cu).  Header only, as robe_common.cuh.
//
// The zipf head of a CTR batch sends most items of a field to a few rows
// (at full dlrm-criteo-tb width and B = 65,536: 527,853 items to one row of
// the tensor train's first core, 65,536 to each single-row QR quotient
// field), so a backward that sent one atomic per item and element into its
// row would be bound by chains half a million deep.  Items that share a
// row are therefore combined before they reach global memory, by bucket:
//  - rs_pass_kernel<Key, false> counts each key's items.  Warps walk the
//    batch a field column at a time (32 consecutive samples of one field,
//    so equal keys meet in a warp), __match_any_sync groups a warp's equal
//    keys, and one lane of each group adds the group's size: a counter
//    receives at most one atomic per warp window;
//  - rs_scan_kernel, one block, turns the counts into each key's first
//    place (an exclusive scan, in key order, a tile of 4,096 keys at a
//    time);
//  - rs_pass_kernel<Key, true> walks the batch the same way and writes each
//    item and its key at its key's next place (one atomic per group on
//    the key's cursor), so the sorted array holds each key's items in one
//    segment, keys ascending;
//  - the caller's walk then gives each warp kRsChunk consecutive places:
//    it sums its items' contributions to one row in registers or shared
//    memory while the key stays the same, and sends the sum to the row
//    when the key changes and at the end of its chunk.  A row receives at
//    most ceil(segment / kRsChunk) + 1 atomics per element, however hot.
#pragma once

#include "robe_common.cuh"

namespace {

constexpr unsigned kRsNone = 0xFFFFFFFFu;
constexpr unsigned kRsFull = 0xFFFFFFFFu;
constexpr int kRsThreads = 256;       // threads of a block of the passes
constexpr int kRsScanThreads = 1024;  // the scan's one block
constexpr int kRsMaxBlocks = 4096;    // blocks of a pass at most
constexpr int kRsChunk = 128;         // sorted places a warp of a walk takes

// The scratch of one sort: a count (then a cursor) for every key, and the
// sorted (item, key) pairs.
struct RowSort {
  int* cnt;
  uint2* sorted;
};

static inline size_t rs_align(size_t n) { return (n + 255) & ~(size_t)255; }

// Bytes of scratch a sort of n_items items over n_keys keys needs
// (kernels/_build.py's row_sort_bytes mirrors it).
static inline size_t rs_scratch_bytes(long long n_keys, long long n_items) {
  return rs_align(4 * (size_t)n_keys) + rs_align(8 * (size_t)n_items);
}

static inline RowSort rs_carve(void* base, long long n_keys) {
  char* c = static_cast<char*>(base);
  RowSort w;
  w.cnt = reinterpret_cast<int*>(c);
  w.sorted = reinterpret_cast<uint2*>(c + rs_align(4 * (size_t)n_keys));
  return w;
}

// The item at column-major place t: sample t % batch of field t / batch.
__device__ __forceinline__ int rs_item(long long t, int batch,
                                       int n_fields) {
  const int f = (int)(t / batch);
  const int b = (int)(t - (long long)f * batch);
  return b * n_fields + f;
}

// The count (kPlace = false) or place (kPlace = true) pass over n_items =
// batch * n_fields items; key(item) gives an item's key, below the number
// of keys.
template <class Key, bool kPlace>
__global__ void __launch_bounds__(kRsThreads)
    rs_pass_kernel(const Key key, int n_items, int batch, int n_fields,
                   RowSort w) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kRsThreads / 32);
  for (long long base = ((long long)blockIdx.x * (kRsThreads / 32) +
                         (threadIdx.x >> 5)) * 32;
       base < n_items; base += warps * 32) {
    const long long t = base + lane;
    const bool ok = t < n_items;
    int item = 0;
    unsigned k = kRsNone;
    if (ok) {
      item = rs_item(t, batch, n_fields);
      k = key(item);
    }
    const unsigned peers = __match_any_sync(kRsFull, k);
    const int leader = __ffs(peers) - 1;
    if (!kPlace) {
      if (ok && lane == leader) atomicAdd(w.cnt + k, __popc(peers));
    } else {
      int at = 0;
      if (ok && lane == leader) at = atomicAdd(w.cnt + k, __popc(peers));
      at = __shfl_sync(kRsFull, at, leader);
      if (ok)
        w.sorted[at + __popc(peers & ((1u << lane) - 1u))] =
            make_uint2((unsigned)item, k);
    }
  }
}

// cnt[0, n) -> its exclusive scan, in place, by one block, in tiles of
// 4 * kRsScanThreads keys: each thread scans four consecutive counts, the
// block its threads' sums, and a carry runs from tile to tile.
__global__ void __launch_bounds__(kRsScanThreads)
    rs_scan_kernel(int* cnt, int n) {
  __shared__ int warp_tot[kRsScanThreads / 32];
  __shared__ int tile_tot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int t0 = 0; t0 < n; t0 += 4 * kRsScanThreads) {
    const int base = t0 + 4 * tid;
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = base + u < n ? cnt[base + u] : 0;
    const int sum = v[0] + v[1] + v[2] + v[3];
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kRsFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_tot[lane];
      int s = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kRsFull, s, o);
        if (lane >= o) s += y;
      }
      warp_tot[lane] = s - w;
      if (lane == 31) tile_tot = s;
    }
    __syncthreads();
    int run = carry + warp_tot[warp] + x - sum;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (base + u < n) cnt[base + u] = run;
      run += v[u];
    }
    carry += tile_tot;
    __syncthreads();   // warp_tot and tile_tot are free again
  }
}

// Sort the n_items = batch * n_fields items by key into w (n_keys keys).
template <class Key>
static inline int rs_sort(const Key& key, int n_items, int batch,
                          int n_fields, long long n_keys, RowSort w,
                          cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(w.cnt, 0, 4 * (size_t)n_keys, st);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)n_items + kRsThreads - 1) / kRsThreads;
  const int grid = (int)(need < kRsMaxBlocks ? need : kRsMaxBlocks);
  rs_pass_kernel<Key, false><<<grid, kRsThreads, 0, st>>>(
      key, n_items, batch, n_fields, w);
  rs_scan_kernel<<<1, kRsScanThreads, 0, st>>>(w.cnt, (int)n_keys);
  rs_pass_kernel<Key, true><<<grid, kRsThreads, 0, st>>>(
      key, n_items, batch, n_fields, w);
  return (int)cudaGetLastError();
}

// out[i] = the f32 workspace rounded once into bf16.
__global__ void rs_round_kernel(const float* __restrict__ ws,
                                __nv_bfloat16* __restrict__ out,
                                long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(ws[i]);
}

static inline int rs_round(const float* ws, void* out, long long n,
                           cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  rs_round_kernel<<<(int)(blocks < 65535 * 8 ? blocks : 65535 * 8), 256, 0,
                    st>>>(ws, static_cast<__nv_bfloat16*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace
