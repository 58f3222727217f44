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
//  - rs_scan_kernel turns the counts into each key's first place (an
//    exclusive scan, in key order, in tiles of kRsTile = 4,096 keys): one
//    block walks the tiles one after another where there is one tile;
//    otherwise rs_tile_sum_kernel sums every tile, one block a tile, one
//    block scans the tiles' sums, and a block a tile scans its tile from
//    its sum's place (the QR backward's 212,992 R rows are 52 tiles);
//  - rs_pass_kernel<Key, true> walks the batch the same way and writes each
//    item and its key at its key's next place (one atomic per group on
//    the key's cursor), so the sorted array holds each key's items in one
//    segment, keys ascending;
//  - the caller's walk then gives each warp (or each group of a warp's
//    lanes) a chunk of consecutive places: it sums its items'
//    contributions to one row in registers while the key stays the same,
//    and sends the sum to the row when the key changes and at the end of
//    its chunk.  A row receives at most ceil(segment / chunk) + 1 atomics
//    per element, however hot.
#pragma once

#include "robe_common.cuh"

namespace {

constexpr unsigned kRsNone = 0xFFFFFFFFu;
constexpr unsigned kRsFull = 0xFFFFFFFFu;
constexpr int kRsThreads = 256;       // threads of a block of the passes
constexpr int kRsScanThreads = 1024;  // the scan's one block
constexpr int kRsMaxBlocks = 4096;    // blocks of a pass at most
constexpr int kRsChunk = 128;         // sorted places a warp of a walk takes
constexpr int kRsTile = 4 * kRsScanThreads;   // keys of a tile of the scan

// The scratch of one sort: a count (then a cursor) for every key, a sum
// (then a first place) for every tile of the scan, and the sorted (item,
// key) pairs.
struct RowSort {
  int* cnt;
  int* tiles;
  uint2* sorted;
};

static inline size_t rs_align(size_t n) { return (n + 255) & ~(size_t)255; }

static inline long long rs_tiles(long long n_keys) {
  return (n_keys + kRsTile - 1) / kRsTile;
}

// Bytes of scratch a sort of n_items items over n_keys keys needs
// (kernels/_build.py's row_sort_bytes mirrors it).
static inline size_t rs_scratch_bytes(long long n_keys, long long n_items) {
  return rs_align(4 * (size_t)n_keys) +
         rs_align(4 * (size_t)rs_tiles(n_keys)) +
         rs_align(8 * (size_t)n_items);
}

static inline RowSort rs_carve(void* base, long long n_keys) {
  char* c = static_cast<char*>(base);
  const size_t at = rs_align(4 * (size_t)n_keys);
  RowSort w;
  w.cnt = reinterpret_cast<int*>(c);
  w.tiles = reinterpret_cast<int*>(c + at);
  w.sorted = reinterpret_cast<uint2*>(
      c + at + rs_align(4 * (size_t)rs_tiles(n_keys)));
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

// The block's threads' sum of v (every thread gets it); red: kRsScanThreads
// / 32 ints of shared memory.
__device__ __forceinline__ int rs_block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kRsFull, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kRsFull, v, o);
  __syncthreads();   // red is free again
  return v;
}

// tiles[t] = the sum of cnt over tile t, one block a tile.
__global__ void __launch_bounds__(kRsScanThreads)
    rs_tile_sum_kernel(const int* __restrict__ cnt, int n,
                       int* __restrict__ tiles) {
  __shared__ int red[kRsScanThreads / 32];
  const int base = blockIdx.x * kRsTile + 4 * threadIdx.x;
  int v = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) v += base + u < n ? cnt[base + u] : 0;
  v = rs_block_sum(v, red);
  if (threadIdx.x == 0) tiles[blockIdx.x] = v;
}

// cnt[0, n) -> its exclusive scan, in place, in tiles of kRsTile keys:
// each thread scans four consecutive counts, the block its threads' sums.
// With first == nullptr one block walks every tile, a carry running from
// tile to tile; otherwise block t scans tile t from first[t].
__global__ void __launch_bounds__(kRsScanThreads)
    rs_scan_kernel(int* cnt, int n, const int* __restrict__ first) {
  __shared__ int warp_tot[kRsScanThreads / 32];
  __shared__ int tile_tot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = first ? first[blockIdx.x] : 0;
  const int t_end = first ? min(n, (blockIdx.x + 1) * kRsTile) : n;
  for (int t0 = first ? blockIdx.x * kRsTile : 0; t0 < t_end;
       t0 += kRsTile) {
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
  const long long tiles = rs_tiles(n_keys);
  if (tiles == 1) {
    rs_scan_kernel<<<1, kRsScanThreads, 0, st>>>(w.cnt, (int)n_keys, nullptr);
  } else {
    rs_tile_sum_kernel<<<(int)tiles, kRsScanThreads, 0, st>>>(
        w.cnt, (int)n_keys, w.tiles);
    rs_scan_kernel<<<1, kRsScanThreads, 0, st>>>(w.tiles, (int)tiles,
                                                 nullptr);
    rs_scan_kernel<<<(int)tiles, kRsScanThreads, 0, st>>>(
        w.cnt, (int)n_keys, w.tiles);
  }
  rs_pass_kernel<Key, true><<<grid, kRsThreads, 0, st>>>(
      key, n_items, batch, n_fields, w);
  return (int)cudaGetLastError();
}

// Sorting (item, segment) pairs (qrobe_lookup_bwd.cu): an item spans up to
// n_seg segments, each with a key of its own.  The same walk, count, scan
// and place as above, a segment j at a time; each pair is written as the
// 4-byte index j * n_items + item.  Key gives key.item(item, field), an
// item's state, then key.seg(state, j), the key of its segment j or
// kRsNone for a segment the item does not reach (neither counted nor
// placed).
template <class Key, bool kPlace>
__global__ void __launch_bounds__(kRsThreads)
    rs_seg_pass_kernel(const Key key, int n_items, int batch, int n_fields,
                       int n_seg, int* __restrict__ cnt,
                       unsigned* __restrict__ sorted) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kRsThreads / 32);
  for (long long base = ((long long)blockIdx.x * (kRsThreads / 32) +
                         (threadIdx.x >> 5)) * 32;
       base < n_items; base += warps * 32) {
    const long long t = base + lane;
    const bool ok = t < n_items;
    int item = 0;
    typename Key::Item it{};
    if (ok) {
      const int f = (int)(t / batch);
      item = (int)(t - (long long)f * batch) * n_fields + f;
      it = key.item(item, f);
    }
    for (int j = 0; j < n_seg; ++j) {
      const unsigned k = ok ? key.seg(it, j) : kRsNone;
      const unsigned peers = __match_any_sync(kRsFull, k);
      const int leader = __ffs(peers) - 1;
      if (!kPlace) {
        if (k != kRsNone && lane == leader) atomicAdd(cnt + k, __popc(peers));
      } else {
        int at = 0;
        if (k != kRsNone && lane == leader)
          at = atomicAdd(cnt + k, __popc(peers));
        at = __shfl_sync(kRsFull, at, leader);
        if (k != kRsNone)
          sorted[at + __popc(peers & ((1u << lane) - 1u))] =
              (unsigned)j * (unsigned)n_items + (unsigned)item;
      }
    }
  }
}

// Sort the (item, segment) pairs of n_items = batch * n_fields items by
// key (n_keys keys): cnt [n_keys] ends as each key's end, tiles holds
// rs_tiles(n_keys) ints, sorted a place a pair.
template <class Key>
static inline int rs_seg_sort(const Key& key, int n_items, int batch,
                              int n_fields, int n_seg, long long n_keys,
                              int* cnt, int* tiles, unsigned* sorted,
                              cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(cnt, 0, 4 * (size_t)n_keys, st);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)n_items + kRsThreads - 1) / kRsThreads;
  const int grid = (int)(need < kRsMaxBlocks ? need : kRsMaxBlocks);
  rs_seg_pass_kernel<Key, false><<<grid, kRsThreads, 0, st>>>(
      key, n_items, batch, n_fields, n_seg, cnt, sorted);
  const long long n_tiles = rs_tiles(n_keys);
  if (n_tiles == 1) {
    rs_scan_kernel<<<1, kRsScanThreads, 0, st>>>(cnt, (int)n_keys, nullptr);
  } else {
    rs_tile_sum_kernel<<<(int)n_tiles, kRsScanThreads, 0, st>>>(
        cnt, (int)n_keys, tiles);
    rs_scan_kernel<<<1, kRsScanThreads, 0, st>>>(tiles, (int)n_tiles,
                                                 nullptr);
    rs_scan_kernel<<<(int)n_tiles, kRsScanThreads, 0, st>>>(
        cnt, (int)n_keys, tiles);
  }
  rs_seg_pass_kernel<Key, true><<<grid, kRsThreads, 0, st>>>(
      key, n_items, batch, n_fields, n_seg, cnt, sorted);
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
