// One-pass serve kernel: ROBE hash and gather for every field, -1-padded
// bag pooling, and the dot-interaction triangle of [bot; pooled] -- the
// whole sparse half of a DLRM score, [B, F(, bag)] ids + bot [B, d] ->
// [B, (F+1)F/2] in bot's dtype.
//
// Replaces: src/repro/kernels/serve_fused.py, serve_fused_pallas (body
// _kernel).
//
// Bound on an H100: bytes.  A sample reads F*bag ids, d bot values and
// F*bag*d slots of M (26.1M f32 slots at full width, beyond the 50 MB L2),
// and writes (F+1)F/2 values; the gram is about 6 FLOP per byte read.
// What held the first version back was the hash and the gather, not the
// gram: every element computed a slot hash ending in a division, and each
// lane had one gather in flight.  Measured now on an NVIDIA H100 80GB HBM3
// at 700 W (tools/kernel_split.py): 2.97 ms at B=262,144; the hash, gather
// and pool alone take 1.70 ms, and the gram adds 1.27 ms, because its
// shared-memory reads and the gathers share the SM's load/store pipe; with
// the sign, its per-element hash adds 1.83 ms.
//
// Design: one warp per block, walking samples blockIdx.x, + gridDim.x, ...
// (the launcher sizes the grid to the blocks that fit on the card, or to B
// if smaller).  Per sample the warp builds [bot; pooled] in shared-memory
// rows laid out for the register-tiled gram of gram.cuh:
//  - The slot hash runs once per ROBE block, not once per element: for each
//    chunk of fields the lanes hash the blocks each row spans -- at Z=32,
//    d=128 four, five when a row starts inside a block -- into a shared
//    table, and an element's slot is its block's hash plus its offset in
//    the block, wrapped once, in 32-bit arithmetic (robe_chunk_* in
//    robe_common.cuh, shared with robe_lookup.cu).  The `% |M|` of that
//    hash is two multiplies (robe_common.cuh).
//  - The first bag entry of an f32 array lands by cp.async, straight into
//    the rows (bot too, when f32), and the warp starts on it at once; the
//    sign, when the spec has one, is applied in place once it lands.  -1
//    pads write zeros (the Pallas kernel hashes them as id 0 and zeroes
//    them).
//  - Further bag entries, and a bf16 array, gather through registers,
//    eight fields' loads in flight before any is used, summed in f32 into
//    the rows.
//  - Each pooled value is rounded once to bot's dtype; then the gram.
// One row buffer per warp: the gathers of one warp's sample overlap the
// other resident warps' grams (at full width 13 warps per SM, 16.0 KB of
// shared memory a warp, 80 registers a thread; two buffers per warp, 7 warps,
// were slower in trials on the card), and the next sample's ids load a
// sample ahead.  The [B, F, d] embeddings never reach device memory, and M
// is read where it is used, with no chunk size to depend on.
#include "gram.cuh"

namespace {

constexpr int kGroup = 8;  // fields gathered through registers together

struct Warp {
  const RobeParams& p;
  unsigned int* hashes;
  int chunk, nblk, lane;

  // Hash the blocks of elements e0 .. e0+127 of fields f0 .. f1-1 (ids of
  // one bag entry in `ids`) into the table; pads are skipped.
  __device__ __forceinline__ void fill(const int* ids, int f0, int f1,
                                       int e0) const {
    __syncwarp();  // the previous fill is used
    for (int q = lane; q < (f1 - f0) * nblk; q += 32) {
      const int fl = q / nblk, x = ids[f0 + fl];
      if (x < 0) continue;
      hashes[q] = robe_chunk_hash(p, p.tids[f0 + fl], x, e0, q - fl * nblk);
    }
    __syncwarp();
  }

  // Slot of element e0 + e of row x of field f (f0 <= f < f1, table
  // filled), e < 128.
  __device__ __forceinline__ unsigned int slot(int x, int f, int f0, int e0,
                                               int e) const {
    return robe_chunk_slot(p, hashes + (f - f0) * nblk, x, e0, e);
  }
};

template <typename TM, typename TB>
__global__ void __launch_bounds__(32)
    serve_fused_kernel(const TM* __restrict__ mem,
                       const int* __restrict__ idx,
                       const TB* __restrict__ bot, TB* __restrict__ out,
                       int batch, int bag, const RobeParams p,
                       const GramLayout L, int table) {
  extern __shared__ float4 smem4[];
  const int f_all = p.n_fields, dim = p.dim;
  float* rows = reinterpret_cast<float*>(smem4);
  unsigned int* hashes =
      reinterpret_cast<unsigned int*>(rows + L.rows_floats);
  int* ids = reinterpret_cast<int*>(hashes + table);
  TB* stage = reinterpret_cast<TB*>(ids + ((f_all + 3) & ~3));
  const int nblk = robe_chunk_blocks(dim, p.log2_z);
  const Warp w{p, hashes, table / nblk, nblk, (int)threadIdx.x};
  const int lane = w.lane, n_pairs = gram_pairs(f_all + 1, 0);
  constexpr bool async = sizeof(TM) == sizeof(float);
  // the padding (columns dim..4*w4) is zeroed once; nothing else writes it
  for (int e = lane; e < L.rows_floats; e += 32) rows[e] = 0.f;
  __syncwarp();

  // Start sample s, its entry-0 ids in `ids`: bot, and (f32 array) the
  // asynchronous gathers of entry 0.
  auto start = [&](int s) {
    const TB* bs = bot + (long long)s * dim;
    for (int e = lane; e < dim; e += 32) {
      if constexpr (sizeof(TB) == sizeof(float))
        cp_async4(rows + e, reinterpret_cast<const float*>(bs) + e);
      else
        rows[e] = to_f32(bs[e]);
    }
    if constexpr (async) {
      for (int e0 = 0; e0 < dim; e0 += 128)
        for (int f0 = 0; f0 < f_all; f0 += w.chunk) {
          const int f1 = min(f0 + w.chunk, f_all);
          w.fill(ids, f0, f1, e0);
          for (int f = f0; f < f1; ++f) {
            float* row = rows + gram_row(L.w4, 1 + f) + e0;
            const int x = ids[f];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = lane + 32 * i;
              if (e0 + e >= dim) break;
              if (x < 0)
                row[e] = 0.f;
              else
                cp_async4(row + e, reinterpret_cast<const float*>(mem) +
                                       w.slot(x, f, f0, e0, e));
            }
          }
        }
    }
    cp_async_commit();
  };

  // Finish sample s once entry 0 has landed: its signs, the other bag
  // entries (all of them, for a bf16 array), the rounding.
  auto finish = [&](int s) {
    const int* ib = idx + (long long)s * f_all * bag;
    if (async && p.use_sign)
      for (int f = 0; f < f_all; ++f) {
        const int x = ids[f];
        if (x < 0) continue;
        float* row = rows + gram_row(L.w4, 1 + f);
        const unsigned long long k0 =
            (unsigned long long)(unsigned int)x * (unsigned)dim;
        for (int e = lane; e < dim; e += 32)
          row[e] *= robe_sign(p, p.tids[f], k0 + e);
      }
    for (int j = async ? 1 : 0; j < bag; ++j) {
      __syncwarp();  // the previous entry's ids are used
      for (int f = lane; f < f_all; f += 32) ids[f] = ib[f * bag + j];
      for (int e0 = 0; e0 < dim; e0 += 128)
        for (int f0 = 0; f0 < f_all; f0 += w.chunk) {
          const int f1 = min(f0 + w.chunk, f_all);
          w.fill(ids, f0, f1, e0);
          for (int g = f0; g < f1; g += kGroup) {
            // every load of the group before any use; a masked element
            // reads slot 0 and is dropped
            TM raw[kGroup][4];
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              const int f = g + u, x = f < f1 ? ids[f] : -1;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int e = lane + 32 * i;
                raw[u][i] = mem[x >= 0 && e0 + e < dim
                                    ? w.slot(x, f, f0, e0, e)
                                    : 0u];
              }
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              const int f = g + u;
              if (f >= f1) break;
              const int x = ids[f];
              float* row = rows + gram_row(L.w4, 1 + f) + e0;
              const unsigned long long k0 =
                  (unsigned long long)(unsigned int)(x < 0 ? 0 : x) *
                      (unsigned)dim + e0;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int e = lane + 32 * i;
                if (e0 + e >= dim) continue;
                float m = x < 0 ? 0.f : to_f32(raw[u][i]);
                if (x >= 0 && p.use_sign) m *= robe_sign(p, p.tids[f], k0 + e);
                row[e] = j == 0 ? m : row[e] + m;  // entry 0 stores
              }
            }
          }
        }
    }
    // the single rounding: pooled values enter the gram in bot's dtype
    if constexpr (sizeof(TB) < sizeof(float))
      for (int e = lane; e < dim; e += 32)
        for (int f = 0; f < f_all; ++f) {
          float* x = rows + gram_row(L.w4, 1 + f) + e;
          *x = to_f32(from_f32<TB>(*x));
        }
    __syncwarp();
  };

  // entry-0 ids of the warp's next sample, loaded a sample ahead
  constexpr int kIds = (ROBE_MAX_FIELDS + 31) / 32;
  int next_ids[kIds];
  auto load_ids = [&](int s) {
#pragma unroll
    for (int q = 0; q < kIds; ++q) {
      const int f = lane + 32 * q;
      next_ids[q] = s < batch && f < f_all
                        ? idx[((long long)s * f_all + f) * bag]
                        : -1;
    }
  };
  load_ids(blockIdx.x);
  for (int s = blockIdx.x; s < batch; s += gridDim.x) {
#pragma unroll
    for (int q = 0; q < kIds; ++q)
      if (lane + 32 * q < f_all) ids[lane + 32 * q] = next_ids[q];
    start(s);
    load_ids(s + gridDim.x);  // in flight behind this sample's work
    cp_async_wait<0>();
    __syncwarp();
    finish(s);
    gram_warp<TB>(rows, L, stage, out + (long long)s * n_pairs, lane);
  }
}

template <typename TM, typename TB>
int launch(const void* mem, const void* idx, const void* bot, void* out,
           int batch, int bag, const RobeParams& p, cudaStream_t stream) {
  GramLayout L = gram_layout(p.n_fields + 1, p.dim, 0);
  const size_t rows = sizeof(float) * (size_t)L.rows_floats;
  const size_t ids = sizeof(int) * ((p.n_fields + 3) & ~3);
  // the block hashes of up to 32 fields per table fill, or when shared
  // memory is tight of one; a multiple of four entries, as is the id
  // buffer, so the stage after them stays 16-byte aligned
  const int nblk = robe_chunk_blocks(p.dim, p.log2_z);
  int table = (nblk * (p.n_fields < 32 ? p.n_fields : 32) + 3) & ~3;
  if (rows + ids + sizeof(unsigned) * table +
          gram_stage_bytes<TB>(L.stage) > kSmemLimit)
    table = (nblk + 3) & ~3;
  const size_t fixed = rows + ids + sizeof(unsigned) * table;
  if (!gram_fit_stage<TB>(&L, fixed)) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + gram_stage_bytes<TB>(L.stage);
  auto kernel = serve_fused_kernel<TM, TB>;
  cudaError_t err = robe_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  if ((err = robe_resident_grid(kernel, 32, smem, batch, &grid)) !=
      cudaSuccess)
    return (int)err;
  kernel<<<grid, 32, smem, stream>>>(
      static_cast<const TM*>(mem), static_cast<const int*>(idx),
      static_cast<const TB*>(bot), static_cast<TB*>(out), batch, bag, p, L,
      table);
  return (int)cudaGetLastError();
}

}  // namespace

// mem [|M|] (mem_dtype 0 = f32, 1 = bf16), idx [batch, n_fields, bag] int32
// (-1 = pad), bot [batch, dim] (bot_dtype 0 = f32, 1 = bf16) -> out
// [batch, (n_fields+1) n_fields / 2] in bot's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int serve_fused_launch(const void* mem, const void* idx,
                                  const void* bot, void* out, int batch,
                                  int bag, int mem_dtype, int bot_dtype,
                                  const unsigned long long* coeffs,
                                  const unsigned int* tids, int n_fields,
                                  int dim, int log2_z, int use_sign,
                                  void* stream) {
  RobeParams p;
  int err = robe_make_params(&p, coeffs, tids, n_fields, dim, log2_z,
                             use_sign);
  if (err) return err;
  if (mem_dtype < 0 || mem_dtype > 1 || bot_dtype < 0 || bot_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (mem_dtype * 2 + bot_dtype) {
    case 0: return launch<float, float>(mem, idx, bot, out, batch, bag, p, s);
    case 1: return launch<float, bf16>(mem, idx, bot, out, batch, bag, p, s);
    case 2: return launch<bf16, float>(mem, idx, bot, out, batch, bag, p, s);
    case 3: return launch<bf16, bf16>(mem, idx, bot, out, batch, bag, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
