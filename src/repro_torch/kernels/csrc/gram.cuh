// The gram epilogue of dot_interaction.cu and serve_fused.cu: one warp
// computes the lower triangle of the gram matrix of n rows of width dim
// held in shared memory as f32, in np.tril_indices order, accumulated in
// f32 and rounded once to the output type.
//
// Register tiling.  The rows are taken in blocks of four; lane t owns one
// 4 x 4 tile (I, J), J <= I, of the block triangle.  Per step of four
// columns it loads its 4 + 4 rows as float4 (8 LDS.128) and does 64 FMAs,
// so each float read from shared memory feeds 2 FMAs (a warp reading two
// rows per pair fed 0.5).  At n = 27 the 7 row blocks give 28 tiles: one
// warp, one pass, 4 lanes idle.  Tiles that straddle the diagonal compute a
// few products that are never written; rows past n read row n - 1.
//
// Bank layout.  Row R starts at R * 4*w4 + 4 * (R >> 2) floats: rows are
// 4*w4 floats (the width rounded up to a float4, zero beyond dim) and each
// block of four rows is skewed by one float4 more.  The eight lanes of a
// quarter-warp read rows 4I + r of different I at the same column; their
// 16-byte units fall at I * (4*w4 + 1) + const (mod 8), and 4*w4 + 1 is
// odd, so eight consecutive I hit eight distinct bank groups whatever dim.
//
// Stores.  Block rows are grouped while a group has at most 32 tiles; a
// group's pairs are one contiguous run of the output (rows 4*I0 .. 4*I1-1).
// A larger block row (n > 128) is one group taken 32 tiles at a time, each
// pass giving four row segments.  Each run goes through a shared-memory
// stage laid out at the output's address modulo 16 bytes, and the warp
// writes it with 16-byte stores (scalar at the two ragged ends), so the
// tile-to-pair scatter stays on chip.  The stage holds `stage` elements; a
// run longer than that is written in windows.
//
// f32 on the SIMT units, not the tensor cores: the kernels that use it are
// bound by bytes (about 6 FLOP per byte read at F = 27, d = 128), and plain
// TF32 misses the 1e-5 bar.
#pragma once

#include <stdint.h>

#include "robe_common.cuh"

#define GRAM_PASS 32  // tiles per pass: one per lane

struct GramLayout {
  int n, dim, self;
  int nb;           // blocks of four rows
  int w4;           // float4 steps per row
  int rows_floats;  // one sample's rows, a multiple of 4 floats
  int stage;        // stage window in output elements
};

// Pairs of the triangle of n rows; also the first pair of row n: pair
// (i, j) is gram_pairs(i, self) + j, j < i + self.
__host__ __device__ __forceinline__ int gram_pairs(int n, int self) {
  return self ? n * (n + 1) / 2 : n * (n - 1) / 2;
}

__host__ __device__ __forceinline__ int gram_row(int w4, int r) {
  return r * 4 * w4 + 4 * (r >> 2);
}

// End of the group of block rows that starts at I0: block rows are added
// while the group has at most GRAM_PASS tiles; a block row of more tiles is
// a group alone.
__host__ __device__ __forceinline__ int gram_group_end(int I0, int nb) {
  int I1 = I0 + 1, tiles = I0 + 1;
  while (I1 < nb && tiles + I1 + 1 <= GRAM_PASS) tiles += ++I1;
  return I1;
}

// The longest contiguous run a pass produces: what a stage must hold to
// write every run in one window.
static inline int gram_max_run(int n, int self) {
  const int nb = (n + 3) / 4;
  int best = 1;
  for (int I0 = 0; I0 < nb;) {
    const int I1 = gram_group_end(I0, nb);
    const int hi = 4 * I1 < n ? 4 * I1 : n;
    const int run = I0 + 1 > GRAM_PASS
                        ? 4 * GRAM_PASS
                        : gram_pairs(hi, self) - gram_pairs(4 * I0, self);
    if (run > best) best = run;
    I0 = I1;
  }
  return best;
}

static inline GramLayout gram_layout(int n, int dim, int self) {
  GramLayout L;
  L.n = n;
  L.dim = dim;
  L.self = self;
  L.nb = (n + 3) / 4;
  L.w4 = (dim + 3) / 4;
  L.rows_floats = gram_row(L.w4, n - 1) + 4 * L.w4;
  L.stage = gram_max_run(n, self);
  return L;
}

// Bytes of a stage of `elems` output elements: room for the shift that
// aligns it with the output modulo 16 bytes.
template <typename TO>
__host__ __device__ __forceinline__ int gram_stage_bytes(int elems) {
  return (elems + 16 / (int)sizeof(TO) - 1) * (int)sizeof(TO);
}

// Shrink L->stage so that `fixed` bytes and the stage fit in kSmemLimit
// (longer runs are then written in windows); false if one element does not.
template <typename TO>
static inline bool gram_fit_stage(GramLayout* L, size_t fixed) {
  if (fixed + gram_stage_bytes<TO>(1) > kSmemLimit) return false;
  const int most = (int)((kSmemLimit - fixed) / sizeof(TO)) -
                   (16 / (int)sizeof(TO) - 1);
  if (most < L->stage) L->stage = most;
  return true;
}

// Write src[0, len) to dst[0, len) with the warp; src and dst agree modulo
// 16 bytes, so the middle goes as 16-byte stores.
template <typename TO>
__device__ __forceinline__ void gram_warp_store(TO* __restrict__ dst,
                                                const TO* src, int len,
                                                int lane) {
  constexpr int V = 16 / sizeof(TO);
  int head = (int)((16 - ((uintptr_t)dst & 15)) & 15) / (int)sizeof(TO);
  head = head < len ? head : len;
  if (lane < head) dst[lane] = src[lane];
  const int nv = (len - head) / V;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int v = lane; v < nv; v += 32) d4[v] = s4[v];
  const int done = head + nv * V;
  if (lane < len - done) dst[done + lane] = src[done + lane];
}

// out[p] for every pair p of the triangle of the rows at `rows` (laid out
// by gram_row, zero from dim to 4*w4), by one warp.  `stage` is 16-byte
// aligned and holds gram_stage_bytes<TO>(L.stage) bytes.  Ends with
// __syncwarp, so the caller may then overwrite the rows.
template <typename TO>
__device__ __forceinline__ void gram_warp(const float* rows,
                                          const GramLayout& L, TO* stage,
                                          TO* __restrict__ out, int lane) {
  for (int I0 = 0; I0 < L.nb;) {
    const int I1 = gram_group_end(I0, L.nb);
    const int tiles = gram_pairs(I1, 1) - gram_pairs(I0, 1);
    for (int t0 = 0; t0 < tiles; t0 += GRAM_PASS) {
      // this lane's tile (I, J) of the pass
      int I = I0, J = t0 + lane;
      while (J > I) J -= ++I;
      const bool mine = t0 + lane < tiles;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      if (mine) {
        const float4* a[4];
        const float4* b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ra = min(4 * I + r, L.n - 1), rb = min(4 * J + r, L.n - 1);
          a[r] = reinterpret_cast<const float4*>(rows + gram_row(L.w4, ra));
          b[r] = reinterpret_cast<const float4*>(rows + gram_row(L.w4, rb));
        }
#pragma unroll 2
        for (int k = 0; k < L.w4; ++k) {
          float4 x[4], y[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            x[r] = a[r][k];
            y[r] = b[r][k];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[r][c] = fmaf(x[r].x, y[c].x, acc[r][c]);
              acc[r][c] = fmaf(x[r].y, y[c].y, acc[r][c]);
              acc[r][c] = fmaf(x[r].z, y[c].z, acc[r][c]);
              acc[r][c] = fmaf(x[r].w, y[c].w, acc[r][c]);
            }
        }
      }
      // the pass's output runs: the whole group's pairs, or (a block row
      // taken in several passes) one segment of each of its four rows
      const bool split = tiles > GRAM_PASS;
      const int n_runs = split ? 4 : 1;
      for (int q = 0; q < n_runs; ++q) {
        int lo, hi;
        if (split) {
          const int i = 4 * I0 + q;
          if (i >= L.n) break;
          lo = gram_pairs(i, L.self) + 4 * t0;
          hi = gram_pairs(i, L.self) + min(4 * (t0 + GRAM_PASS), i + L.self);
        } else {
          lo = gram_pairs(4 * I0, L.self);
          hi = gram_pairs(min(4 * I1, L.n), L.self);
        }
        for (int w0 = lo; w0 < hi; w0 += L.stage) {
          const int w1 = min(w0 + L.stage, hi);
          TO* dst = out + w0;
          TO* st = stage + (int)(((uintptr_t)dst & 15) / sizeof(TO));
          if (mine) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 4 * I + r;
              if (i >= L.n || (split && r != q)) continue;
              const int base = gram_pairs(i, L.self);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int p = base + 4 * J + c;
                if (4 * J + c < i + L.self && p >= w0 && p < w1)
                  st[p - w0] = from_f32<TO>(acc[r][c]);
              }
            }
          }
          __syncwarp();
          gram_warp_store<TO>(dst, st, w1 - w0, lane);
          __syncwarp();
        }
      }
    }
    I0 = I1;
  }
}
