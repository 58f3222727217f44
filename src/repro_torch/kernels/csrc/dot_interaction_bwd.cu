// Backward of the DLRM dot interaction: g [B, P], the cotangent of the gram
// triangle (P = F(F-1)/2, or F(F+1)/2 with the diagonal, in np.tril_indices
// order), and feats [B, F, D] -> dfeats [B, F, D] = sym(g) . feats per
// sample, where sym puts g_ij at (i, j) and (j, i) and, with the diagonal,
// 2 g_ii at (i, i).  Accumulated in f32 and rounded once into feats' dtype.
//
// Replaces: src/repro/kernels/ops.py:159, _dot_bwd (the custom-VJP backward
// of dot_interaction: a symmetric scatter of the triangle, then one
// contraction; the TPU kernel dot_interaction_pallas has no backward of
// its own).
//
// Bound on an H100: bytes.  At F=27, D=128 a sample reads 13.8 KB of feats
// and 1.4 KB of g and writes 13.8 KB for 2*27*27*128 = 187 kFLOP, about 6
// FLOP per byte, below the card's f32 ratio of 67 TFLOP/s over 3.35 TB/s.
// A first design lost to latency and instructions, not bytes: it staged
// a sample at a time with scalar loads and nothing in flight behind it,
// rebuilt sym with a division per entry, and fed 4 FMAs per two
// shared-memory loads.
//
// Design: persistent blocks (as many as fit on the card) walk units of
// work, a unit being one sample's window of R output rows by W columns
// (one unit a sample at F=27, D=128: R=28, W=128; smaller windows only
// where a sample's tiles would not fit in shared memory).
//  - Two stages: while a unit computes, the next unit's g row and feats
//    window are in flight by cp.async into the other stage, 16-byte copies
//    where rows are 16-byte aligned, 4-byte copies otherwise (bf16 rows off
//    a 4-byte boundary are copied from the word below, their shift kept).
//    g is read at its row stride: autograd hands over a view of the top
//    MLP's input.  bf16 is widened to f32 through registers into a compute
//    buffer once the stage has landed.
//  - sym without divisions: the map from sym's (j, i) to g's index depends
//    only on (F, self), so each block builds it once in shared memory,
//    16-bit entries (0xFFFF for zero, bit 15 for the doubled diagonal), and
//    each unit gathers its [F][R] slice of sym from the staged g row.
//  - A thread owns a 4 x 4 register tile (rows i0..i0+3, columns
//    d0..d0+3): per j one float4 of sym (row j of the symmetric sym holds
//    column j) and one float4 of feats, 16 FMAs per two LDS.128 (the
//    first design: 4).
//    All lanes read the same row j at once: sym as a broadcast (a warp
//    spans one or a few row groups), feats as consecutive float4s of one
//    row, free of bank conflicts without a skew.
//  - Outputs leave as 16-byte (f32) or 8-byte (bf16, four values) stores
//    where D is a multiple of four, scalar otherwise.
// The accumulation stays in f32 on the SIMT units: plain TF32 misses the
// 1e-5 bar.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py and
// tools/kernel_split.py): 0.688 ms at B=65,536, F=27, D=128 against the
// 0.568 ms byte bound, torch.bmm(sym, feats) 0.792 and the first
// design's 1.12.  With the contraction skipped it takes 0.678: staging
// the bytes is what bounds it now.  A third stage was no faster (0.699 against
// 0.691).
#include "robe_common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // threads of a block at most
constexpr int kMaxWin = 128;      // columns of a window at most
constexpr int kRows = 4;          // a thread's tile: kRows x 4 columns
constexpr int kMaxStages = 2;     // units staged at once at most (three
                                  // were no faster on the card)
constexpr unsigned short kZero = 0xFFFF;   // map entry: sym is 0 there
constexpr unsigned short kDiag = 0x8000;   // map flag: 2 g_ii

__host__ __device__ __forceinline__ int round_up(int n, int k) {
  return (n + k - 1) / k * k;
}
__host__ __device__ __forceinline__ int pairs(int i, int self) {
  return self ? i * (i + 1) / 2 : i * (i - 1) / 2;
}

// The layout of a block, from (F, D, self, dtype); kernels/dot_interaction.py
// bwd_plan mirrors it.
struct DbPlan {
  int n, dim, self, np_, n_pairs;
  int stages;   // 2: the next unit in flight behind this one's compute;
                // 1: the next staged after it
  int rwin;     // R: output rows of a window (a multiple of 4)
  int win;      // W: columns of a window (a multiple of 8)
  int fpitch;   // elements of a staged feats row
  int threads;
  int gbytes, fbytes, cvt, sym, map;   // region sizes in bytes
  int smem;
};

static inline DbPlan plan_with(int n, int dim, int self, int tsize,
                               int stages, int rwin, int win) {
  DbPlan L;
  L.n = n;
  L.dim = dim;
  L.self = self;
  L.np_ = round_up(n, 4);
  L.n_pairs = pairs(n, self);
  L.stages = stages;
  L.rwin = rwin;
  L.win = win;
  L.fpitch = tsize == 2 ? win + 8 : win;
  L.gbytes = round_up((L.n_pairs + 8) * tsize, 16);
  L.fbytes = n * L.fpitch * tsize;
  L.cvt = tsize == 2 ? n * win * 4 : 0;
  L.sym = n * rwin * 4;
  L.map = round_up(n * L.np_ * 2, 16);
  L.smem = stages * (L.gbytes + L.fbytes) + L.cvt + L.sym + L.map;
  const int tiles = rwin / kRows * (win / 4);
  L.threads = tiles < kMaxThreads ? round_up(tiles, 32) : kMaxThreads;
  return L;
}

// The largest power of two below n (at least `lo`), or 0 below `lo`.
static inline int pow2_below(int n, int lo) {
  int p = lo;
  while (2 * p < n) p *= 2;
  return p < n ? p : 0;
}

// The first layout that fits, trying two stages, then one;
// for each the widest row window (all rows, then powers of two down to 4),
// then the widest column window (D rounded up to 8 and at most 128, then
// powers of two down to 8).  smem > kSmemLimit when none does.
static inline DbPlan make_plan(int n, int dim, int self, int tsize) {
  const int w0 = round_up(dim < kMaxWin ? dim : kMaxWin, 8);
  DbPlan L = plan_with(n, dim, self, tsize, 1, 4, 8);
  for (int stages = kMaxStages; stages >= 1; --stages)
    for (int r = round_up(n, 4); r >= 4; r = pow2_below(r, 4))
      for (int w = w0; w >= 8; w = pow2_below(w, 8)) {
        const DbPlan c = plan_with(n, dim, self, tsize, stages, r, w);
        if ((size_t)c.smem <= kSmemLimit) return c;
      }
  return L;
}

// A unit of work: sample s, output rows r0.., columns c0...
struct Unit {
  int s, r0, c0;
};

// The unit after u in a block's walk: the next column window, then the
// next row window, then the block's next sample.
__device__ __forceinline__ Unit next_unit(Unit u, const DbPlan& L) {
  u.c0 += L.win;
  if (u.c0 >= L.dim) {
    u.c0 = 0;
    u.r0 += L.rwin;
    if (u.r0 >= L.n) {
      u.r0 = 0;
      u.s += gridDim.x;
    }
  }
  return u;
}

// Start copying unit (s, r0, c0)'s g row and feats window into the stage
// at `gbuf` (g's row, then the feats rows).
template <typename T>
__device__ __forceinline__ void stage_unit(const T* __restrict__ g,
                                           long long g_stride,
                                           const T* __restrict__ feats,
                                           int s, int c0, const DbPlan& L,
                                           char* gbuf, bool gvec, bool fvec) {
  constexpr int kVec = 16 / sizeof(T);
  T* fbuf = reinterpret_cast<T*>(gbuf + L.gbytes);
  const int tid = threadIdx.x, nt = blockDim.x;
  // g's row: whole 16-byte units, or the 4-byte words that cover it
  const char* gs = reinterpret_cast<const char*>(g + s * g_stride);
  if (gvec) {
    const int units = (L.n_pairs + kVec - 1) / kVec;
    for (int u = tid; u < units; u += nt)
      cp_async16(reinterpret_cast<float*>(gbuf + 16 * u),
                 reinterpret_cast<const float*>(gs + 16 * u));
  } else {
    const int shift = (int)(reinterpret_cast<uintptr_t>(gs) & 3);
    const int words = (shift + L.n_pairs * (int)sizeof(T) + 3) >> 2;
    for (int u = tid; u < words; u += nt)
      cp_async_ca<4>(gbuf + 4 * u, gs - shift + 4 * u);
  }
  // feats rows j = 0..n-1, columns c0 .. c0+cw-1, at fpitch elements
  const int cw = min(L.win, L.dim - c0);
  const T* x = feats + (long long)s * L.n * L.dim + c0;
  const int per_row = fvec ? cw / kVec : (cw * (int)sizeof(T) + 7) >> 2;
  int r = tid / per_row, c = tid - r * per_row;
  const int step_r = nt / per_row, step_c = nt - step_r * per_row;
  for (; r < L.n;) {
    const char* row = reinterpret_cast<const char*>(x + (long long)r * L.dim);
    char* dst = reinterpret_cast<char*>(fbuf + r * L.fpitch);
    if (fvec) {
      cp_async16(reinterpret_cast<float*>(dst + 16 * c),
                 reinterpret_cast<const float*>(row + 16 * c));
    } else {
      const int shift = (int)(reinterpret_cast<uintptr_t>(row) & 3);
      if (4 * c < shift + cw * (int)sizeof(T))
        cp_async_ca<4>(dst + 4 * c, row - shift + 4 * c);
    }
    c += step_c;
    r += step_r;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// acc[r][c] += sum_j sym[j][r] * feats[j][c] over the n rows j; sy and fx
// point at the tile's first column of row 0, rows rs and fs floats apart.
__device__ __forceinline__ void bwd_contract(float (&acc)[kRows][4],
                                             const float* sy, const float* fx,
                                             int n, int rs, int fs) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(sy + j * rs);
    const float4 b = *reinterpret_cast<const float4*>(fx + j * fs);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void store4(float* y, const float (&v)[4]) {
  *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* y, const float (&v)[4]) {
  uint2 u;
  u.x = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[0])) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[1])) << 16);
  u.y = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2])) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[3])) << 16);
  *reinterpret_cast<uint2*>(y) = u;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    dot_interaction_bwd_kernel(const T* __restrict__ g, long long g_stride,
                               const T* __restrict__ feats,
                               T* __restrict__ out, int batch,
                               const DbPlan L, int gvec, int fvec,
                               int ovec) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int stage_bytes = L.gbytes + L.fbytes;
  char* rest = base + L.stages * stage_bytes;
  float* cvt = reinterpret_cast<float*>(rest);
  float* sym = reinterpret_cast<float*>(rest + L.cvt);
  unsigned short* map =
      reinterpret_cast<unsigned short*>(rest + L.cvt + L.sym);
  const int tid = threadIdx.x, nt = blockDim.x, n = L.n, np = L.np_;
  const int R = L.rwin, W = L.win;

  // the map of sym's (j, i) to g's index, once a block
  {
    int j = tid / np, i = tid - j * np;
    const int sj = nt / np, si = nt - sj * np;
    for (; j < n;) {
      unsigned short e = kZero;
      if (i < n) {
        if (i != j)
          e = (unsigned short)(i > j ? pairs(i, L.self) + j
                                     : pairs(j, L.self) + i);
        else if (L.self)
          e = (unsigned short)((pairs(i, 1) + i) | kDiag);
      }
      map[j * np + i] = e;
      i += si;
      j += sj;
      if (i >= np) {
        i -= np;
        ++j;
      }
    }
  }
  // this thread's first tile of a window and the step between its tiles
  const int cgs = W / 4, tiles = R / kRows * cgs;
  const int rg0 = tid / cgs, cg0 = tid - rg0 * cgs;
  const int srg = nt / cgs, scg = nt - srg * cgs;
  // the sym slice's (j, ii) walk, and the bf16 widening's (j, c) walk
  const int sj0 = tid / R, si0 = tid - sj0 * R;
  const int ssj = nt / R, ssi = nt - ssj * R;

  // unit u computes from stage `cur`; with two stages the next unit is in
  // flight into the other one meanwhile
  Unit u{(int)blockIdx.x, 0, 0};
  int cur = 0;
  if (u.s < batch)
    stage_unit<T>(g, g_stride, feats, u.s, u.c0, L, base, gvec, fvec);
  cp_async_commit();
  for (; u.s < batch; u = next_unit(u, L)) {
    const int s = u.s, r0 = u.r0, c0 = u.c0;
    const Unit nu = next_unit(u, L);
    char* gb = base + cur * stage_bytes;
    const T* fb = reinterpret_cast<const T*>(gb + L.gbytes);
    cp_async_wait<0>();
    __syncthreads();   // this unit has landed; the last one's reads are done
    if (L.stages == 2) {
      if (nu.s < batch)
        stage_unit<T>(g, g_stride, feats, nu.s, nu.c0, L,
                      base + (cur ^ 1) * stage_bytes, gvec, fvec);
      cp_async_commit();
    }
    // sym's rows r0 .. r0+R-1 (as columns) from the staged g row
    const T* gt = reinterpret_cast<const T*>(
        gb + (gvec ? 0 : (reinterpret_cast<uintptr_t>(
                                     g + s * g_stride) & 3)));
    {
      int j = sj0, ii = si0;
      for (; j < n;) {
        const int i = r0 + ii;
        const unsigned short e = i < n ? map[j * np + i] : kZero;
        float v = 0.f;
        if (e != kZero) {
          v = to_f32(gt[e & 0x7FFF]);
          if (e & kDiag) v *= 2.f;
        }
        sym[j * R + ii] = v;
        ii += ssi;
        j += ssj;
        if (ii >= R) {
          ii -= R;
          ++j;
        }
      }
    }
    const int cw = min(W, L.dim - c0);
    const float* fx;
    if constexpr (sizeof(T) == 2) {   // widen the window into cvt
      const int per = cw;
      int j = tid / per, c = tid - j * per;
      const int sj = nt / per, sc = nt - sj * per;
      const T* x = feats + (long long)s * n * L.dim + c0;
      for (; j < n;) {
        const int shift = (int)((reinterpret_cast<uintptr_t>(
                                     x + (long long)j * L.dim) & 3) >> 1);
        cvt[j * W + c] = to_f32(fb[j * L.fpitch + shift * !fvec + c]);
        c += sc;
        j += sj;
        if (c >= per) {
          c -= per;
          ++j;
        }
      }
      fx = cvt;
    } else {
      fx = reinterpret_cast<const float*>(fb);
    }
    __syncthreads();   // sym (and the widened window) are in place
    T* y = out + (long long)s * n * L.dim + c0;
    for (int rg = rg0, cg = cg0, t = tid; t < tiles; t += nt) {
      const int i0 = r0 + kRows * rg, d0 = 4 * cg;
      if (i0 < n && d0 < cw) {
        float acc[kRows][4] = {};
        bwd_contract(acc, sym + kRows * rg, fx + d0, n, R, W);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (i0 + r >= n) break;
          T* yr = y + (long long)(i0 + r) * L.dim + d0;
          if (ovec) {
            store4(yr, acc[r]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (d0 + c < cw) yr[c] = from_f32<T>(acc[r][c]);
          }
        }
      }
      cg += scg;
      rg += srg;
      if (cg >= cgs) {
        cg -= cgs;
        ++rg;
      }
    }
    if (L.stages == 1) {
      __syncthreads();   // the one stage is free again
      if (nu.s < batch)
        stage_unit<T>(g, g_stride, feats, nu.s, nu.c0, L, base, gvec, fvec);
      cp_async_commit();
    } else {
      cur ^= 1;
    }
  }
  cp_async_wait<0>();
}

template <typename T>
int launch(const void* g, long long g_stride, const void* feats, void* out,
           int batch, int n, int dim, int self, cudaStream_t stream) {
  const DbPlan L = make_plan(n, dim, self, (int)sizeof(T));
  if ((size_t)L.smem > kSmemLimit || L.n_pairs >= 0x7FFF)
    return (int)cudaErrorInvalidValue;
  const uintptr_t gp = reinterpret_cast<uintptr_t>(g);
  const uintptr_t fp = reinterpret_cast<uintptr_t>(feats);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  const int gvec = (gp & 15) == 0 && (g_stride * sizeof(T)) % 16 == 0;
  const int fvec = (fp & 15) == 0 && (dim * sizeof(T)) % 16 == 0;
  const int ovec = (op & (4 * sizeof(T) - 1)) == 0 && dim % 4 == 0;
  if (sizeof(T) == 2 && !gvec && (gp & 1)) return (int)cudaErrorInvalidValue;
  auto kernel = dot_interaction_bwd_kernel<T>;
  cudaError_t err = robe_set_smem(kernel, L.smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  if ((err = robe_resident_grid(kernel, L.threads, L.smem, batch, &grid)) !=
      cudaSuccess)
    return (int)err;
  kernel<<<grid, L.threads, L.smem, stream>>>(
      static_cast<const T*>(g), g_stride, static_cast<const T*>(feats),
      static_cast<T*>(out), batch, L, gvec, fvec, ovec);
  return (int)cudaGetLastError();
}

}  // namespace

// g [batch, n_pairs] at row stride g_stride elements (dtype 0 = f32, 1 =
// bf16, as feats), feats [batch, n, dim] contiguous -> out [batch, n, dim]
// in feats' dtype.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when no layout of a block fits the card's shared
// memory (kernels/dot_interaction.py's bwd_plan says which shapes do).
extern "C" int dot_interaction_bwd_launch(const void* g, long long g_stride,
                                          const void* feats, void* out,
                                          int batch, int n, int dim,
                                          int dtype, int self,
                                          void* stream) {
  if (batch < 1 || n < 1 || dim < 1 || g_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(g, g_stride, feats, out, batch, n, dim, self, s);
    case 1:
      return launch<__nv_bfloat16>(g, g_stride, feats, out, batch, n, dim,
                                   self, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
