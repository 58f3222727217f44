// Shared device code of the serve-path kernels: the ROBE slot and sign hash
// and the gram-triangle epilogue.  Header only; every .cu file that
// includes it compiles its own copy (no relocatable device code needed).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ROBE_M31 0x7FFFFFFFULL
#define ROBE_MAX_FIELDS 128

// One member of the 2-universal family of repro_torch/core/hashing.py.
struct UHash {
  unsigned long long a_t, a2, a1, a0, b;
  unsigned int m;
};

// Everything a kernel needs to hash (table id, row, element) to a slot.
// Passed by value: the table ids ride in the parameter space, so a launch
// copies nothing to the card.
struct RobeParams {
  UHash h;                // slot hash into [0, |M|); h.m == |M|
  UHash g;                // sign hash into {0, 1}
  int log2_z;             // block size Z = 2^log2_z
  int use_sign;
  int dim;                // embedding width d
  int n_fields;
  unsigned int tids[ROBE_MAX_FIELDS];
};

// coeffs: (a_t, a2, a1, a0, b, m) of the slot hash, then of the sign hash.
static inline int robe_make_params(RobeParams* p,
                                   const unsigned long long* coeffs,
                                   const unsigned int* tids, int n_fields,
                                   int dim, int log2_z, int use_sign) {
  if (n_fields < 1 || n_fields > ROBE_MAX_FIELDS || dim < 1 || log2_z < 0 ||
      log2_z > 30)
    return (int)cudaErrorInvalidValue;
  UHash* hs[2] = {&p->h, &p->g};
  for (int k = 0; k < 2; ++k) {
    const unsigned long long* c = coeffs + 6 * k;
    *hs[k] = UHash{c[0], c[1], c[2], c[3], c[4], (unsigned int)c[5]};
  }
  p->log2_z = log2_z;
  p->use_sign = use_sign;
  p->dim = dim;
  p->n_fields = n_fields;
  for (int f = 0; f < n_fields; ++f) p->tids[f] = tids[f];
  return 0;
}

// h(t, key) = ((a_t t + a2 k2 + a1 k1 + a0 k0 + b) mod (2^31-1)) mod m over
// the 31-bit digits of the 64-bit key.  Each product is below 2^62 and the
// sum stays below 2^64 for table ids below 2^31, so the unsigned sum is
// exact; two folds with 2^31 = 1 (mod 2^31-1) reduce it.
__device__ __forceinline__ unsigned int robe_uhash(const UHash& p,
                                                   unsigned long long t,
                                                   unsigned long long key) {
  unsigned long long acc = p.b + p.a_t * t + p.a2 * (key >> 62) +
                           p.a1 * ((key >> 31) & ROBE_M31) +
                           p.a0 * (key & ROBE_M31);
  acc = (acc & ROBE_M31) + (acc >> 31);
  acc = (acc & ROBE_M31) + (acc >> 31);
  unsigned int r = (unsigned int)acc;
  if (r >= (unsigned int)ROBE_M31) r -= (unsigned int)ROBE_M31;
  return r % p.m;
}

// Slot of element index k = x*d + i of table t: hash of the block id plus
// the offset inside the block, wrapped once around the circular array.
__device__ __forceinline__ unsigned int robe_slot(const RobeParams& p,
                                                  unsigned int t,
                                                  unsigned long long k) {
  unsigned int slot = robe_uhash(p.h, t, k >> p.log2_z) +
                      (unsigned int)(k & ((1ULL << p.log2_z) - 1ULL));
  return slot >= p.h.m ? slot - p.h.m : slot;
}

__device__ __forceinline__ float robe_sign(const RobeParams& p,
                                          unsigned int t,
                                          unsigned long long k) {
  return robe_uhash(p.g, t, k) ? -1.f : 1.f;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory row stride (floats) for rows of width `dim`: a multiple of
// four for float4 reads, plus four so that rows start in different banks.
__host__ __device__ __forceinline__ int gram_width4(int dim) {
  return (dim + 3) & ~3;
}
__host__ __device__ __forceinline__ int gram_ld(int dim) {
  return gram_width4(dim) + 4;
}
__host__ __device__ __forceinline__ int gram_pairs(int n, int self) {
  return self ? n * (n + 1) / 2 : n * (n - 1) / 2;
}

// Pair p of the strict lower triangle, in np.tril_indices(k=-1) order:
// (1,0), (2,0), (2,1), (3,0), ...
__device__ __forceinline__ void tril_decode(int p, int* i, int* j) {
  int r = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
  while (r * (r - 1) / 2 > p) --r;
  while (r * (r + 1) / 2 <= p) ++r;
  *i = r;
  *j = p - r * (r - 1) / 2;
}

// out[p] = <row i, row j> for every pair p of the triangle of the n rows in
// shared memory `s` (stride gram_ld(dim), zero beyond dim), accumulated in
// f32 and rounded once to TO.  With `self` the diagonal is included: pair p
// of the strict triangle of n+1 rows, shifted up one row, is pair p of
// np.tril_indices(n, k=0).
template <typename TO>
__device__ __forceinline__ void gram_tril(const float* s, int n, int dim,
                                          int self, TO* __restrict__ out) {
  const int ld = gram_ld(dim), w4 = gram_width4(dim) / 4;
  const int n_pairs = gram_pairs(n, self);
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    int i, j;
    tril_decode(p, &i, &j);
    i -= self;
    const float4* a = reinterpret_cast<const float4*>(s + i * ld);
    const float4* b = reinterpret_cast<const float4*>(s + j * ld);
    float acc = 0.f;
    for (int k = 0; k < w4; ++k) {
      float4 x = a[k], y = b[k];
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
    out[p] = from_f32<TO>(acc);
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory when needed.
template <typename K>
static inline cudaError_t robe_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
