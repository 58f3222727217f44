// Shared device code of the port's kernels: the ROBE slot and sign
// hash, dtype conversions and the shared-memory opt-in.  Header only; every
// .cu file that includes it compiles its own copy (no relocatable device
// code needed).
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ROBE_M31 0x7FFFFFFFU
#define ROBE_MAX_FIELDS 128
#define ROBE_HASH_COEFFS 7

// Dynamic shared memory a block may opt in to on an H100.
constexpr size_t kSmemLimit = 227 * 1024;

// One member of the 2-universal family of repro_torch/core/hashing.py.
// Every coefficient is below 2^31, so each coefficient x digit product is
// one 32 x 32 -> 64-bit multiply.  `fm` = ceil(2^64 / m) (mod 2^64) turns
// the final `% m` into two multiplies (Lemire's fastmod, exact for every
// 32-bit input and every m >= 1); the host computes it
// (kernels/_build.py, fastmod_const).
struct UHash {
  unsigned int a_t, a2, a1, a0, b, m;
  unsigned long long fm;
};

// Everything a kernel needs to hash (table id, row, element) to a slot.
// Passed by value: the table ids ride in the parameter space, so a launch
// copies nothing to the card.
struct RobeParams {
  UHash h;                // slot hash into [0, |M|); h.m == |M|
  UHash g;                // sign hash into {0, 1}: g.m is a power of two
  int log2_z;             // block size Z = 2^log2_z
  int use_sign;
  int dim;                // embedding width d
  int n_fields;
  unsigned int tids[ROBE_MAX_FIELDS];
};

// coeffs: (a_t, a2, a1, a0, b, m, fm) of the slot hash, then of the sign
// hash.
static inline int robe_make_params(RobeParams* p,
                                   const unsigned long long* coeffs,
                                   const unsigned int* tids, int n_fields,
                                   int dim, int log2_z, int use_sign) {
  if (n_fields < 1 || n_fields > ROBE_MAX_FIELDS || dim < 1 || log2_z < 0 ||
      log2_z > 30)
    return (int)cudaErrorInvalidValue;
  UHash* hs[2] = {&p->h, &p->g};
  for (int k = 0; k < 2; ++k) {
    const unsigned long long* c = coeffs + ROBE_HASH_COEFFS * k;
    for (int i = 0; i < 6; ++i)
      if (c[i] > ROBE_M31 || (i == 5 && c[i] == 0))
        return (int)cudaErrorInvalidValue;
    *hs[k] = UHash{(unsigned int)c[0], (unsigned int)c[1], (unsigned int)c[2],
                   (unsigned int)c[3], (unsigned int)c[4], (unsigned int)c[5],
                   c[6]};
  }
  if (p->g.m & (p->g.m - 1)) return (int)cudaErrorInvalidValue;
  p->log2_z = log2_z;
  p->use_sign = use_sign;
  p->dim = dim;
  p->n_fields = n_fields;
  for (int f = 0; f < n_fields; ++f) p->tids[f] = tids[f];
  return 0;
}

// ceil(2^64 / m) mod 2^64 for 1 <= m < 2^32 (0 for m = 1): the fastmod
// constant, as kernels/_build.py's fastmod_const computes it.
static inline unsigned long long robe_fastmod_const(unsigned int m) {
  return ~0ULL / m + 1ULL;
}

// (a_t t + a2 k2 + a1 k1 + a0 k0 + b) mod (2^31-1) over the 31-bit digits
// of the 64-bit key.  Each product is below 2^62 (k2 < 4) and the sum stays
// below 2^64 for table ids below 2^31, so the unsigned sum is exact; two
// folds with 2^31 = 1 (mod 2^31-1) reduce it.
__device__ __forceinline__ unsigned int robe_uhash_m31(
    const UHash& p, unsigned int t, unsigned long long key) {
  const unsigned int k2 = (unsigned int)(key >> 62),
                     k1 = (unsigned int)(key >> 31) & ROBE_M31,
                     k0 = (unsigned int)key & ROBE_M31;
  unsigned long long acc = (unsigned long long)p.b +
                           (unsigned long long)p.a_t * t +
                           (unsigned long long)p.a2 * k2 +
                           (unsigned long long)p.a1 * k1 +
                           (unsigned long long)p.a0 * k0;
  acc = (acc & ROBE_M31) + (acc >> 31);
  acc = (acc & ROBE_M31) + (acc >> 31);
  unsigned int r = (unsigned int)acc;
  return r >= ROBE_M31 ? r - ROBE_M31 : r;
}

// r mod m as ((fm * r mod 2^64) * m) >> 64, the high half taken from a
// 64 x 32-bit product: three integer multiplies, no division.
__device__ __forceinline__ unsigned int robe_fastmod(unsigned int r,
                                                     unsigned long long fm,
                                                     unsigned int m) {
  const unsigned long long low = fm * r;
  const unsigned long long hi =
      (unsigned long long)(unsigned int)(low >> 32) * m +
      __umulhi((unsigned int)low, m);
  return (unsigned int)(hi >> 32);
}

// h(t, key) = ((a_t t + a2 k2 + a1 k1 + a0 k0 + b) mod (2^31-1)) mod m.
__device__ __forceinline__ unsigned int robe_uhash(const UHash& p,
                                                   unsigned int t,
                                                   unsigned long long key) {
  return robe_fastmod(robe_uhash_m31(p, t, key), p.fm, p.m);
}

// Slot of the element at offset `off` inside a block whose slot hash is
// `hb`: the offset added, wrapped once around the circular array.
__device__ __forceinline__ unsigned int robe_slot_in(const RobeParams& p,
                                                     unsigned int hb,
                                                     unsigned int off) {
  const unsigned int slot = hb + off;
  return slot >= p.h.m ? slot - p.h.m : slot;
}

// Slot of element index k = x*d + i of table t.
__device__ __forceinline__ unsigned int robe_slot(const RobeParams& p,
                                                  unsigned int t,
                                                  unsigned long long k) {
  return robe_slot_in(
      p, robe_uhash(p.h, t, k >> p.log2_z),
      (unsigned int)(k & ((1ULL << p.log2_z) - 1ULL)));
}

// Elements of a row in one chunk: the lookups that hash each block once
// fill their table of block hashes a chunk at a time.
constexpr int kRobeChunk = 128;

// A row's elements e0 .. e0+127 (one chunk) span at most 129 blocks; the
// lookups that hash each block once keep the chunk's block hashes in a
// table and read an element's slot from it.  Entries a chunk needs:
__host__ __device__ __forceinline__ int robe_chunk_blocks(int dim,
                                                          int log2_z) {
  return (((dim < kRobeChunk ? dim : kRobeChunk) - 1) >> log2_z) + 2;
}

// Slot hash of block m of the chunk of row x that starts at element e0:
// block (x*d + e0) / Z + m of table t (64-bit element index).
__device__ __forceinline__ unsigned int robe_chunk_hash(const RobeParams& p,
                                                        unsigned int t,
                                                        int x, int e0,
                                                        int m) {
  const unsigned long long k0 =
      (unsigned long long)(unsigned int)x * (unsigned)p.dim + e0;
  return robe_uhash(p.h, t, (k0 >> p.log2_z) + m);
}

// Slot of element e0 + e (e < 128) of row x, from the chunk's block hashes
// `hb`: the element's offset in its block, added to the block's hash and
// wrapped once, in 32-bit arithmetic (only the low log2_z bits of x*d + e0
// matter).
__device__ __forceinline__ unsigned int robe_chunk_slot(
    const RobeParams& p, const unsigned int* hb, int x, int e0, int e) {
  const unsigned int zm = (1u << p.log2_z) - 1u;
  const unsigned int pos =
      (((unsigned int)x * (unsigned)p.dim + e0) & zm) + e;
  return robe_slot_in(p, hb[pos >> p.log2_z], pos & zm);
}

// What the launcher of a lookup whose warps walk groups of `items`
// (row, field) items, one table of block hashes each, derives once from
// the shapes.
struct RobePlan {
  int nblk;       // table entries per item: robe_chunk_blocks(dim, log2_z)
  int table;      // bytes of the table, a multiple of 16
  int warp_bytes; // shared memory of one warp
  int f_step;     // (warps of the grid * items) % n_fields
  int pass_u, pass_m;  // 32 = pass_u * nblk + pass_m: a pass's step
  long long groups;    // groups of `items` items
};

// A warp's shared memory: the table, the group's rows and table ids, and
// a stage of `items` chunks of `elem_bytes`-byte outputs.
static inline RobePlan robe_make_plan(const RobeParams& p, int n_rows,
                                      int items, int elem_bytes) {
  RobePlan q;
  q.nblk = robe_chunk_blocks(p.dim, p.log2_z);
  q.table = (int)((sizeof(unsigned) * items * q.nblk + 15) & ~15);
  const int chunk = p.dim < kRobeChunk ? p.dim : kRobeChunk;
  q.warp_bytes = q.table + 2 * items * 4 +
                 ((elem_bytes * items * chunk + 15) & ~15);
  q.pass_u = 32 / q.nblk;
  q.pass_m = 32 % q.nblk;
  q.groups = ((long long)n_rows + items - 1) / items;
  q.f_step = 0;
  return q;
}

// Copy n elements from shared memory to device memory, lanes lane,
// lane + step, ...: 16 bytes a store when dst is 16-byte aligned (src is,
// by the callers' layouts), the rest one element at a time.  The 16-byte
// stores stream (evict first): the output is written once, and should not
// push the array the lookup gathers from out of L2.
template <typename T>
__device__ __forceinline__ void robe_copy_out(T* __restrict__ dst,
                                              const T* __restrict__ src,
                                              int n, int lane, int step) {
  constexpr int kVec = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = n / kVec;
    for (int i = lane; i < nv; i += step)
      __stcs(reinterpret_cast<uint4*>(dst) + i,
             reinterpret_cast<const uint4*>(src)[i]);
    done = nv * kVec;
  }
  for (int i = done + lane; i < n; i += step) dst[i] = src[i];
}

// The sign hash's m is a power of two (2), so its `% m` is a mask.
__device__ __forceinline__ float robe_sign(const RobeParams& p,
                                          unsigned int t,
                                          unsigned long long k) {
  return (robe_uhash_m31(p.g, t, k) & (p.g.m - 1)) ? -1.f : 1.f;
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

// Asynchronous copies from global to shared memory (sm_80+).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
// kBytes (4, 8 or 16) bytes, kept in L1 as well: for sources that other
// warps of the SM read again.
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Opt a kernel in to more than 48 KB of dynamic shared memory when needed.
template <typename K>
static inline cudaError_t robe_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The grid of a kernel whose blocks walk the batch (blockIdx.x, +
// gridDim.x, ...): as many blocks of `threads` threads and `smem` bytes as
// the card holds at once, and no more than `batch`.
template <typename K>
static inline cudaError_t robe_resident_grid(K kernel, int threads,
                                             size_t smem, int batch,
                                             int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = (int)(batch < resident ? batch : resident);
  return cudaSuccess;
}

// The persistent grid of a lookup kernel of `warps` warps a block that
// walks q's groups, with the kernel opted in to `smem` bytes; sets
// q->f_step, which depends on the grid.
template <typename K>
static inline cudaError_t robe_plan_grid(K kernel, int warps, int items,
                                         size_t smem, const RobeParams& p,
                                         RobePlan* q, int* grid) {
  cudaError_t err = robe_set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (q->groups + warps - 1) / warps;
  if ((err = robe_resident_grid(kernel, 32 * warps, smem, (int)blocks,
                                grid)) != cudaSuccess)
    return err;
  q->f_step = (int)(((long long)*grid * warps * items) % p.n_fields);
  return cudaSuccess;
}
