// ROBE lookup: [B, F] row ids -> [B, F, d] embeddings gathered through the
// hashed circular array M, with the optional ±1 sign.
//
// Replaces: src/repro/kernels/robe_lookup.py, robe_lookup_pallas (bodies
// _aligned_kernel and _general_kernel; helpers _hash_rows, _signs_tile).
//
// Bound on an H100: bytes.  Each output element is one 4-byte read of M and
// one 4-byte write.  At full width M holds 26.1M f32 slots (104.5 MB), more
// than the 50 MB L2, so gathers mostly go to device memory.
//
// What held the first design back (one warp per (row, field), each lane
// hashing each of its elements; 2.54 ms at B=262,144 against a 1.08 ms
// bound on an NVIDIA H100 80GB HBM3 at 700 W) was the hash, done 32 times
// over for every block at Z=32, and one gather in flight per lane.
//
// Design: blocks of kWarps warps; each warp walks groups of kItems
// consecutive (row, field) items, blockIdx.x * kWarps + warp, + the
// grid's warps, ... (the launcher sizes the grid to the blocks that fit on
// the card).  Per group and chunk of at most 128 elements of each row:
//  - the lanes hash, in one pass, every ROBE block the group's rows span
//    (blocks (x*d + e0) >> log2_z + m for m < robe_chunk_blocks, x*d in 64
//    bits) into a table in shared memory: one slot hash per block, not per
//    element, whatever the regime (Z < d, Z = d, Z > d with rows sharing
//    blocks, Z = 1);
//  - lanes take consecutive elements, so at Z >= 32 the 32 lanes of one
//    load read one block's contiguous run of M -- the coalesced block read
//    of the paper's Table 1; each element's slot is its block's hash plus
//    its offset, wrapped once (robe_chunk_slot); all kItems x 4 gathers of
//    a lane are issued before any is used;
//  - the values (times the sign, hashed per element from the whole index,
//    when the spec has one) go to a stage in shared memory, and the
//    group's rows -- contiguous in the output -- leave it as 16-byte
//    streaming stores, so the output does not push M out of L2.
// The rows of the next group are loaded a group ahead.  Prime and ragged
// batches need no padding: a short last group masks its missing items.
// Four items a group beat eight on the card at both serve batches (more
// warps share a small batch; as many gathers in flight at a large one).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_split.py):
// at B=262,144 what remains is the gathers' trips to device memory -- M is
// twice the L2 -- about 1 ms above the same kernel with every gather an
// L1 hit; the hash costs little now.
#include "robe_common.cuh"

namespace {

constexpr int kWarps = 4;   // warps of a block
constexpr int kItems = 4;   // (row, field) items a warp takes at once

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    robe_lookup_kernel(const T* __restrict__ mem,
                       const int* __restrict__ rows, T* __restrict__ out,
                       int n_rows, const RobeParams p, const RobePlan q) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  char* base = reinterpret_cast<char*>(smem4) + warp * q.warp_bytes;
  unsigned int* table = reinterpret_cast<unsigned int*>(base);
  int* xs = reinterpret_cast<int*>(base + q.table);         // rows of a group
  unsigned int* ts = reinterpret_cast<unsigned int*>(xs + kItems);  // tables
  T* stage = reinterpret_cast<T*>(xs + 2 * kItems);
  const int dim = p.dim, nblk = q.nblk, n_fields = p.n_fields;
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
      // every gather of the group before any is used; a masked element
      // reads slot 0 and is dropped (its table index kept in range)
      T raw[kItems][kRobeChunk / 32];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int x = xs[u];
#pragma unroll
        for (int i = 0; i < kRobeChunk / 32; ++i) {
          const int e = lane + 32 * i;
          const bool ok = u < n_valid && e < cw;
          raw[u][i] = mem[ok ? robe_chunk_slot(p, table + u * nblk, x, e0,
                                               e < cw ? e : 0)
                             : 0u];
        }
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        if (u >= n_valid) break;
        const unsigned long long k0 =
            (unsigned long long)(unsigned int)xs[u] * (unsigned)dim + e0;
#pragma unroll
        for (int i = 0; i < kRobeChunk / 32; ++i) {
          const int e = lane + 32 * i;
          if (e >= cw) break;
          T v = raw[u][i];
          if (p.use_sign) v = from_f32<T>(to_f32(v) * robe_sign(p, ts[u],
                                                                k0 + e));
          stage[u * cw + e] = v;
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

template <typename T>
int launch(const void* mem, const void* rows, void* out, int n_rows,
           const RobeParams& p, cudaStream_t stream) {
  RobePlan q = robe_make_plan(p, n_rows, kItems, (int)sizeof(T));
  const size_t smem = (size_t)kWarps * q.warp_bytes;
  auto kernel = robe_lookup_kernel<T>;
  int grid = 0;
  cudaError_t err = robe_plan_grid(kernel, kWarps, kItems, smem, p, &q,
                                   &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(mem), static_cast<const int*>(rows),
      static_cast<T*>(out), n_rows, p, q);
  return (int)cudaGetLastError();
}

}  // namespace

// mem [|M|] (dtype 0 = f32, 1 = bf16), rows [n_rows] int32 (n_rows = B*F,
// field = index % n_fields), out [n_rows, dim] in mem's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int robe_lookup_launch(const void* mem, const void* rows,
                                  void* out, int n_rows, int mem_dtype,
                                  const unsigned long long* coeffs,
                                  const unsigned int* tids, int n_fields,
                                  int dim, int log2_z, int use_sign,
                                  void* stream) {
  RobeParams p;
  int err = robe_make_params(&p, coeffs, tids, n_fields, dim, log2_z,
                             use_sign);
  if (err) return err;
  if (n_rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mem_dtype) {
    case 0: return launch<float>(mem, rows, out, n_rows, p, s);
    case 1: return launch<__nv_bfloat16>(mem, rows, out, n_rows, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
