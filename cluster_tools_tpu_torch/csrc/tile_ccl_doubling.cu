// Exact 6-connected CCL inside each tile by per-axis run minima (kernel B1d).
//
// Replaces cluster_tools_tpu/ops/pallas_kernels.py::tile_ccl_pallas
// (_ccl_kernel_doubling, doubling=True).  Same function as B1: every
// foreground voxel gets the minimum GLOBAL flat index of its in-tile
// component; background gets BIG = 2**30.
//
// The TPU kernel's iteration sweeps z, then y, then x; on each axis,
// guarded run doubling in both directions (a label jumps 2^k where the
// whole segment between is foreground) leaves every voxel of a foreground
// run holding the run's minimum: a segmented scan built from static
// shifts.  It iterates until nothing changes.  This kernel keeps that
// recurrence and computes each sweep directly as a segmented min-scan, so
// its state after every iteration, and its iteration count, equal the TPU
// kernel's (the count is written out on request, for tests).
//
// Design, one CTA per tile:
//   - labels are 16-bit local indices in shared memory (64 KiB for a
//     16x16x128 tile, so three CTAs share an SM), background 0xFFFF: the
//     only label with its top bit set, so one byte permute gives a
//     halfword's background mask, and a scan step is min(carry | mask, v).
//     The mask needs no array of its own: it is read once, into the labels.
//   - the scans work on two halfwords at once (min.u16x2, native on sm_90).
//   - z and y passes: a thread walks two neighbouring columns packed in one
//     word (one column when tx is odd), forward then backward, in registers
//     when the column is at most kCol long.
//   - x pass: a warp takes two 512-voxel chunks of whole rows (tx a
//     multiple of 16 that divides 512), side by side in the halfwords, a
//     lane 16 voxels of each (16-byte loads); each lane scans its voxels
//     both ways, and the carries between lanes are segmented scans of
//     shuffles (3 steps for rows of 128), a break being a lane that holds
//     background or starts (ends) a row.  Other row lengths: a warp a row,
//     a lane a voxel, chunk by chunk.
//   - the default tile (16, 16, 128) has its own build with its extents as
//     constants: addresses become immediates, which keeps the passes in
//     registers (256 threads, three CTAs an SM).
//   - a pass updates its lines in place (the lines of one axis are
//     disjoint): two barriers and one vote an iteration.  Labels only fall,
//     so "some label fell" is "the state changed".
//   - a component's minimum local index maps to its minimum global index,
//     since the two orders agree inside a tile.
//
// Bound: device memory (1 byte read + 4 bytes written per voxel).  The
// iterations run on the SM: a pass reads and writes 2 bytes of shared
// memory and issues a few instructions a voxel, so a tile's iteration count
// (2 to 65 on the adversarial tiles) sets how far above the bound it runs.

#include "tile_mask.cuh"

namespace {

using namespace tile_mask;

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;  // scripts/torch_b1d_measure.py times other sizes
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = kThreads > 512 ? 2 : 3;  // CTAs an SM must hold
constexpr uint32_t kBg = 0xFFFFu;                   // background label
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kCol = 16;   // column elements held in registers
constexpr int kXLane = 16;  // voxels a lane of the packed x pass takes from each chunk

__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// 0xFFFF in each halfword of v that is background, else 0: a byte permute
// that replicates the top bit of bytes 1 and 3
__device__ __forceinline__ uint32_t bg_mask(uint32_t v) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBB99;" : "=r"(r) : "r"(v));
  return r;
}

// One run-min scan step on two halfword lanes: a background lane restarts
// its run and stays background.
__device__ __forceinline__ uint32_t step(uint32_t carry, uint32_t v) {
  return min2(carry | bg_mask(v), v);
}

// Column element i: a word of two labels (kPair), or one label with a
// background upper half.
template <bool kPair>
__device__ __forceinline__ uint32_t col_ld(const uint16_t* lab, int i) {
  return kPair ? reinterpret_cast<const uint32_t*>(lab)[i] : 0xFFFF0000u | lab[i];
}

template <bool kPair>
__device__ __forceinline__ void col_st(uint16_t* lab, int i, uint32_t v) {
  if (kPair)
    reinterpret_cast<uint32_t*>(lab)[i] = v;
  else
    lab[i] = (uint16_t)v;
}

// Run minima along one column of `len` elements from `base`, `stride`
// apart (in words when kPair).  Returns the bits of the labels that fell.
template <bool kPair>
__device__ __forceinline__ uint32_t column_runs(uint16_t* lab, int base, int stride, int len) {
  uint32_t fell = 0, carry = kFull;
  if (len <= kCol) {
    uint32_t r[kCol];
#pragma unroll
    for (int i = 0; i < kCol; ++i)
      if (i < len) r[i] = col_ld<kPair>(lab, base + i * stride);
#pragma unroll
    for (int i = 0; i < kCol; ++i) {
      if (i < len) {
        carry = step(carry, r[i]);
        fell |= carry ^ r[i];
        r[i] = carry;
      }
    }
    carry = kFull;
#pragma unroll
    for (int i = kCol - 1; i >= 0; --i) {
      if (i < len) {
        carry = step(carry, r[i]);
        fell |= carry ^ r[i];
        col_st<kPair>(lab, base + i * stride, carry);
      }
    }
    return fell;
  }
#pragma unroll 4
  for (int i = 0; i < len; ++i) {
    const uint32_t f = col_ld<kPair>(lab, base + i * stride);
    carry = step(carry, f);
    fell |= carry ^ f;
    col_st<kPair>(lab, base + i * stride, carry);
  }
  carry = kFull;
#pragma unroll 4
  for (int i = len - 1; i >= 0; --i) {
    const uint32_t f = col_ld<kPair>(lab, base + i * stride);
    carry = step(carry, f);
    fell |= carry ^ f;
    col_st<kPair>(lab, base + i * stride, carry);
  }
  return fell;
}

// Every column of one axis: unit u is column (u / per, u % per), its first
// element at (u / per) * slab + u % per.
template <bool kPair>
__device__ __forceinline__ uint32_t column_pass(uint16_t* lab, int n_units, int per, int slab, int stride,
                                                int len) {
  uint32_t fell = 0;
  for (int u = threadIdx.x; u < n_units; u += kThreads) {
    const int q = u / per;
    fell |= column_runs<kPair>(lab, q * slab + u - q * per, stride, len);
  }
  return fell;
}

// Inclusive segmented min-scan of `sum` across the warp, in lane order
// (kFwd) or reverse.  A halfword takes the lanes before it in scan order
// back to, not including, the nearest one whose bit is set in its break
// mask (`ba` for low halfwords, `bb` for high); a lane whose own bit is set
// takes none.  No segment spans more than `span` lanes.
template <bool kFwd>
__device__ __forceinline__ uint32_t warp_scan(uint32_t sum, uint32_t ba, uint32_t bb, int lane, int span) {
  // this lane's break bit and those of the lanes before it, from bit 31 down
  const uint32_t ka = kFwd ? ba << (31 - lane) : __brev(ba) << lane;
  const uint32_t kb = kFwd ? bb << (31 - lane) : __brev(bb) << lane;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= span) break;
    // a lane with no lane d back shuffles its own value: a no-op
    const uint32_t o = kFwd ? __shfl_up_sync(kFull, sum, d) : __shfl_down_sync(kFull, sum, d);
    const uint32_t lim = 1u << (32 - d);  // no break among the d lanes ending here
    const uint32_t keep = (ka < lim ? 0u : 0xFFFFu) | (kb < lim ? 0u : 0xFFFF0000u);
    sum = min2(sum, o | keep);
  }
  return sum;
}

// Lane data of the packed x pass: K voxels of chunk A (from a) and of B
// (from b), element i of each in the low and high halfword of v[i];
// background past nv.
template <int K>
__device__ __forceinline__ void load_ab(const uint16_t* lab, int a, int b, int nv, uint32_t (&v)[K]) {
  const uint4 full = make_uint4(kFull, kFull, kFull, kFull);
#pragma unroll
  for (int q = 0; q < K / 8; ++q) {
    const uint4 wa = a < nv ? reinterpret_cast<const uint4*>(lab + a)[q] : full;
    const uint4 wb = b < nv ? reinterpret_cast<const uint4*>(lab + b)[q] : full;
    const uint32_t la[4] = {wa.x, wa.y, wa.z, wa.w}, lb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[8 * q + 2 * k] = __byte_perm(la[k], lb[k], 0x5410);
      v[8 * q + 2 * k + 1] = __byte_perm(la[k], lb[k], 0x7632);
    }
  }
}

// x pass when tx is a multiple of K and divides 32 K: a warp takes chunks
// A and B of 32 K voxels (whole rows), lane l the K voxels from K l of
// each, packed as load_ab packs them.
template <int K>
__device__ __forceinline__ uint32_t x_pass_packed(uint16_t* lab, int nv, int tx, int warp, int lane) {
  constexpr int kChunk = 32 * K;
  const int span = tx / K;  // lanes a row spans
  uint32_t starts = 0;      // lanes whose first voxel starts a row
  for (int l = 0; l < 32; l += span) starts |= 1u << l;
  const uint32_t ends = starts >> 1 | 0x80000000u;  // lanes whose last voxel ends a row
  const bool at_start = (starts >> lane) & 1u, at_end = (ends >> lane) & 1u;
  uint32_t fell = 0;
  for (int j = warp; 2 * kChunk * j < nv; j += kWarps) {
    const int a = 2 * kChunk * j + K * lane, b = a + kChunk;
    uint32_t v[K];
    load_ab<K>(lab, a, b, nv, v);
    uint32_t fwd = kFull, bwd = kFull, bg = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      fwd = step(fwd, v[i]);
      bwd = step(bwd, v[K - 1 - i]);
      bg |= bg_mask(v[i]);
    }
    const uint32_t ba = __ballot_sync(kFull, bg & 0xFFFFu), bb = __ballot_sync(kFull, bg >> 16);
    fwd = warp_scan<true>(fwd, ba | starts, bb | starts, lane, span);
    bwd = warp_scan<false>(bwd, ba | ends, bb | ends, lane, span);
    // carries into this lane: the lane before it in each direction, none
    // across a row's end
    const uint32_t in_f = __shfl_up_sync(kFull, fwd, 1), in_b = __shfl_down_sync(kFull, bwd, 1);
    fwd = at_start ? kFull : in_f;
    bwd = at_end ? kFull : in_b;
    uint32_t p[K];
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = fwd = step(fwd, v[i]);
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      bwd = step(bwd, v[i]);
      const uint32_t r = min2(p[i], bwd);  // the run's minimum: min of its two scans
      fell |= r ^ v[i];
      p[i] = r;
    }
#pragma unroll
    for (int q = 0; q < K / 8; ++q) {
      const uint32_t* r = p + 8 * q;
      auto half = [&](uint32_t sel) {  // chunk A's (0x5410) or B's (0x7632) halfwords
        return make_uint4(__byte_perm(r[0], r[1], sel), __byte_perm(r[2], r[3], sel),
                          __byte_perm(r[4], r[5], sel), __byte_perm(r[6], r[7], sel));
      };
      if (a < nv) reinterpret_cast<uint4*>(lab + a)[q] = half(0x5410);
      if (b < nv) reinterpret_cast<uint4*>(lab + b)[q] = half(0x7632);
    }
  }
  return fell;
}

// x pass for any tx: a warp a row, a lane a voxel, 32-voxel chunks forward
// then backward, carrying the run-min across chunks (labels in the low
// halfword, background above).
__device__ __forceinline__ uint32_t x_pass_rows(uint16_t* lab, int n_rows, int tx, int warp, int lane) {
  const int n_chunks = (tx + 31) / 32;
  uint32_t fell = 0;
  for (int r = warp; r < n_rows; r += kWarps) {
    uint16_t* row = lab + r * tx;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const bool fwd = pass == 0;
      uint32_t carry = kFull;
      for (int k = 0; k < n_chunks; ++k) {
        const int x = 32 * (fwd ? k : n_chunks - 1 - k) + lane;
        const uint32_t v = x < tx ? 0xFFFF0000u | row[x] : kFull;
        const uint32_t brk = __ballot_sync(kFull, (v & 0xFFFFu) == kBg);
        // the chunk's first lane (in scan order) takes the carry
        const int first = fwd ? 0 : 31;
        uint32_t s = v;
        if (lane == first) s = step(carry, v);
        s = fwd ? warp_scan<true>(s, brk, kFull, lane, 32) : warp_scan<false>(s, brk, kFull, lane, 32);
        const uint32_t in = fwd ? __shfl_up_sync(kFull, s, 1) : __shfl_down_sync(kFull, s, 1);
        const uint32_t out = step(lane == first ? carry : in, v);
        carry = __shfl_sync(kFull, s, 31 - first);
        fell |= out ^ v;
        if (x < tx) row[x] = (uint16_t)out;
      }
    }
  }
  return fell;
}

// The tile's mask into the labels: local index where set, background
// elsewhere.  With `vec`, 16-byte chunks of a row, all in flight at once.
__device__ __forceinline__ void load_labels(const uint8_t* __restrict__ mask, const Geom& g, int nv,
                                            bool vec, uint16_t* lab) {
  if (vec) {
    constexpr int kChunks = (kMaxVoxels / 16 + kThreads - 1) / kThreads;  // per thread
    const int nc = nv / 16;
    uint4 q[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = threadIdx.x + k * kThreads;
      q[k] = c < nc ? *reinterpret_cast<const uint4*>(mask + g.global(16 * c)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c >= nc) continue;
      const uint32_t bits = nonzero_bits(q[k]);
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t v = 16 * c + 2 * i;
        w[i] = ((bits >> 2 * i) & 1u ? v : kBg) | ((bits >> (2 * i + 1)) & 1u ? v + 1 : kBg) << 16;
      }
      uint4* dst = reinterpret_cast<uint4*>(lab + 16 * c);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  } else {
    for (int v = threadIdx.x; v < nv; v += kThreads) lab[v] = mask[g.global(v)] ? (uint16_t)v : (uint16_t)kBg;
  }
  __syncthreads();
}

// TZ, TY, TX: the tile's extents when fixed at compile time (0: as passed),
// which turns the strides and trip counts of the passes into constants
template <int TZ, int TY, int TX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_ccl_doubling_kernel(const uint8_t* __restrict__ mask, int32_t* __restrict__ out,
                         int32_t* __restrict__ iters, int Y, int X, int tz_, int ty_, int tx_, int gy,
                         int gx, int xbits, int ybits, bool vec) {
  extern __shared__ __align__(16) uint16_t lab[];
  const int tz = TZ ? TZ : tz_, ty = TY ? TY : ty_, tx = TX ? TX : tx_;
  const int nv = tz * ty * tx;
  load_labels(mask, make_geom(Y, X, tz, ty, tx, gy, gx, xbits, ybits), nv, vec, lab);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sz = ty * tx;
  const bool pair = (tx & 1) == 0;  // then sz, and every column offset, are even
  const bool packed_x = tx % kXLane == 0 && 32 * kXLane % tx == 0;  // rows tile the chunks

  int n_iter = 0;
  while (true) {
    ++n_iter;
    uint32_t fell = 0;
    // z: columns (ly, lx), stride sz
    if (tz > 1)
      fell |= pair ? column_pass<true>(lab, sz / 2, sz / 2, 0, sz / 2, tz)
                   : column_pass<false>(lab, sz, sz, 0, sz, tz);
    __syncthreads();
    // y: columns (lz, lx), stride tx
    if (ty > 1)
      fell |= pair ? column_pass<true>(lab, tz * tx / 2, tx / 2, sz / 2, tx / 2, ty)
                   : column_pass<false>(lab, tz * tx, tx, sz, tx, ty);
    __syncthreads();
    // x: rows
    if (tx > 1)
      fell |= packed_x ? x_pass_packed<kXLane>(lab, nv, tx, warp, lane)
                       : x_pass_rows(lab, tz * ty, tx, warp, lane);
    if (!__syncthreads_or(fell != 0)) break;
  }
  if (iters && threadIdx.x == 0) iters[blockIdx.x] = n_iter;

  // the tile's geometry again, from a fresh read of the block index, so that
  // none of it stays in registers through the iterations
  uint32_t tile;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(tile));
  const Geom g = make_geom(tile, Y, X, tz, ty, tx, gy, gx, xbits, ybits);
  auto label = [&](uint32_t l) { return l == kBg ? kBig : g.global((int)l); };
  if (vec) {  // four voxels of one row a thread, one 16-byte store
#pragma unroll 4
    for (int v = 4 * threadIdx.x; v < nv; v += 4 * kThreads) {
      const uint2 w = *reinterpret_cast<const uint2*>(lab + v);
      *reinterpret_cast<int4*>(out + g.global(v)) =
          make_int4(label(w.x & 0xFFFFu), label(w.x >> 16), label(w.y & 0xFFFFu), label(w.y >> 16));
    }
  } else {
    for (int v = threadIdx.x; v < nv; v += kThreads) out[g.global(v)] = label(lab[v]);
  }
}

}  // namespace

extern "C" int ct_tile_ccl_doubling(const void* mask, void* out, void* iters, int Z, int Y, int X,
                                    int tz, int ty, int tx, void* stream) {
  const int nv = tz * ty * tx;
  if (nv <= 0 || nv > kMaxVoxels || Z % tz || Y % ty || X % tx)
    return (int)cudaErrorInvalidValue;
  const int gz = Z / tz, gy = Y / ty, gx = X / tx;
  int xbits, ybits;
  pow2_bits(ty, tx, &ybits, &xbits);
  const size_t smem = ((size_t)nv * sizeof(uint16_t) + 15) / 16 * 16;
  // the default tile (16, 16, 128) has its own build
  auto kernel = tz == 16 && ty == 16 && tx == 128 ? tile_ccl_doubling_kernel<16, 16, 128>
                                                  : tile_ccl_doubling_kernel<0, 0, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = gz * gy * gx;
  if (n_tiles == 0) return 0;
  const bool vec = vec_ok(mask, X, tx) && ((uintptr_t)out & 15) == 0;
  kernel<<<n_tiles, kThreads, smem, (cudaStream_t)stream>>>((const uint8_t*)mask, (int32_t*)out, (int32_t*)iters, Y,
                                                            X, tz, ty, tx, gy, gx, xbits, ybits, vec);
  return (int)cudaGetLastError();
}
