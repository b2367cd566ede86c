// Tile geometry shared by the two in-tile CCL kernels (B1 tile_ccl.cu, B1d
// tile_ccl_doubling.cu), and B1's foreground bit mask.
//
// A tile's voxels are numbered by their local index v = (lz * ty + ly) * tx
// + lx.  Within one tile this order is the order of the global flat index,
// so the minimum local index of a component maps to its minimum global one.
// B1 keeps the tile's foreground as a bit mask in shared memory (bit v of
// word v / 32, one padding word after the last), filled by warp ballots.
#pragma once

#include "common.cuh"

namespace tile_mask {

constexpr int kMaxVoxels = 32768;  // local indices fit 16 bits

struct Geom {
  int tz, ty, tx, sz;  // sz = ty * tx
  int xbits, ybits;    // log2(tx), log2(ty) when both are powers of two, else -1
  int Y, X;            // global volume dims (z is implied)
  int z0, y0, x0;      // tile origin

  __device__ __forceinline__ void split(int v, int& lz, int& ly, int& lx) const {
    if (xbits >= 0) {
      lx = v & (tx - 1);
      ly = (v >> xbits) & (ty - 1);
      lz = v >> (xbits + ybits);
    } else {
      lz = v / sz;
      ly = (v - lz * sz) / tx;
      lx = v - lz * sz - ly * tx;
    }
  }
  __device__ __forceinline__ int global(int lz, int ly, int lx) const {
    return ((z0 + lz) * Y + y0 + ly) * X + x0 + lx;
  }
  __device__ __forceinline__ int global(int v) const {
    int lz, ly, lx;
    split(v, lz, ly, lx);
    return global(lz, ly, lx);
  }
};

// tile t's geometry (z-major tile order)
__device__ __forceinline__ Geom make_geom(int t, int Y, int X, int tz, int ty, int tx, int gy, int gx,
                                          int xbits, int ybits) {
  Geom g;
  g.tz = tz;
  g.ty = ty;
  g.tx = tx;
  g.sz = ty * tx;
  g.xbits = xbits;
  g.ybits = ybits;
  g.Y = Y;
  g.X = X;
  g.z0 = (t / (gy * gx)) * tz;
  g.y0 = ((t / gx) % gy) * ty;
  g.x0 = (t % gx) * tx;
  return g;
}

__device__ __forceinline__ Geom make_geom(int Y, int X, int tz, int ty, int tx, int gy, int gx,
                                          int xbits, int ybits) {
  return make_geom(blockIdx.x, Y, X, tz, ty, tx, gy, gx, xbits, ybits);
}

// Host side: log2(tx) and log2(ty) when both are powers of two, else -1.
inline void pow2_bits(int ty, int tx, int* ybits, int* xbits) {
  auto lg = [](int n) {
    int b = 0;
    while ((1 << b) < n) ++b;
    return (1 << b) == n ? b : -1;
  };
  *ybits = lg(ty);
  *xbits = lg(tx);
  if (*ybits < 0 || *xbits < 0) *xbits = *ybits = -1;
}

__host__ __device__ inline int n_words(int nv) { return (nv + 31) / 32 + 1; }

// 16 mask bytes -> 16 bits, byte i to bit i
__device__ __forceinline__ uint32_t nonzero_bits(uint4 q) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  uint32_t b = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = __vcmpne4(w[i], 0u);  // 0xFF per nonzero byte
    b |= ((m >> 7) & 1u | (m >> 14) & 2u | (m >> 21) & 4u | (m >> 28) & 8u) << (4 * i);
  }
  return b;
}

// Load the tile's mask into the bit array `fg` (n_words(nv) words).  Every
// thread of the block must call it; trip counts are uniform so the ballots
// and shuffles see whole warps.  With `vec` (tx and X multiples of 16 and
// the mask 16-byte aligned) each thread loads whole 16-byte chunks of a
// row, all of its chunks in flight at once; otherwise one byte a voxel.
// Ends with a barrier.
template <int kThreads>
__device__ __forceinline__ void load_mask(const uint8_t* __restrict__ mask, const Geom& g, int nv,
                                          bool vec, uint32_t* fg) {
  const int nw = (nv + 31) / 32;
  if (vec) {
    constexpr int kChunks = kMaxVoxels / 16 / kThreads;  // per thread
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
      const uint32_t lo = nonzero_bits(q[k]);
      const uint32_t hi = __shfl_down_sync(0xffffffffu, lo, 1);
      if ((c & 1) == 0 && c < nc) fg[c >> 1] = lo | hi << 16;
    }
  } else {
    for (int base = 0; base < nv; base += kThreads) {
      const int v = base + threadIdx.x;
      bool m = false;
      if (v < nv) m = mask[g.global(v)] != 0;
      const uint32_t bits = __ballot_sync(0xffffffffu, m);
      if ((threadIdx.x & 31) == 0 && (v >> 5) < nw) fg[v >> 5] = bits;
    }
  }
  if (threadIdx.x == 0) fg[nw] = 0;
  __syncthreads();
}

// Host side: whether load_mask may take 16-byte chunks.
inline bool vec_ok(const void* mask, int X, int tx) {
  return tx % 16 == 0 && X % 16 == 0 && ((uintptr_t)mask & 15) == 0;
}

__device__ __forceinline__ bool bit(const uint32_t* fg, int v) {
  return (fg[v >> 5] >> (v & 31)) & 1u;
}

// Number of set bits at v-1, v-2, ... (stopping at the first clear one),
// at most `cap` (cap <= v).  Reads 32 bits a window.
__device__ __forceinline__ int ones_below(const uint32_t* fg, int v, int cap) {
  int n = 0;
  while (n < cap) {
    const int e = v - 1 - n;  // bit e lands in bit 31 of the window
    const int wi = e >> 5, off = e & 31;
    uint32_t win = fg[wi] << (31 - off);
    if (off < 31 && wi > 0) win |= fg[wi - 1] >> (off + 1);
    const int ones = __clz(~win);
    n += ones;
    if (ones < 32) break;
  }
  return min(n, cap);
}

}  // namespace tile_mask
