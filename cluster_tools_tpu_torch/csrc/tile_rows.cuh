// Row-shaped walks over one tile, shared by the label kernels (B2 tile_ws.cu,
// B4 apply_remap.cu).
//
// A tile's voxels are numbered by their local index v = (lz * ty + ly) * tx
// + lx, so an x-row is a run of tx local indices and of tx global ones.  A
// warp takes one row segment of 32 chunks at a time and a lane one chunk of
// W voxels (W = 4: one 16-byte access; W = 1 where rows are not 16-byte
// aligned), so one warp access covers 32 * W voxels of a row.  The row's
// (z, y) comes from the segment index, one division per warp step and none
// per voxel.  Global indices are 64-bit: a volume may hold 2^31 voxels or
// more.
#pragma once

#include "common.cuh"

namespace tile_rows {

template <int W>
struct Rows {
  int ty, tx, Y, X;
  int z0, y0, x0;     // tile origin
  int cpr, segs;      // chunks per row, 32-chunk segments per row
  int units;          // row segments in the tile
  int xbits, ybits;   // log2(tx), log2(ty) when both are powers of two, else -1

  __device__ __forceinline__ Rows(int Y_, int X_, int tz, int ty_, int tx_, int gy, int gx)
      : ty(ty_), tx(tx_), Y(Y_), X(X_) {
    const int t = blockIdx.x;
    z0 = (t / (gy * gx)) * tz;
    y0 = ((t / gx) % gy) * ty;
    x0 = (t % gx) * tx;
    cpr = tx / W;
    segs = (cpr + 31) / 32;
    units = tz * ty * segs;
    const bool pow2 = !(tx & (tx - 1)) && !(ty & (ty - 1));
    xbits = pow2 ? __ffs(tx) - 1 : -1;
    ybits = pow2 ? __ffs(ty) - 1 : -1;
  }

  __device__ __forceinline__ int64_t global(int lz, int ly, int lx) const {
    return ((int64_t)(z0 + lz) * Y + y0 + ly) * X + x0 + lx;
  }

  // The global index of local index v.
  __device__ __forceinline__ int64_t global(int v) const {
    int row, lz;
    if (xbits >= 0) {
      row = v >> xbits;
      lz = row >> ybits;
    } else {
      row = v / tx;
      lz = row / ty;
    }
    return global(lz, row - lz * ty, v - row * tx);
  }

  // This lane's chunk of segment u: the row's (lz, ly), the chunk's first
  // x and its first voxel's local index; false past the row's end.
  __device__ __forceinline__ bool chunk(int u, int lane, int& lz, int& ly, int& lx,
                                        int& v0) const {
    const int row = segs == 1 ? u : u / segs;
    const int q = (u - row * segs) * 32 + lane;
    if (q >= cpr) return false;
    lz = ybits >= 0 ? row >> ybits : row / ty;
    ly = row - lz * ty;
    lx = q * W;
    v0 = row * tx + lx;
    return true;
  }
};

template <int W>
__device__ __forceinline__ void load(const int32_t* __restrict__ p, int32_t (&a)[W]) {
  if constexpr (W == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    a[0] = q.x;
    a[1] = q.y;
    a[2] = q.z;
    a[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = __ldg(p + i);
  }
}

template <int W>
__device__ __forceinline__ void store(int32_t* __restrict__ p, const int32_t (&a)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = a[i];
  }
}

// Host side: rows take 16-byte chunks when every row starts 16-byte aligned.
inline bool vec_ok(int X, int tx, const void* a, const void* b, const void* c = nullptr) {
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  return tx % 4 == 0 && X % 4 == 0 && al(a) && al(b) && (c == nullptr || al(c));
}

}  // namespace tile_rows
