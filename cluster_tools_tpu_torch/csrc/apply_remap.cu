// Per-tile value remap (kernel B4).
//
// Replaces cluster_tools_tpu/ops/pallas_kernels.py::apply_remap_pallas
// (_apply_kernel): for c = 0..cap-1 IN ORDER,
//     lab = (lab == old[t, c]) ? new[t, c] : lab
// over every voxel of tile t (tables in z-major tile order).
//
// Bound: device memory (one int32 read + one written per voxel).  Design:
// - The chain is composed once per tile, so a voxel costs one lookup
//   whatever the number of slots.  A slot with old == new changes nothing
//   wherever it stands and is dropped; call the rest live.  A label v that
//   first matches live slot c (the smallest such c) becomes new[c], and
//   then runs through slots c+1.. only: its result is img[c], new[c]
//   carried through the later live slots (img[c] = img[j] for the first
//   live j > c with old[j] == new[c], else new[c]).  A label that matches
//   no live slot is kept.  That is exact for any table: duplicate old
//   values (only the first counts), chains in either order, cycles, and
//   every int32 key (-1, INT_MIN, 2^30).
// - The prologue builds an open-addressed hash (old value -> first live
//   slot; at least twice as many entries as slots, so probes are short) and
//   img[] in shared memory, behind three barriers; each lane issues its
//   first row chunks' loads before it, so the prologue's latency hides
//   behind them.  A tile with no live slot only copies.
// - Voxels move as rows: warps take x-rows, lanes 16-byte chunks
//   (tile_rows.cuh), no division per voxel.

#include "tile_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;  // row chunks a lane loads before using them
constexpr unsigned long long kEmpty = 0xFFFFFFFF00000000ull;  // slot -1

__device__ __forceinline__ uint32_t hash_of(int32_t v, int hbits) {
  return ((uint32_t)v * 0x9E3779B1u) >> (32 - hbits);
}

// (slot << 32) | key entries; a miss ends at an empty entry.
__device__ __forceinline__ int32_t lookup(int32_t v, const unsigned long long* hash,
                                          const int32_t* img, int hbits) {
  const uint32_t mask = (1u << hbits) - 1;
  for (uint32_t h = hash_of(v, hbits);; h = (h + 1) & mask) {
    const unsigned long long e = hash[h];
    const int slot = (int)(e >> 32);
    if (slot < 0) return v;
    if ((int32_t)(uint32_t)e == v) return img[slot];
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
apply_remap_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ old_tbl,
                   const int32_t* __restrict__ new_tbl, int32_t* __restrict__ out, int Y, int X,
                   int tz, int ty, int tx, int gy, int gx, int cap, int hbits) {
  extern __shared__ unsigned long long hash[];
  const int hsize = 1 << hbits;
  int32_t* so = reinterpret_cast<int32_t*>(hash + hsize);
  int32_t* sn = so + cap;
  int32_t* next = sn + cap;  // first later live slot whose old is this slot's new
  int32_t* img = next + cap;
  const tile_rows::Rows<W> R(Y, X, tz, ty, tx, gy, gx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t t = blockIdx.x;

  int32_t l[kInFlight][W];
  int64_t g0[kInFlight];
  bool ok[kInFlight];
  auto load_batch = [&](int u) {
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      int lz, ly, lx, v0;
      ok[j] = u + j * kWarps < R.units && R.chunk(u + j * kWarps, lane, lz, ly, lx, v0);
      if (ok[j]) {
        g0[j] = R.global(lz, ly, lx);
        tile_rows::load<W>(lab + g0[j], l[j]);
      }
    }
  };
  load_batch(warp);

  for (int h = threadIdx.x; h < hsize; h += kThreads) hash[h] = kEmpty;
  bool any = false;
  for (int c = threadIdx.x; c < cap; c += kThreads) {
    const int32_t o = __ldg(old_tbl + t * cap + c), n = __ldg(new_tbl + t * cap + c);
    so[c] = o;
    sn[c] = n;
    any |= o != n;
  }
  const bool live = __syncthreads_or(any);
  if (live) {
    for (int c = threadIdx.x; c < cap; c += kThreads) {
      int j = c + 1;
      while (j < cap && (so[j] == sn[j] || so[j] != sn[c])) ++j;
      next[c] = j < cap ? j : -1;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cap; c += kThreads) {
      const int32_t o = so[c];
      if (o == sn[c]) continue;
      bool first = true;
      for (int j = 0; j < c && first; ++j) first = so[j] == sn[j] || so[j] != o;
      if (!first) continue;
      int x = c;
      while (next[x] >= 0) x = next[x];
      img[c] = sn[x];
      const unsigned long long e = (unsigned long long)(uint32_t)c << 32 | (uint32_t)o;
      for (uint32_t h = hash_of(o, hbits);; h = (h + 1) & (hsize - 1))
        if (atomicCAS(&hash[h], kEmpty, e) == kEmpty) break;
    }
    __syncthreads();
  }

  for (int u = warp;;) {
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      if (!ok[j]) continue;
      if (live) {
#pragma unroll
        for (int i = 0; i < W; ++i) l[j][i] = lookup(l[j][i], hash, img, hbits);
      }
      tile_rows::store<W>(out + g0[j], l[j]);
    }
    u += kInFlight * kWarps;
    if (u >= R.units) break;
    load_batch(u);
  }
}

template <int W>
cudaError_t launch(const int32_t* lab, const int32_t* old_tbl, const int32_t* new_tbl,
                   int32_t* out, int Y, int X, int tz, int ty, int tx, int gy, int gx, int cap,
                   int n_tiles, cudaStream_t stream) {
  int hbits = 1;
  while ((1 << hbits) < 2 * cap) ++hbits;
  const size_t smem = sizeof(unsigned long long) * ((size_t)1 << hbits) + 4 * sizeof(int32_t) * cap;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        apply_remap_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  apply_remap_kernel<W><<<n_tiles, kThreads, smem, stream>>>(lab, old_tbl, new_tbl, out, Y, X,
                                                             tz, ty, tx, gy, gx, cap, hbits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ct_apply_remap(const void* lab, const void* old_tbl, const void* new_tbl,
                              void* out, int Z, int Y, int X, int tz, int ty,
                              int tx, int cap, void* stream) {
  if (tz <= 0 || ty <= 0 || tx <= 0 || cap < 0 || cap > (1 << 20) || Z % tz || Y % ty || X % tx)
    return (int)cudaErrorInvalidValue;
  const int gz = Z / tz, gy = Y / ty, gx = X / tx;
  const int n_tiles = gz * gy * gx;
  if (n_tiles == 0) return 0;
  auto l = (const int32_t*)lab;
  auto o = (const int32_t*)old_tbl;
  auto n = (const int32_t*)new_tbl;
  auto r = (int32_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = tile_rows::vec_ok(X, tx, lab, out)
                              ? launch<4>(l, o, n, r, Y, X, tz, ty, tx, gy, gx, cap, n_tiles, st)
                              : launch<1>(l, o, n, r, Y, X, tz, ty, tx, gy, gx, cap, n_tiles, st);
  return (int)err;
}
