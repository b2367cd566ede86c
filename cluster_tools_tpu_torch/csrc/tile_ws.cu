// In-tile watershed label flow along descent codes (kernel B2).
//
// Replaces cluster_tools_tpu/ops/pallas_kernels.py::tile_ws_propagate_pallas
// (_ws_kernel + ws_propagate_step).  Its stepping recurrence converges to
// this: a voxel is a ROOT when its code is 0 (a terminal), lies outside 0..6
// (never selected, so it keeps its value) or points out of the tile (an
// exit).  A root's value is
//   terminal or unknown code:  s if s > 0, else -(g+2) for a terminal with
//                              s == 0, else 0;
//   exit:                      -(target+2), whatever its s;
// and every other voxel ends at its root's value.  g is the voxel's global
// flat index, target = g + the code's flat offset.
//
// Bound: device memory (two int32 inputs read, one int32 output written per
// voxel).  Design:
// - One CTA per tile and one uint16 per voxel in shared memory (64 KiB for
//   a 16x16x128 tile): a non-root's in-tile successor (a local index below
//   2^15), or the top bit and the root's kind.  A root's value needs only
//   its kind, its local index and, when seeded, its label, which is re-read
//   from `sv` when stored (the tile's own footprint, in L2 by then).  Three
//   CTAs share an SM, so one tile's loads and stores overlap the others'
//   pointer walks.
// - Load: warps take x-rows, lanes 16-byte chunks of both inputs; one
//   barrier.  Then one synchronized jump sweep nxt[v] = nxt[nxt[v]] over
//   the tile halves every path at once, and each thread finds its voxels'
//   roots with path halving and stores them a row chunk at a time.  Every
//   write replaces a pointer with one of its ancestors and a root's entry
//   never changes, so racing walks all end at the true root.
// - A walk longer than the tile (only on a cyclic field, which the flow
//   stage never makes and on which the stepping recurrence need not
//   converge) stops and stores 0: no input hangs the kernel.
//
// Exit codes are computed in unsigned arithmetic (two's complement, as the
// reference's int32 arithmetic).

#include "tile_rows.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVoxels = 32768;  // local indices fit 15 bits
constexpr int kInFlight = 2;       // row chunks a lane loads before using them

constexpr uint16_t kRoot = 0x8000;
// root kinds (low bits of a root's entry); an exit with code d (1..6) is
// kExitBase + d - 1, so kinds 3..8
constexpr uint16_t kZero = 0, kUnseeded = 1, kSeeded = 2, kExitBase = 3;

// A voxel's entry from its code d and seed value s.  Branch-free in the
// code: lanes of one warp hold different codes, and a switch on it would
// serialize them.
__device__ __forceinline__ uint16_t entry(int d, int s, int lz, int ly, int lx, int v, int tz,
                                          int ty, int tx) {
  if (d == 0) return kRoot | (s > 0 ? kSeeded : s == 0 ? kUnseeded : kZero);
  if ((unsigned)(d - 1) >= 6u) return kRoot | (s > 0 ? kSeeded : kZero);
  // WS_OFFS order: -z, +z, -y, +y, -x, +x
  const int axis = (d - 1) >> 1;
  const bool neg = d & 1;
  const int c = axis == 0 ? lz : axis == 1 ? ly : lx;
  const int n = axis == 0 ? tz : axis == 1 ? ty : tx;
  const int step = axis == 0 ? ty * tx : axis == 1 ? tx : 1;
  const bool inb = neg ? c > 0 : c + 1 < n;
  return inb ? (uint16_t)(neg ? v - step : v + step) : (uint16_t)(kRoot | (kExitBase + d - 1));
}

// The root entry of v, halving its path on the way; `root` its local index.
__device__ __forceinline__ uint16_t find(uint16_t* nxt, int v, int nv, int& root) {
  int x = v;
  uint16_t e = nxt[x];
  for (int steps = 0; !(e & kRoot); ++steps) {
    const uint16_t ep = nxt[e];
    if (ep & kRoot) {
      x = e;
      e = ep;
      break;
    }
    if (steps > nv) return kRoot | kZero;  // cyclic field
    nxt[x] = ep;
    x = ep;
    e = nxt[x];
  }
  root = x;
  return e;
}

template <int W>
__device__ __forceinline__ int32_t root_value(uint16_t e, int root, const tile_rows::Rows<W>& R,
                                              const int32_t* __restrict__ sv) {
  const int kind = e & ~kRoot;
  if (kind == kZero) return 0;
  const int64_t g = R.global(root);
  if (kind == kSeeded) return __ldg(sv + g);
  uint32_t off = 0;  // kUnseeded: the voxel itself
  if (kind >= kExitBase) {
    const int d = kind - kExitBase + 1, axis = (d - 1) >> 1;
    const uint32_t step = axis == 0 ? (uint32_t)R.Y * (uint32_t)R.X : axis == 1 ? R.X : 1u;
    off = (d & 1) ? 0u - step : step;
  }
  return (int32_t)(0u - (uint32_t)g - off - 2u);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 3)
tile_ws_kernel(const int32_t* __restrict__ dirs, const int32_t* __restrict__ sv,
               int32_t* __restrict__ out, int Y, int X, int tz, int ty, int tx, int gy, int gx) {
  extern __shared__ uint16_t nxt[];
  const tile_rows::Rows<W> R(Y, X, tz, ty, tx, gy, gx);
  const int nv = tz * ty * tx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int u = warp; u < R.units; u += kInFlight * kWarps) {
    int32_t d[kInFlight][W], s[kInFlight][W];
    bool ok[kInFlight];
    int lz, ly, lx, v0;
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      ok[j] = u + j * kWarps < R.units && R.chunk(u + j * kWarps, lane, lz, ly, lx, v0);
      if (ok[j]) {
        const int64_t g0 = R.global(lz, ly, lx);
        tile_rows::load<W>(dirs + g0, d[j]);
        tile_rows::load<W>(sv + g0, s[j]);
      }
    }
    // the chunks' coordinates again: cheaper than holding them in
    // registers while the loads are in flight
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      if (!ok[j]) continue;
      R.chunk(u + j * kWarps, lane, lz, ly, lx, v0);
      uint16_t e[W];
#pragma unroll
      for (int i = 0; i < W; ++i) e[i] = entry(d[j][i], s[j][i], lz, ly, lx + i, v0 + i, tz, ty, tx);
      if constexpr (W == 4) {
        *reinterpret_cast<uint2*>(nxt + v0) =
            make_uint2(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16);
      } else {
        nxt[v0] = e[0];
      }
    }
  }
  __syncthreads();

  // One jump sweep: the finds then walk paths half as long, and a long
  // path is shortened by every thread at once instead of by the few that
  // walk it.
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const uint16_t e = nxt[v];
    if (e & kRoot) continue;
    const uint16_t ee = nxt[e];
    if (!(ee & kRoot)) nxt[v] = ee;
  }
  __syncthreads();

  for (int u = warp; u < R.units; u += kWarps) {
    int lz, ly, lx, v0;
    if (!R.chunk(u, lane, lz, ly, lx, v0)) continue;
    int32_t val[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      int root = 0;
      const uint16_t e = find(nxt, v0 + i, nv, root);
      val[i] = root_value(e, root, R, sv);
    }
    tile_rows::store<W>(out + R.global(lz, ly, lx), val);
  }
}

template <int W>
cudaError_t launch(const int32_t* dirs, const int32_t* sv, int32_t* out, int Y, int X, int tz,
                   int ty, int tx, int gy, int gx, int n_tiles, cudaStream_t stream) {
  const size_t smem = (size_t)tz * ty * tx * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(tile_ws_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tile_ws_kernel<W>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  tile_ws_kernel<W><<<n_tiles, kThreads, smem, stream>>>(dirs, sv, out, Y, X, tz, ty, tx, gy,
                                                         gx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ct_tile_ws_propagate(const void* dirs, const void* sv, void* out,
                                    int Z, int Y, int X, int tz, int ty, int tx,
                                    void* stream) {
  if (tz <= 0 || ty <= 0 || tx <= 0 || tz * ty * tx > kMaxVoxels || Z % tz || Y % ty || X % tx)
    return (int)cudaErrorInvalidValue;
  const int gz = Z / tz, gy = Y / ty, gx = X / tx;
  const int n_tiles = gz * gy * gx;
  if (n_tiles == 0) return 0;
  auto d = (const int32_t*)dirs;
  auto s = (const int32_t*)sv;
  auto o = (int32_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = tile_rows::vec_ok(X, tx, dirs, sv, out)
                              ? launch<4>(d, s, o, Y, X, tz, ty, tx, gy, gx, n_tiles, st)
                              : launch<1>(d, s, o, Y, X, tz, ty, tx, gy, gx, n_tiles, st);
  return (int)err;
}
