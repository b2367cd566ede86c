// Exact 6-connected CCL inside each tile by run doubling (kernel B1d).
//
// Replaces cluster_tools_tpu/ops/pallas_kernels.py::tile_ccl_pallas
// (_ccl_kernel_doubling, doubling=True).  Same function as B1: every
// foreground voxel gets the minimum GLOBAL flat index of its in-tile
// component; background gets BIG = 2**30.
//
// The TPU kernel's iteration: for each axis z, y, x and each direction, a
// label jumps 2^k voxels at doubling level k when the whole segment between
// is foreground (conn_k[i] = conn_{k-1}[i] & conn_{k-1}[i -/+ 2^{k-1}]),
// for 2^k < extent; iterate until nothing changes.  One pass over an axis
// leaves every voxel with the minimum over its whole foreground run, so
// the iterations needed grow with the direction changes of a component,
// not with its length.
//
// Design: one CTA per tile, the tile's labels (16-bit local indices) in
// two shared-memory buffers, so each doubling level reads only the
// previous level's labels (Jacobi, as the TPU kernel).  The conn_k masks
// are never built: conn_k holds exactly where at least 2^k foreground
// voxels precede the voxel in its run, so each thread counts, once, the
// run before and after each of its voxels on each axis (read off the bit
// array) and keeps in a register only the number of levels each may take,
// six 4-bit counts per voxel.  Levels that no voxel of the tile takes are
// skipped, and a voxel stops being read or written in a pass one level
// after its own levels run out.  A component's minimum local index maps to
// its minimum global index, since the two orders agree inside a tile.
//
// Bound: device memory (1 byte read + 4 bytes written per voxel); the
// iterations run out of shared memory.

#include "tile_mask.cuh"

namespace {

using namespace tile_mask;

constexpr int kBig = 1 << 30;
constexpr int kThreads = 1024;
constexpr int kPerThread = kMaxVoxels / kThreads;
constexpr uint32_t kFg = 1u << 24;

// doubling levels of an extent: steps 1, 2, 4, ... below it
__device__ __forceinline__ int n_levels(int extent) {
  int k = 0;
  while ((1 << k) < extent) ++k;
  return k;
}

// levels a voxel may take when `run` foreground voxels precede it
__device__ __forceinline__ uint32_t levels_of(int run) { return run ? 32 - __clz(run) : 0; }

__global__ void __launch_bounds__(kThreads)
tile_ccl_doubling_kernel(const uint8_t* __restrict__ mask, int32_t* __restrict__ out, int Y, int X,
                         int tz, int ty, int tx, int gy, int gx, int xbits, int ybits, bool vec) {
  extern __shared__ uint32_t smem[];
  __shared__ int top[6];  // most levels any voxel takes, per (axis, direction)
  const int nv = tz * ty * tx;
  const Geom g = make_geom(Y, X, tz, ty, tx, gy, gx, xbits, ybits);
  uint32_t* fg = smem;
  uint16_t* cur = reinterpret_cast<uint16_t*>(smem + n_words(nv));
  uint16_t* nxt = cur + nv;
  if (threadIdx.x < 6) top[threadIdx.x] = 0;

  load_mask<kThreads>(mask, g, nv, vec, fg);

  const int ext[3] = {tz, ty, tx};
  const int stride[3] = {g.sz, tx, 1};
  int lv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) lv[a] = n_levels(ext[a]);

  // per voxel: bit 24 = foreground; 4 bits at 4 * (2a + d) = levels along
  // axis a, d = 0 towards lower indices, d = 1 towards higher
  uint32_t meta[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int v = threadIdx.x + k * kThreads;
    meta[k] = 0;
    if (v < nv && bit(fg, v)) {
      int pos[3];
      g.split(v, pos[0], pos[1], pos[2]);
      uint32_t m = kFg;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (lv[a] == 0) continue;
        const int cap = 1 << (lv[a] - 1);  // a longer run adds no level
        const int lo = min(pos[a], cap), hi = min(ext[a] - 1 - pos[a], cap);
        const int below = a == 2 ? ones_below(fg, v, lo) : ones_strided(fg, v, stride[a], lo);
        const int above = a == 2 ? ones_above(fg, v, hi) : ones_strided(fg, v, -stride[a], hi);
        m |= levels_of(below) << (8 * a) | levels_of(above) << (8 * a + 4);
      }
      meta[k] = m;
      cur[v] = (uint16_t)v;
    }
  }
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    uint32_t mx = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) mx = max(mx, (meta[k] >> (4 * f)) & 15u);
    if (mx) atomicMax(&top[f], (int)mx);
  }
  __syncthreads();

  while (true) {
    int changed = 0;
    for (int a = 0; a < 3; ++a) {
      for (int d = 0; d < 2; ++d) {
        const int f = 2 * a + d;
        const int sgn = d == 0 ? 1 : -1;
        for (int lvl = 0; lvl < top[f]; ++lvl) {
          const int off = sgn * (stride[a] << lvl);
#pragma unroll
          for (int k = 0; k < kPerThread; ++k) {
            // a voxel whose levels are used up is copied once, after which
            // both buffers hold its value for the rest of the pass
            const uint32_t take = (meta[k] >> (4 * f)) & 15u;
            if ((meta[k] & kFg) && take >= (uint32_t)lvl) {
              const int v = threadIdx.x + k * kThreads;
              int val = cur[v];
              if (take > (uint32_t)lvl) {
                const int cand = cur[v - off];
                if (cand < val) {
                  val = cand;
                  changed = 1;
                }
              }
              nxt[v] = (uint16_t)val;
            }
          }
          __syncthreads();
          uint16_t* t = cur;
          cur = nxt;
          nxt = t;
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  for (int v = threadIdx.x; v < nv; v += kThreads) {
    int lz, ly, lx;
    g.split(v, lz, ly, lx);
    out[g.global(lz, ly, lx)] = bit(fg, v) ? g.global(cur[v]) : kBig;
  }
}

}  // namespace

extern "C" int ct_tile_ccl_doubling(const void* mask, void* out, int Z, int Y, int X,
                                    int tz, int ty, int tx, void* stream) {
  const int nv = tz * ty * tx;
  if (nv <= 0 || nv > kMaxVoxels || Z % tz || Y % ty || X % tx)
    return (int)cudaErrorInvalidValue;
  const int gz = Z / tz, gy = Y / ty, gx = X / tx;
  int xbits, ybits;
  pow2_bits(ty, tx, &ybits, &xbits);
  const size_t smem = n_words(nv) * sizeof(uint32_t) + 2 * (size_t)nv * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_ccl_doubling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = gz * gy * gx;
  if (n_tiles == 0) return 0;
  tile_ccl_doubling_kernel<<<n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (int32_t*)out, Y, X, tz, ty, tx, gy, gx, xbits, ybits,
      vec_ok(mask, X, tx));
  return (int)cudaGetLastError();
}
