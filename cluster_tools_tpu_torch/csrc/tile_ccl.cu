// Exact 6-connected CCL inside each tile of a 3-D mask (kernel B1).
//
// Replaces cluster_tools_tpu/ops/pallas_kernels.py::tile_ccl_pallas
// (_ccl_kernel, doubling=False).  Every foreground voxel gets the minimum
// GLOBAL flat index (padded volume order) of its in-tile component;
// background gets BIG = 2**30.
//
// Design: union-find over x-runs in shared memory, one CTA per tile.  The
// TPU kernel sweeps a 6-neighbour min until nothing changes, so its work
// grows with the longest path inside the tile; here the work is a fixed
// number of passes, each thread taking 32-voxel chunks of the tile's rows:
//   1. the mask goes into a bit array;
//   2. every x-run start (a set bit whose left neighbour is clear, found 32
//      at a time with shifts) becomes its own parent: a run is one node,
//      so x-neighbours need no unions;
//   3. one union per overlap segment of a row with its -y row and with its
//      -z row (segment starts found with shifts, as run starts): a pair of
//      overlapping runs overlaps in exactly one segment, so no union is
//      repeated.  A union hooks the larger root under the smaller one with
//      a 16-bit atomicCAS that succeeds only on a root (lock-free); finds
//      split their paths with plain stores (a parent is only ever replaced
//      by one of its ancestors, so the races are benign);
//   4. every run start points at its root;
//   5. a voxel's label is its run start's parent, the run start read off
//      the bit array 32 bits at a time; 16-byte stores where rows allow.
// Parents only point to smaller local indices, so a component's root is its
// minimum local index, and local order equals global order inside a tile:
// the root is exactly the label the TPU kernel converges to.  16-bit
// parents (a tile holds <= 32768 voxels) keep a 16x16x128 tile in 68 KiB,
// two 1024-thread CTAs per SM: the unions are chains of dependent
// shared-memory accesses, and more threads in flight hide more of them.
//
// Bound: device memory (1 byte read + 4 bytes written per voxel).

#include "tile_mask.cuh"

namespace {

using namespace tile_mask;

constexpr int kBig = 1 << 30;
constexpr int kThreads = 1024;

// The root above x; with kSplit, every node on the way is re-pointed to
// its grandparent (plain stores: a node's parent is only ever replaced by
// one of its ancestors).
template <bool kSplit>
__device__ __forceinline__ int find_root(uint16_t* par, int x) {
  volatile uint16_t* p = par;
  int cur = p[x];
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = p[cur])) {  // cur is not a root
      if (kSplit) p[prev] = (uint16_t)next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

__device__ __forceinline__ void unite(uint16_t* par, int a, int b) {
  int ra = find_root<true>(par, a), rb = find_root<true>(par, b);
  while (ra != rb) {
    if (ra > rb) {
      const int t = ra;
      ra = rb;
      rb = t;
    }
    // hook rb under ra if rb is still a root; else climb to rb's parent
    const int old = atomicCAS((unsigned short*)&par[rb], (unsigned short)rb, (unsigned short)ra);
    if (old == rb) return;
    rb = old;
  }
}

// 32 mask bits from bit position p on (the bit array ends in a zero word)
__device__ __forceinline__ uint32_t bits_at(const uint32_t* fg, int p) {
  return __funnelshift_r(fg[p >> 5], fg[(p >> 5) + 1], p & 31);
}

// One 32-voxel chunk of a row: local index of its first voxel, its x
// offset in the row, and its foreground bits.
struct Chunk {
  int p, lx0;
  uint32_t w;
};

__device__ __forceinline__ Chunk chunk(const uint32_t* fg, int item, int nch, int tx) {
  const int r = item / nch, j = item - r * nch;
  Chunk c;
  c.lx0 = 32 * j;
  c.p = r * tx + c.lx0;
  const int len = min(32, tx - c.lx0);
  c.w = bits_at(fg, c.p) & (len == 32 ? ~0u : (1u << len) - 1);
  return c;
}

// bits of `w` that start a run: set, with the bit before clear (`before`
// is the bit ahead of the chunk, 0 at a row start)
__device__ __forceinline__ uint32_t run_starts(uint32_t w, uint32_t before) {
  return w & ~((w << 1) | before);
}

__global__ void __launch_bounds__(kThreads)
tile_ccl_kernel(const uint8_t* __restrict__ mask, int32_t* __restrict__ out, int Y, int X, int tz,
                int ty, int tx, int gy, int gx, int xbits, int ybits, bool vec) {
  extern __shared__ uint32_t smem[];
  const int nv = tz * ty * tx;
  const Geom g = make_geom(Y, X, tz, ty, tx, gy, gx, xbits, ybits);
  uint32_t* fg = smem;
  uint16_t* par = reinterpret_cast<uint16_t*>(smem + n_words(nv));

  load_mask<kThreads>(mask, g, nv, vec, fg);

  const int nch = (tx + 31) >> 5;  // chunks per row
  const int n_items = tz * ty * nch;

  for (int it = threadIdx.x; it < n_items; it += kThreads) {
    const Chunk c = chunk(fg, it, nch, tx);
    for (uint32_t s = run_starts(c.w, c.lx0 ? bit(fg, c.p - 1) : 0u); s; s &= s - 1) {
      const int v = c.p + __ffs(s) - 1;
      par[v] = (uint16_t)v;
    }
  }
  __syncthreads();

  for (int it = threadIdx.x; it < n_items; it += kThreads) {
    const Chunk c = chunk(fg, it, nch, tx);
    if (!c.w) continue;
    const int r = it / nch;
    const bool before = c.lx0 && bit(fg, c.p - 1);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      if (nb == 0 ? r % ty == 0 : r < ty) continue;  // no -y / -z row
      const int q = c.p - (nb == 0 ? tx : g.sz);
      const uint32_t o = c.w & bits_at(fg, q);
      for (uint32_t s = run_starts(o, before && bit(fg, q - 1)); s; s &= s - 1) {
        const int b = __ffs(s) - 1, lx = c.lx0 + b;
        unite(par, c.p + b - ones_below(fg, c.p + b, lx), q + b - ones_below(fg, q + b, lx));
      }
    }
  }
  __syncthreads();

  // finds here only read, so the one store to a run start is its own thread's
  for (int it = threadIdx.x; it < n_items; it += kThreads) {
    const Chunk c = chunk(fg, it, nch, tx);
    for (uint32_t s = run_starts(c.w, c.lx0 ? bit(fg, c.p - 1) : 0u); s; s &= s - 1) {
      const int v = c.p + __ffs(s) - 1;
      par[v] = (uint16_t)find_root<false>(par, v);
    }
  }
  __syncthreads();

  if (vec) {  // four voxels of one row a thread, one 16-byte store
#pragma unroll 4
    for (int v = 4 * threadIdx.x; v < nv; v += 4 * kThreads) {
      const uint32_t nib = (fg[v >> 5] >> (v & 31)) & 15u;
      int lab[4] = {kBig, kBig, kBig, kBig};
      if (nib) {
        int lz, ly, lx;
        g.split(v, lz, ly, lx);
        int root = nib & 1u ? g.global(par[v - ones_below(fg, v, lx)]) : kBig;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!((nib >> i) & 1u)) continue;
          if (i > 0 && !((nib >> (i - 1)) & 1u)) root = g.global(par[v + i]);  // a run starts here
          lab[i] = root;
        }
      }
      *reinterpret_cast<int4*>(out + g.global(v)) = make_int4(lab[0], lab[1], lab[2], lab[3]);
    }
  } else {
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      int lab = kBig;
      if (bit(fg, v)) {
        int lz, ly, lx;
        g.split(v, lz, ly, lx);
        lab = g.global(par[v - ones_below(fg, v, lx)]);
      }
      out[g.global(v)] = lab;
    }
  }
}

}  // namespace

extern "C" int ct_tile_ccl(const void* mask, void* out, int Z, int Y, int X,
                           int tz, int ty, int tx, void* stream) {
  const int nv = tz * ty * tx;
  if (nv <= 0 || nv > kMaxVoxels || Z % tz || Y % ty || X % tx)
    return (int)cudaErrorInvalidValue;
  const int gz = Z / tz, gy = Y / ty, gx = X / tx;
  int xbits, ybits;
  pow2_bits(ty, tx, &ybits, &xbits);
  const size_t smem = n_words(nv) * sizeof(uint32_t) + (size_t)nv * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_ccl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = gz * gy * gx;
  if (n_tiles == 0) return 0;
  const bool vec = vec_ok(mask, X, tx) && ((uintptr_t)out & 15) == 0;
  tile_ccl_kernel<<<n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (int32_t*)out, Y, X, tz, ty, tx, gy, gx, xbits, ybits, vec);
  return (int)cudaGetLastError();
}
