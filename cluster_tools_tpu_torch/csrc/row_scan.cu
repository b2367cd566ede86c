// Inclusive scan along the last axis of a contiguous [B, N] tensor: an
// int32 sum (wrapping, as torch.cumsum(..., dtype=torch.int32) does) of
// int32 or bool input, or an int32 running max (torch.cummax(...).values).
//
// Replaces no Pallas kernel.  The JAX package leaves its row scans to XLA
// (lax.cumsum / lax.cummax in ops/tile_ccl.py::_compact_rows and
// _remap_tables_core, ops/tile_ws.py::_value_join_core).  PyTorch's CUDA
// cummax always scans a row with one thread block, and its cumsum does so
// whenever the tensor has more than one row, so a row of millions of
// entries ran on 1 of the card's 132 SMs; it also wrote int64 indices that
// no caller reads.
//
// Bound: device memory.  An element is read once (4 bytes, 1 for bool) and
// written once (4 bytes): a 28M-element max moves 224 MB, 0.07 ms at
// 3.35 TB/s.  Design: a single pass with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back").
// - A row is cut into tiles of kTile = 4096 elements, and every tile of
//   every row is one CTA, so the work spreads over all SMs for any B.
//   Tiles are handed out in order from an atomic counter, so a tile only
//   ever waits on tiles already running or done (no deadlock whatever
//   order the CTAs are scheduled in).
// - A CTA is 128 threads of 32 elements: eight 16-byte vectors (V = 4) a
//   thread at consecutive warp-wide strides, so every load and store is
//   coalesced, and at 64 registers eight CTAs an SM keep 128 KiB of loads
//   in flight (on an H100 at 700 W, 256 threads of 16 were 1.09-1.22x
//   slower, 512 of 16 1.34-2.02x).  Rows whose length or base is not 16-byte
//   aligned take the scalar form (V = 1).  Bool input is read as 4-byte
//   vectors of four flags.
// - The CTA scans its tile in registers and warp shuffles, publishes its
//   aggregate in a 64-bit status word per (row, tile) (flag in the high
//   half, value in the low, one store), then its first warp looks back 32
//   tiles at a time: the nearest tile with an inclusive prefix ends the
//   walk, tiles with only an aggregate add theirs.  The CTA publishes its
//   own inclusive prefix and writes its elements.
// Sum (mod 2^32) and max are associative and commutative, so the result
// is exact whatever the order the look-back folds in.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;  // elements a thread
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xFFFFFFFFu;
// status word: flag << 32 | value; 0 means the tile has published nothing
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

struct SumOp {
  static constexpr int32_t kIdentity = 0;
  static __device__ __forceinline__ int32_t apply(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};

struct MaxOp {
  static constexpr int32_t kIdentity = INT_MIN;
  static __device__ __forceinline__ int32_t apply(int32_t a, int32_t b) { return a > b ? a : b; }
};

// V consecutive elements at p (aligned to V elements), or the identity
// past the row's end (a chunk is wholly inside or wholly past it).
template <typename In, int V>
__device__ __forceinline__ void load_chunk(const In* p, bool inside, int32_t identity, int32_t (&v)[V]) {
  if (!inside) {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = identity;
    return;
  }
  if constexpr (V == 4 && sizeof(In) == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (V == 4) {
    const uchar4 q = *reinterpret_cast<const uchar4*>(p);
    v[0] = q.x != 0, v[1] = q.y != 0, v[2] = q.z != 0, v[3] = q.w != 0;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = sizeof(In) == 1 ? (int32_t)(p[k] != 0) : (int32_t)p[k];
  }
}

template <int V>
__device__ __forceinline__ void store_chunk(int32_t* p, const int32_t (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

__device__ __forceinline__ unsigned long long read_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void write_status(unsigned long long* p, unsigned long long s) {
  *reinterpret_cast<volatile unsigned long long*>(p) = s;
}

// The tile's exclusive prefix: the fold of every earlier tile of its row.
// Run by one warp; `t` is the tile's index in the row, `status` the row's
// status words.
template <class Op>
__device__ __forceinline__ int32_t look_back(unsigned long long* status, int t, int32_t aggregate, int lane) {
  if (t == 0) {
    if (lane == 0) write_status(status, kPrefix | (uint32_t)aggregate);
    return Op::kIdentity;
  }
  if (lane == 0) write_status(status + t, kAggregate | (uint32_t)aggregate);
  int32_t exclusive = Op::kIdentity;
  for (int pred = t - 1;; pred -= 32) {
    const int i = pred - lane;  // lane 0 reads the nearest tile
    unsigned long long s = kPrefix | (uint32_t)Op::kIdentity;
    if (i >= 0) {
      do {
        s = read_status(status + i);
      } while ((s >> 32) == 0);
    }
    const unsigned done = __ballot_sync(kFull, (s >> 32) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    int32_t v = Op::kIdentity;
    if (lane <= stop) v = (int32_t)(uint32_t)s;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = Op::apply(v, __shfl_xor_sync(kFull, v, d));
    exclusive = Op::apply(exclusive, v);
    if (done) break;
  }
  if (lane == 0) write_status(status + t, kPrefix | (uint32_t)Op::apply(exclusive, aggregate));
  return exclusive;
}

template <class Op, typename In, int V>
__global__ void __launch_bounds__(kThreads)
row_scan_kernel(const In* __restrict__ x, int32_t* __restrict__ out, long long n, int tiles_per_row,
                unsigned long long* __restrict__ status, unsigned int* __restrict__ counter) {
  constexpr int J = kItems / V;  // chunks a thread
  __shared__ int32_t warp_total[J][kWarps];
  __shared__ int32_t tile_exclusive;
  __shared__ unsigned int tile_id;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_id = atomicAdd(counter, 1u);
  __syncthreads();
  const int row = tile_id / tiles_per_row, t = tile_id % tiles_per_row;
  const In* xr = x + (long long)row * n;
  int32_t* outr = out + (long long)row * n;
  const long long base = (long long)t * kTile;

  // chunk j of thread i holds the tile's elements [(j * kThreads + i) * V, +V)
  int32_t v[J][V];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long e = base + (long long)(j * kThreads + threadIdx.x) * V;
    load_chunk<In, V>(xr + e, e < n, Op::kIdentity, v[j]);
  }
  int32_t lane_exclusive[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 1; k < V; ++k) v[j][k] = Op::apply(v[j][k - 1], v[j][k]);
    int32_t s = v[j][V - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s = Op::apply(u, s);
    }
    const int32_t before = __shfl_up_sync(kFull, s, 1);
    lane_exclusive[j] = Op::kIdentity;
    if (lane) lane_exclusive[j] = before;
    if (lane == 31) warp_total[j][warp] = s;
  }
  __syncthreads();

  // each chunk's exclusive prefix inside the tile, and the tile's aggregate
  int32_t running = Op::kIdentity;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    int32_t p = running;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int32_t tw = warp_total[j][w];
      if (w < warp) p = Op::apply(p, tw);
      running = Op::apply(running, tw);
    }
    lane_exclusive[j] = Op::apply(p, lane_exclusive[j]);
  }
  if (warp == 0) {
    const int32_t e = look_back<Op>(status + (long long)row * tiles_per_row, t, running, lane);
    if (lane == 0) tile_exclusive = e;
  }
  __syncthreads();
  const int32_t exclusive = tile_exclusive;

#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long e = base + (long long)(j * kThreads + threadIdx.x) * V;
    if (e >= n) continue;
    const int32_t p = Op::apply(exclusive, lane_exclusive[j]);
#pragma unroll
    for (int k = 0; k < V; ++k) v[j][k] = Op::apply(p, v[j][k]);
    store_chunk<V>(outr + e, v[j]);
  }
}

template <class Op, typename In>
cudaError_t launch(const In* x, int32_t* out, int rows, long long n, unsigned long long* scratch,
                   cudaStream_t stream) {
  const long long tiles_per_row = (n + kTile - 1) / kTile;
  const long long tiles = tiles_per_row * rows;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  auto counter = reinterpret_cast<unsigned int*>(scratch);
  auto status = scratch + 1;
  const bool vec = n % 4 == 0 && (uintptr_t)x % (4 * sizeof(In)) == 0 && (uintptr_t)out % 16 == 0;
  if (vec) {
    row_scan_kernel<Op, In, 4><<<(unsigned)tiles, kThreads, 0, stream>>>(x, out, n, (int)tiles_per_row, status,
                                                                         counter);
  } else {
    row_scan_kernel<Op, In, 1><<<(unsigned)tiles, kThreads, 0, stream>>>(x, out, n, (int)tiles_per_row, status,
                                                                         counter);
  }
  return cudaGetLastError();
}

}  // namespace

// op 0 = sum, 1 = max; in_bool: the input is one byte an element (0 or 1).
// scratch: 1 + rows * ceil(n / kTile) zeroed 64-bit words (a tile counter,
// then the status words), zeroed by the caller before every launch.
extern "C" int ct_row_scan(const void* x, void* out, void* scratch, int rows, long long n, int op,
                           int in_bool, void* stream) {
  if (rows < 0 || n < 0 || op < 0 || op > 1 || (in_bool && op != 0)) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  auto o = (int32_t*)out;
  auto s = (unsigned long long*)scratch;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (in_bool)
    err = launch<SumOp>((const uint8_t*)x, o, rows, n, s, st);
  else if (op == 0)
    err = launch<SumOp>((const int32_t*)x, o, rows, n, s, st);
  else
    err = launch<MaxOp>((const int32_t*)x, o, rows, n, s, st);
  return (int)err;
}
