// Parabolic erosion cascade along one axis of a float32 volume (kernel B3).
//
// Replaces cluster_tools_tpu/ops/pallas_kernels.py::edt_cascade_pallas
// (_edt_kernel): min(radius, n-1) Jacobi iterations of
//     g = min(g, min(shift+1(g) + c, shift-1(g) + c)),  c = w * (2i + 1),
// with `big` shifted in at both ends of every line.
//
// Bound: operations (radius steps of a few float32 operations per voxel
// against one read and one write).  Each step is computed as
// min(g, (min(left, right) + c)): rounding to nearest is monotone, so
// min(fl(a + c), fl(b + c)) == fl(min(a, b) + c) bit for bit, and a step
// costs three float32 operations instead of four.  Arithmetic is
// round-to-nearest without FMA contraction (__fadd_rn / __fmul_rn, and the
// library is built with -fmad=false), so the result is the reference's
// float32 bit for bit.
//
// Design: every line segment lives in registers for all the steps.
// - Contiguous lines (axis 2), n <= 1024: one warp per line, each lane
//   holding VPL consecutive values; a step needs only the neighbouring
//   lanes' end values (__shfl_up_sync / __shfl_down_sync): no shared
//   memory, no block barrier, no division.
// - Strided lines (axes 0 and 1), n <= 1024: a CTA takes 32 adjacent
//   columns (the 32 lanes of a warp, so loads are coalesced) and P <= 16
//   segments of L values along the line (one warp per segment).  Only the
//   segment ends cross threads, through a double-buffered 8 KiB shared
//   array: one barrier and 8 bytes per thread a step.
// Positions past the end of a line (n not a multiple of the segment) hold
// `big` and are never updated, which is what the reference shifts in.
// Longer lines (n > 1024) take the general branch: both Jacobi buffers of
// whole lines in shared memory, one barrier a step.

#include "common.cuh"

namespace {

__device__ __forceinline__ float step_cost(float w, int it) {
  return __fmul_rn(w, __fadd_rn(__fmul_rn(2.0f, (float)it), 1.0f));
}

// One Jacobi step over a segment v[0..N) whose outer neighbours are
// `left` and `right`; positions p0 + j >= n (when kPad) stay as they are.
template <int N, bool kPad>
__device__ __forceinline__ void step_segment(float (&v)[N], float left, float right, float c,
                                             int p0, int n) {
  float prev = left;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float cur = v[j];
    const float nb = j + 1 < N ? v[j + 1] : right;
    const float nv = fminf(cur, __fadd_rn(fminf(prev, nb), c));
    v[j] = (!kPad || p0 + j < n) ? nv : cur;
    prev = cur;
  }
}

// ---- contiguous lines: one warp per line ----

constexpr int kRowWarps = 8;

template <int VPL, bool kPad>
__global__ void __launch_bounds__(32 * kRowWarps)
edt_rows_reg(const float* __restrict__ in, float* __restrict__ out, int rows, int n,
             int radius, float w, float big, bool vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const float* src = in + (size_t)row * n;
  float* dst = out + (size_t)row * n;
  const int p0 = lane * VPL;
  float v[VPL];
  if constexpr (VPL % 4 == 0 && !kPad) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < VPL; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(src + p0 + j);
        v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < VPL; ++j) v[j] = src[p0 + j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < VPL; ++j) v[j] = (!kPad || p0 + j < n) ? src[p0 + j] : big;
  }
  for (int it = 0; it < radius; ++it) {
    float left = __shfl_up_sync(0xffffffffu, v[VPL - 1], 1);
    float right = __shfl_down_sync(0xffffffffu, v[0], 1);
    if (lane == 0) left = big;
    if (lane == 31) right = big;
    step_segment<VPL, kPad>(v, left, right, step_cost(w, it), p0, n);
  }
  if constexpr (VPL % 4 == 0 && !kPad) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < VPL; j += 4)
        *reinterpret_cast<float4*>(dst + p0 + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VPL; ++j)
    if (!kPad || p0 + j < n) dst[p0 + j] = v[j];
}

// ---- strided lines: 32 columns x P segments of L values per CTA ----

constexpr int kMaxSegs = 16;

template <int L, bool kPad>
__global__ void __launch_bounds__(32 * kMaxSegs)
edt_cols_reg(const float* __restrict__ in, float* __restrict__ out, int n, int inner,
             int radius, float w, float big) {
  __shared__ float ends[2][2][kMaxSegs][32];  // [step parity][first, last][segment][column]
  const int c = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int P = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + c;
  const bool live = col < inner;
  const size_t base = (size_t)blockIdx.y * n * inner + col;
  const int p0 = s * L;
  float v[L];
#pragma unroll
  for (int j = 0; j < L; ++j)
    v[j] = (live && (!kPad || p0 + j < n)) ? in[base + (size_t)(p0 + j) * inner] : big;
  for (int it = 0; it < radius; ++it) {
    const int par = it & 1;
    ends[par][0][s][c] = v[0];
    ends[par][1][s][c] = v[L - 1];
    __syncthreads();
    const float left = s > 0 ? ends[par][1][s - 1][c] : big;
    const float right = s < P - 1 ? ends[par][0][s + 1][c] : big;
    step_segment<L, kPad>(v, left, right, step_cost(w, it), p0, n);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < L; ++j)
      if (!kPad || p0 + j < n) out[base + (size_t)(p0 + j) * inner] = v[j];
  }
}

// ---- general branch (lines longer than the register paths take) ----

constexpr int kThreads = 512;

// lines along a strided axis: element (o, i, c) at o*n*inner + i*inner + c
__global__ void __launch_bounds__(kThreads)
edt_cols_smem(const float* __restrict__ in, float* __restrict__ out, int n, int inner, int W,
              int radius, float w, float big) {
  extern __shared__ float buf[];
  float* cur = buf;
  float* nxt = buf + (size_t)n * W;
  const int c0 = blockIdx.x * W;
  const size_t base = (size_t)blockIdx.y * n * inner + c0;
  const int total = n * W;
  for (int s = threadIdx.x; s < total; s += kThreads) {
    const int i = s / W, c = s % W;
    cur[s] = (c0 + c < inner) ? in[base + (size_t)i * inner + c] : big;
  }
  __syncthreads();
  for (int it = 0; it < radius; ++it) {
    const float cst = step_cost(w, it);
    for (int s = threadIdx.x; s < total; s += kThreads) {
      const int i = s / W;
      const float lo = i > 0 ? cur[s - W] : big;
      const float hi = i < n - 1 ? cur[s + W] : big;
      nxt[s] = fminf(cur[s], __fadd_rn(fminf(lo, hi), cst));
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int s = threadIdx.x; s < total; s += kThreads) {
    const int i = s / W, c = s % W;
    if (c0 + c < inner) out[base + (size_t)i * inner + c] = cur[s];
  }
}

// lines along the contiguous axis: row r, element i at r*n + i
__global__ void __launch_bounds__(kThreads)
edt_rows_smem(const float* __restrict__ in, float* __restrict__ out, int rows, int n, int R,
              int radius, float w, float big) {
  extern __shared__ float buf[];
  float* cur = buf;
  float* nxt = buf + (size_t)n * R;
  const int r0 = blockIdx.x * R;
  const int nr = min(R, rows - r0);
  const int total = nr * n;
  const size_t base = (size_t)r0 * n;
  for (int s = threadIdx.x; s < total; s += kThreads) cur[s] = in[base + s];
  __syncthreads();
  for (int it = 0; it < radius; ++it) {
    const float cst = step_cost(w, it);
    for (int s = threadIdx.x; s < total; s += kThreads) {
      const int i = s % n;
      const float lo = i > 0 ? cur[s - 1] : big;
      const float hi = i < n - 1 ? cur[s + 1] : big;
      nxt[s] = fminf(cur[s], __fadd_rn(fminf(lo, hi), cst));
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int s = threadIdx.x; s < total; s += kThreads) out[base + s] = cur[s];
}

constexpr size_t kSmemTarget = 100 * 1024;  // two CTAs per SM
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kRegMax = 1024;  // longest line the register paths hold

template <int VPL>
cudaError_t launch_rows(const float* in, float* out, int rows, int n, int radius, float w,
                        float big, cudaStream_t st) {
  const dim3 grid((rows + kRowWarps - 1) / kRowWarps);
  if (n == 32 * VPL) {
    const bool vec = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
    edt_rows_reg<VPL, false><<<grid, 32 * kRowWarps, 0, st>>>(in, out, rows, n, radius, w, big, vec);
  } else {
    edt_rows_reg<VPL, true><<<grid, 32 * kRowWarps, 0, st>>>(in, out, rows, n, radius, w, big, false);
  }
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_cols(const float* in, float* out, int n, int inner, int outer, int radius,
                        float w, float big, cudaStream_t st) {
  const int P = (n + L - 1) / L;
  const dim3 grid((inner + 31) / 32, outer);
  if (n == P * L)
    edt_cols_reg<L, false><<<grid, 32 * P, 0, st>>>(in, out, n, inner, radius, w, big);
  else
    edt_cols_reg<L, true><<<grid, 32 * P, 0, st>>>(in, out, n, inner, radius, w, big);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ct_edt_cascade(const void* in_, void* out_, int Z, int Y, int X,
                              int axis, int radius, float w, float big,
                              void* stream) {
  if (axis < 0 || axis > 2 || radius < 0) return (int)cudaErrorInvalidValue;
  const long long dims[3] = {Z, Y, X};
  const int n = (int)dims[axis];
  if (n <= 0 || (long long)Z * Y * X == 0) return 0;
  const float* in = (const float*)in_;
  float* out = (float*)out_;
  cudaStream_t st = (cudaStream_t)stream;
  if (axis == 2 && n <= kRegMax) {
    const int rows = Z * Y;
    const int vpl = (n + 31) / 32;
    if (vpl <= 1) return (int)launch_rows<1>(in, out, rows, n, radius, w, big, st);
    if (vpl <= 2) return (int)launch_rows<2>(in, out, rows, n, radius, w, big, st);
    if (vpl <= 4) return (int)launch_rows<4>(in, out, rows, n, radius, w, big, st);
    if (vpl <= 8) return (int)launch_rows<8>(in, out, rows, n, radius, w, big, st);
    if (vpl <= 16) return (int)launch_rows<16>(in, out, rows, n, radius, w, big, st);
    if (vpl <= 18) return (int)launch_rows<18>(in, out, rows, n, radius, w, big, st);
    if (vpl <= 24) return (int)launch_rows<24>(in, out, rows, n, radius, w, big, st);
    return (int)launch_rows<32>(in, out, rows, n, radius, w, big, st);
  }
  if (axis < 2 && n <= kRegMax) {
    const int outer = axis == 0 ? 1 : Z;
    const int inner = axis == 0 ? Y * X : X;
    // the shortest register segment that covers the line in <= 16 segments
    const int need = (n + kMaxSegs - 1) / kMaxSegs;
    if (need <= 1) return (int)launch_cols<1>(in, out, n, inner, outer, radius, w, big, st);
    if (need <= 2) return (int)launch_cols<2>(in, out, n, inner, outer, radius, w, big, st);
    if (need <= 4) return (int)launch_cols<4>(in, out, n, inner, outer, radius, w, big, st);
    if (need <= 8) return (int)launch_cols<8>(in, out, n, inner, outer, radius, w, big, st);
    if (need <= 16) return (int)launch_cols<16>(in, out, n, inner, outer, radius, w, big, st);
    if (need <= 18) return (int)launch_cols<18>(in, out, n, inner, outer, radius, w, big, st);
    if (need <= 32) return (int)launch_cols<32>(in, out, n, inner, outer, radius, w, big, st);
    if (need <= 36) return (int)launch_cols<36>(in, out, n, inner, outer, radius, w, big, st);
    return (int)launch_cols<64>(in, out, n, inner, outer, radius, w, big, st);
  }
  if (axis < 2) {
    const int outer = axis == 0 ? 1 : Z;
    const int inner = axis == 0 ? Y * X : X;
    int W = 32;
    while (W > 1 && 2 * sizeof(float) * (size_t)n * W > kSmemTarget) W /= 2;
    const size_t smem = 2 * sizeof(float) * (size_t)n * W;
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        edt_cols_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((inner + W - 1) / W, outer);
    edt_cols_smem<<<grid, kThreads, smem, st>>>(in, out, n, inner, W, radius, w, big);
  } else {
    const int rows = Z * Y;
    int R = (int)(kSmemTarget / (2 * sizeof(float) * (size_t)n));
    R = R < 1 ? 1 : (R > 64 ? 64 : R);
    const size_t smem = 2 * sizeof(float) * (size_t)n * R;
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        edt_rows_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    edt_rows_smem<<<(rows + R - 1) / R, kThreads, smem, st>>>(in, out, rows, n, R, radius, w, big);
  }
  return (int)cudaGetLastError();
}
