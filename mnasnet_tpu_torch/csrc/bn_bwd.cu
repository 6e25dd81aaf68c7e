// BatchNorm (batch statistics) + ReLU region backward, NHWC, for Hopper (sm_90a).
//
// Replaces the Pallas kernels _reduce_kernel (mnasnet_tpu/ops/pallas/bn_bwd.py:57)
// and _dx_kernel (:86), reached through _bn_bwd_pallas (:129). For
// y = relu(x * a + b), a = gamma * inv, b = beta - mean * a, inv = rsqrt(var + eps):
//
//   g  = dy * [y > 0]                                  (mask recomputed, see below)
//   db = sum g,  dg = sum g * xhat,  xhat = (x - mean) * inv       (bn_bwd_reduce)
//   dx = (gamma * inv) * (g - db / n - xhat * (dg / n))            (bn_bwd_dx)
//
// Everything is fp32 inside; x, dy and dx are bf16 or fp32.
//
// The ReLU mask is the forward's, bit for bit. The forward (ops/cuda/bn_bwd.py:
// _fwd_math) clamps x * a_io + b_io computed as two PyTorch ops in x's dtype,
// with a and b rounded to that dtype first: one rounding after the multiply and
// one after the add. The kernels repeat exactly that (Io<T>::positive): in bf16
// the product of two bf16 values is exact in fp32 and is rounded to bf16, then
// the sum is rounded to bf16; in fp32 __fmul_rn / __fadd_rn keep nvcc from
// contracting the two into one FMA the forward never did. a and b are computed
// from the fp32 vectors with the same intrinsics, as PyTorch computes them.
// One flipped element would leak gradient through a unit the forward clamped.
//
// What bounds them on an H100: memory. The reduce reads x and dy once, the dx
// pass reads both again and writes dx: per element about 10 fp32 operations
// against 4 (reduce) or 6 (dx) bytes moved in bf16. Over the 35 BN+ReLU regions
// of mnasnet1_0 @ 224 at batch 128 (614 M elements) that is 0.73 ms and 1.10 ms
// at 3.35 TB/s.
//
// Design. The TPU reduce carries its sums from one grid step to the next; here
// blocks run in no order, so the reduce is two-stage and deterministic, with no
// atomics: every block owns a tile of channels and a slab of rows (N*H*W rows
// of C channels), each thread walks the slab's rows for one channel pair
// (4-byte bf16 pairs or 8-byte fp32 pairs, coalesced along C), the block sums
// its row lanes in a fixed order in shared memory and writes one fp32 partial
// per channel and slab; a second small kernel sums the slabs' partials in a
// fixed order (32 slab lanes per channel, then the lanes in order). The dx
// pass uses the same tiling, so each thread computes its channels' constants
// once and then streams rows. The planner in ops/cuda/bn_bwd.py picks the
// tile and the slab count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Io;

template <> struct Io<float> {
  using P2 = float2;
  static __device__ __forceinline__ float2 to_f2(float2 v) { return v; }
  static __device__ __forceinline__ float2 from_f2(float2 v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  // The forward's x * a + b > 0 in fp32: two roundings, never an FMA.
  static __device__ __forceinline__ bool positive(float x, float a, float b) {
    return __fadd_rn(__fmul_rn(x, a), b) > 0.f;
  }
};

template <> struct Io<__nv_bfloat16> {
  using P2 = __nv_bfloat162;
  static __device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ __nv_bfloat162 from_f2(float2 v) { return __float22bfloat162_rn(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // The forward's x * a + b > 0 in bf16: the product and the sum each rounded
  // to bf16, as two PyTorch bf16 ops round them.
  static __device__ __forceinline__ bool positive(float x, float a, float b) {
    const float p = round(__fmul_rn(x, a));
    return round(__fadd_rn(p, b)) > 0.f;
  }
};

// Per-channel factors of the forward, rounded to the I/O dtype as the forward
// rounds them: a = gamma * inv, b = beta - mean * a.
template <typename T>
__device__ __forceinline__ void mask_factors(float mean, float inv, float gamma, float beta,
                                             float* a_io, float* b_io) {
  const float a = __fmul_rn(gamma, inv);
  const float b = __fsub_rn(beta, __fmul_rn(mean, a));
  *a_io = Io<T>::round(a);
  *b_io = Io<T>::round(b);
}

// Block geometry shared by both kernels: blockDim.x = TP channel pairs,
// blockDim.y = R row lanes; blockIdx.x = slab, blockIdx.y = channel tile.
struct Tile {
  long long row0, row1;  // rows of this block's slab
  int pair;              // channel pair of this thread (global), or -1
};

__device__ __forceinline__ Tile tile_of(long long M, int C2, long long rows_per_slab) {
  Tile t;
  t.row0 = (long long)blockIdx.x * rows_per_slab;
  t.row1 = min(M, t.row0 + rows_per_slab);
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  t.pair = p < C2 ? p : -1;
  return t;
}

template <typename T>
__global__ void bn_reduce_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ inv,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         float* __restrict__ partial, long long M, int C,
                                         long long rows_per_slab) {
  using P2 = typename Io<T>::P2;
  extern __shared__ float red[];  // [R][TP][4]: db0, db1, dg0, dg1
  const int C2 = C / 2;
  const Tile t = tile_of(M, C2, rows_per_slab);
  float db0 = 0.f, db1 = 0.f, dg0 = 0.f, dg1 = 0.f;
  if (t.pair >= 0) {
    const int c = 2 * t.pair;
    float a0, b0, a1, b1;
    mask_factors<T>(mean[c], inv[c], gamma[c], beta[c], &a0, &b0);
    mask_factors<T>(mean[c + 1], inv[c + 1], gamma[c + 1], beta[c + 1], &a1, &b1);
    const float m0 = mean[c], m1 = mean[c + 1], i0 = inv[c], i1 = inv[c + 1];
    const P2* x2 = reinterpret_cast<const P2*>(x);
    const P2* dy2 = reinterpret_cast<const P2*>(dy);
    for (long long r = t.row0 + threadIdx.y; r < t.row1; r += blockDim.y) {
      const size_t off = (size_t)r * C2 + t.pair;
      const float2 xv = Io<T>::to_f2(x2[off]);
      const float2 dv = Io<T>::to_f2(dy2[off]);
      const float g0 = Io<T>::positive(xv.x, a0, b0) ? dv.x : 0.f;
      const float g1 = Io<T>::positive(xv.y, a1, b1) ? dv.y : 0.f;
      db0 += g0;
      db1 += g1;
      dg0 += g0 * ((xv.x - m0) * i0);
      dg1 += g1 * ((xv.y - m1) * i1);
    }
  }
  const int TP = blockDim.x;
  float* mine = red + 4 * (threadIdx.y * TP + threadIdx.x);
  mine[0] = db0;
  mine[1] = db1;
  mine[2] = dg0;
  mine[3] = dg1;
  __syncthreads();
  if (threadIdx.y == 0 && t.pair >= 0) {
    for (int l = 1; l < (int)blockDim.y; ++l) {  // row lanes in a fixed order
      const float* o = red + 4 * (l * TP + threadIdx.x);
      db0 += o[0];
      db1 += o[1];
      dg0 += o[2];
      dg1 += o[3];
    }
    // partial: [2][slabs][C], db first, then dg.
    const size_t slabs = gridDim.x;
    float* pdb = partial + (size_t)blockIdx.x * C + 2 * t.pair;
    float* pdg = pdb + slabs * C;
    pdb[0] = db0;
    pdb[1] = db1;
    pdg[0] = dg0;
    pdg[1] = dg1;
  }
}

// Sums the slabs' partials: block (kFinalC channels, kFinalLanes lanes);
// lane l sums slabs l, l + kFinalLanes, ... in order, then lane 0 adds the
// lanes in order. The order is fixed, so every run gives the same sums.
constexpr int kFinalC = 32;
constexpr int kFinalLanes = 32;

__global__ void __launch_bounds__(kFinalC * kFinalLanes)
bn_reduce_final_kernel(const float* __restrict__ partial, float* __restrict__ dg,
                       float* __restrict__ db, int C, int slabs) {
  __shared__ float red[kFinalLanes][kFinalC][2];
  const int c = blockIdx.x * kFinalC + threadIdx.x;
  float sb = 0.f, sg = 0.f;
  if (c < C) {
    const float* pdb = partial + c;
    const float* pdg = partial + (size_t)slabs * C + c;
#pragma unroll 4
    for (int s = threadIdx.y; s < slabs; s += kFinalLanes) {
      sb += pdb[(size_t)s * C];
      sg += pdg[(size_t)s * C];
    }
  }
  red[threadIdx.y][threadIdx.x][0] = sb;
  red[threadIdx.y][threadIdx.x][1] = sg;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int l = 1; l < kFinalLanes; ++l) {
      sb += red[l][threadIdx.x][0];
      sg += red[l][threadIdx.x][1];
    }
    db[c] = sb;
    dg[c] = sg;
  }
}

template <typename T>
__global__ void bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                             const float* __restrict__ mean, const float* __restrict__ inv,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const float* __restrict__ dg, const float* __restrict__ db,
                             T* __restrict__ dx, long long M, int C, float inv_n,
                             long long rows_per_slab) {
  using P2 = typename Io<T>::P2;
  const int C2 = C / 2;
  const Tile t = tile_of(M, C2, rows_per_slab);
  if (t.pair < 0) return;
  const int c = 2 * t.pair;
  float a0, b0, a1, b1;
  mask_factors<T>(mean[c], inv[c], gamma[c], beta[c], &a0, &b0);
  mask_factors<T>(mean[c + 1], inv[c + 1], gamma[c + 1], beta[c + 1], &a1, &b1);
  const float m0 = mean[c], m1 = mean[c + 1], i0 = inv[c], i1 = inv[c + 1];
  const float s0 = gamma[c] * i0, s1 = gamma[c + 1] * i1;
  const float cb0 = inv_n * db[c], cb1 = inv_n * db[c + 1];
  const float cg0 = inv_n * dg[c], cg1 = inv_n * dg[c + 1];
  const P2* x2 = reinterpret_cast<const P2*>(x);
  const P2* dy2 = reinterpret_cast<const P2*>(dy);
  P2* dx2 = reinterpret_cast<P2*>(dx);
  for (long long r = t.row0 + threadIdx.y; r < t.row1; r += blockDim.y) {
    const size_t off = (size_t)r * C2 + t.pair;
    const float2 xv = Io<T>::to_f2(x2[off]);
    const float2 dv = Io<T>::to_f2(dy2[off]);
    const float g0 = Io<T>::positive(xv.x, a0, b0) ? dv.x : 0.f;
    const float g1 = Io<T>::positive(xv.y, a1, b1) ? dv.y : 0.f;
    float2 o;
    o.x = s0 * (g0 - cb0 - ((xv.x - m0) * i0) * cg0);
    o.y = s1 * (g1 - cb1 - ((xv.y - m1) * i1) * cg1);
    dx2[off] = Io<T>::from_f2(o);
  }
}

template <typename T>
int reduce(const void* x, const void* dy, const float* mean, const float* inv,
           const float* gamma, const float* beta, float* partial, float* dg, float* db,
           long long M, int C, int TP, int R, int slabs, cudaStream_t stream) {
  const long long rows_per_slab = (M + slabs - 1) / slabs;
  const dim3 grid(slabs, (C / 2 + TP - 1) / TP);
  const dim3 block(TP, R);
  const size_t smem = (size_t)4 * TP * R * sizeof(float);
  bn_reduce_partial_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, gamma, beta, partial, M,
      C, rows_per_slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_reduce_final_kernel<<<(C + kFinalC - 1) / kFinalC, dim3(kFinalC, kFinalLanes), 0, stream>>>(
      partial, dg, db, C, slabs);
  return (int)cudaGetLastError();
}

template <typename T>
int dx_pass(const void* x, const void* dy, const float* mean, const float* inv,
            const float* gamma, const float* beta, const float* dg, const float* db, void* dx,
            long long M, int C, float inv_n, int TP, int R, int slabs, cudaStream_t stream) {
  const long long rows_per_slab = (M + slabs - 1) / slabs;
  const dim3 grid(slabs, (C / 2 + TP - 1) / TP);
  const dim3 block(TP, R);
  bn_dx_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, gamma, beta, dg, db,
      static_cast<T*>(dx), M, C, inv_n, rows_per_slab);
  return (int)cudaGetLastError();
}

bool bad_plan(long long M, int C, int TP, int R, int slabs) {
  return M <= 0 || C <= 0 || C % 2 || TP <= 0 || R <= 0 || TP * R > 1024 || slabs <= 0 ||
         slabs > 65535 || (C / 2 + TP - 1) / TP > 65535;
}

}  // namespace

extern "C" {

// x, dy (M = N*H*W rows, C) in bf16 (is_bf16=1) or fp32; mean, inv, gamma,
// beta (C,) fp32; partial (2, slabs, C) fp32 scratch; dg, db (C,) fp32 out.
// C even. Returns the first non-zero cudaGetLastError() of its two launches.
int bn_bwd_reduce(const void* x, const void* dy, const void* mean, const void* inv,
                  const void* gamma, const void* beta, void* partial, void* dg, void* db,
                  long long M, int C, int TP, int R, int slabs, int is_bf16, void* stream) {
  if (bad_plan(M, C, TP, R, slabs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *m = static_cast<const float*>(mean), *i = static_cast<const float*>(inv),
              *g = static_cast<const float*>(gamma), *b = static_cast<const float*>(beta);
  float *p = static_cast<float*>(partial), *dgp = static_cast<float*>(dg),
        *dbp = static_cast<float*>(db);
  if (is_bf16)
    return reduce<__nv_bfloat16>(x, dy, m, i, g, b, p, dgp, dbp, M, C, TP, R, slabs, s);
  return reduce<float>(x, dy, m, i, g, b, p, dgp, dbp, M, C, TP, R, slabs, s);
}

// The same inputs plus dg, db (C,) fp32; dx (M, C) in x's dtype out.
int bn_bwd_dx(const void* x, const void* dy, const void* mean, const void* inv,
              const void* gamma, const void* beta, const void* dg, const void* db, void* dx,
              long long M, int C, float inv_n, int TP, int R, int slabs, int is_bf16,
              void* stream) {
  if (bad_plan(M, C, TP, R, slabs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *m = static_cast<const float*>(mean), *i = static_cast<const float*>(inv),
              *g = static_cast<const float*>(gamma), *b = static_cast<const float*>(beta),
              *dgp = static_cast<const float*>(dg), *dbp = static_cast<const float*>(db);
  if (is_bf16)
    return dx_pass<__nv_bfloat16>(x, dy, m, i, g, b, dgp, dbp, dx, M, C, inv_n, TP, R, slabs, s);
  return dx_pass<float>(x, dy, m, i, g, b, dgp, dbp, dx, M, C, inv_n, TP, R, slabs, s);
}

}  // extern "C"
