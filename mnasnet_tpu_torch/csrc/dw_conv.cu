// Fused depthwise k x k conv + per-channel affine (folded BatchNorm) + optional
// ReLU, NHWC, for Hopper (sm_90a).
//
// Replaces the Pallas kernels _dw_s1_kernel (mnasnet_tpu/ops/pallas/dw_conv.py:56)
// and _dw_s2_kernel (:96), reached through _dw_fused_raw (:167). It owes their
// arithmetic, not their structure: x is read in its own dtype, the weights,
// the accumulation, the scale and the bias are fp32, and the result is stored
// once in x's dtype. The TPU's stride-2 parity-plane split exists to avoid
// strided VMEM loads; shared memory has no such problem, so one kernel does
// both strides.
//
// What bounds it on an H100: memory. Per output element it does 2*k*k + 2
// FLOP (18 + 2 for k = 3) against 2 bytes read and 2 written in bf16, far
// below the ~295 FLOP/byte ridge. The separable stem's depthwise at batch 128
// (112x112x32 bf16, k 3, stride 1) moves 205.5 MB: about 61 us at 3.35 TB/s.
//
// Design: one block per (sample, tile of TH output rows at the full output
// width, tile of CB channels). The block stages its input rows plus the k-1
// halo rows in shared memory once, zero-padding in the kernel (no padded copy
// of x ever reaches device memory), then each thread computes output channel
// pairs from the staged tile. Channel pairs keep every global access 4 bytes
// (bf16) or 8 bytes (fp32) wide and coalesced along C. Halo rows are read by
// two neighbouring blocks; the planner in ops/cuda/dw_conv.py picks TH so that
// the tile fits its shared-memory budget, and the re-read mostly hits L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Pack2;

template <> struct Pack2<float> {
  using type = float2;
  static __device__ __forceinline__ float2 to_f2(float2 v) { return v; }
  static __device__ __forceinline__ float2 from_f2(float2 v) { return v; }
  static __device__ __forceinline__ float2 zero() { return make_float2(0.f, 0.f); }
};

template <> struct Pack2<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ __nv_bfloat162 from_f2(float2 v) { return __float22bfloat162_rn(v); }
  static __device__ __forceinline__ __nv_bfloat162 zero() { return __float2bfloat162_rn(0.f); }
};

constexpr int kThreads = 256;

// Shared memory of one block: fp32 weights [K*K][CB], then the input tile
// [(TH-1)*S+K rows][(Wo-1)*S+K cols][CB] in the I/O dtype.
__host__ __device__ inline size_t dw_smem_bytes(int K, int S, int Wo, int TH, int CB,
                                                int elem_bytes) {
  const size_t rows = (size_t)(TH - 1) * S + K;
  const size_t cols = (size_t)(Wo - 1) * S + K;
  return (size_t)K * K * CB * 4 + rows * cols * CB * elem_bytes;
}

template <typename T, int K, int S, bool RELU>
__global__ void __launch_bounds__(kThreads)
dw_conv_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ y, int H, int W, int C, int Ho, int Wo, int TH, int CB) {
  using P2 = typename Pack2<T>::type;
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  P2* xs = reinterpret_cast<P2*>(ws + K * K * CB);

  const int n = blockIdx.z;
  const int ho0 = blockIdx.x * TH;
  const int c0 = blockIdx.y * CB;
  const int th = min(TH, Ho - ho0);
  const int cb = min(CB, C - c0);  // even: C and CB are even
  const int cp = cb / 2;           // channel pairs in this tile
  const int CP = CB / 2;           // pair stride of the staged tile
  const int rows = (th - 1) * S + K;
  const int cols = (Wo - 1) * S + K;
  const int h_in0 = ho0 * S - P;

  for (int i = threadIdx.x; i < K * K * cb; i += blockDim.x) {
    const int tap = i / cb, c = i - tap * cb;
    ws[tap * CB + c] = w[tap * C + c0 + c];
  }
  const P2* x2 = reinterpret_cast<const P2*>(x);
  const int C2 = C / 2;
  for (int i = threadIdx.x; i < rows * cols * cp; i += blockDim.x) {
    const int c = i % cp;
    const int pix = i / cp;
    const int r = pix / cols, col = pix - r * cols;
    const int h = h_in0 + r, ww = col - P;
    P2 v = Pack2<T>::zero();
    if (h >= 0 && h < H && ww >= 0 && ww < W)
      v = x2[((size_t)(n * H + h) * W + ww) * C2 + c0 / 2 + c];
    xs[pix * CP + c] = v;
  }
  __syncthreads();

  P2* y2 = reinterpret_cast<P2*>(y);
  for (int i = threadIdx.x; i < th * Wo * cp; i += blockDim.x) {
    const int c = i % cp;
    const int q = i / cp;
    const int r = q / Wo, wo = q - r * Wo;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float2 v = Pack2<T>::to_f2(xs[((r * S + dy) * cols + wo * S + dx) * CP + c]);
        const float* wt = ws + (dy * K + dx) * CB + 2 * c;
        acc.x += v.x * wt[0];
        acc.y += v.y * wt[1];
      }
    }
    const int cc = c0 + 2 * c;
    float2 o = make_float2(acc.x * scale[cc] + bias[cc], acc.y * scale[cc + 1] + bias[cc + 1]);
    if (RELU) {
      o.x = fmaxf(o.x, 0.f);
      o.y = fmaxf(o.y, 0.f);
    }
    y2[((size_t)(n * Ho + ho0 + r) * Wo + wo) * C2 + cc / 2] = Pack2<T>::from_f2(o);
  }
}

template <typename T, int K, int S, bool RELU>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* y,
           int N, int H, int W, int C, int TH, int CB, cudaStream_t stream) {
  const int Ho = (H + 2 * (K / 2) - K) / S + 1;
  const int Wo = (W + 2 * (K / 2) - K) / S + 1;
  const size_t smem = dw_smem_bytes(K, S, Wo, TH, CB, (int)sizeof(T));
  auto kernel = dw_conv_kernel<T, K, S, RELU>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Ho + TH - 1) / TH, (C + CB - 1) / CB, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), H, W, C, Ho, Wo, TH, CB);
  return (int)cudaGetLastError();
}

template <typename T, int K, int S>
int dispatch_relu(int relu, const void* x, const void* w, const void* scale, const void* bias,
                  void* y, int N, int H, int W, int C, int TH, int CB, cudaStream_t stream) {
  return relu ? launch<T, K, S, true>(x, w, scale, bias, y, N, H, W, C, TH, CB, stream)
              : launch<T, K, S, false>(x, w, scale, bias, y, N, H, W, C, TH, CB, stream);
}

template <typename T>
int dispatch(int k, int stride, int relu, const void* x, const void* w, const void* scale,
             const void* bias, void* y, int N, int H, int W, int C, int TH, int CB,
             cudaStream_t stream) {
  if (k == 3 && stride == 1)
    return dispatch_relu<T, 3, 1>(relu, x, w, scale, bias, y, N, H, W, C, TH, CB, stream);
  if (k == 3 && stride == 2)
    return dispatch_relu<T, 3, 2>(relu, x, w, scale, bias, y, N, H, W, C, TH, CB, stream);
  if (k == 5 && stride == 1)
    return dispatch_relu<T, 5, 1>(relu, x, w, scale, bias, y, N, H, W, C, TH, CB, stream);
  if (k == 5 && stride == 2)
    return dispatch_relu<T, 5, 2>(relu, x, w, scale, bias, y, N, H, W, C, TH, CB, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block for a tile plan; the Python planner
// computes the same number (ops/cuda/dw_conv.py:smem_bytes).
long long dw_conv_smem_bytes(int k, int stride, int Wo, int TH, int CB, int elem_bytes) {
  return (long long)dw_smem_bytes(k, stride, Wo, TH, CB, elem_bytes);
}

// x (N,H,W,C) and y (N,Ho,Wo,C) in bf16 (is_bf16=1) or fp32; w (k,k,C),
// scale and bias (C,) fp32. C and CB even. Returns cudaGetLastError().
int dw_conv_bn_act(const void* x, const void* w, const void* scale, const void* bias, void* y,
                   int N, int H, int W, int C, int k, int stride, int relu, int is_bf16,
                   int TH, int CB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(k, stride, relu, x, w, scale, bias, y, N, H, W, C, TH, CB, s);
  return dispatch<float>(k, stride, relu, x, w, scale, bias, y, N, H, W, C, TH, CB, s);
}

}  // extern "C"
