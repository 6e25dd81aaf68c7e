// Fused depthwise k x k conv + per-channel affine (folded BatchNorm) + optional
// ReLU or SiLU, NHWC, for Hopper (sm_90a).
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
// Design. One block owns one sample, a group of CG channels (a multiple of 8)
// and a band of TH output rows at the full output width. It walks down the
// band RP output rows at a time (RP rows side by side, one thread set each)
// and keeps a ring of input rows in shared memory: while it computes a step
// from (RP-1)*S + K of them, 16-byte cp.async copies bring the RP*S rows that
// the next step adds. Each input row of the band thus comes from device
// memory once, and its load overlaps the previous step's compute; only the
// K - S halo rows at a band's edge are read twice. A small plane (7x7, 14x14)
// is one band loaded whole, and RP puts enough threads on it.
// Zero padding (rows above and below the image, columns left and right of it)
// comes from cp.async's src-size 0, which fills the 16 bytes with zeros: no
// padded copy of x exists anywhere.
// Each thread owns 8 channels (one 16-byte vector in bf16, two in fp32) and
// a strip of R consecutive outputs of the row. Per tap row it slides over the
// (R-1)*S + K input columns of its strip once, so shared loads per output fall
// from K*K to ((R-1)*S + K)*K/R, and it stores its outputs as 16-byte vectors.
// Weights sit in shared memory as fp32 [tap][half][vector][4], so a warp's
// 16-byte weight loads are conflict-free; at k = 5 the weight loads are most
// of the shared traffic, and strips of 7 outputs (every width of the model at
// 224 px is a multiple of 7) cut them per output.
// Scale and bias wait in shared memory for the epilogue, which keeps the
// registers for the strip's accumulators. The epilogue's activation is a
// template parameter: none, ReLU, or SiLU (EfficientNet's eval forward),
// o / (1 + exp(-o)) in fp32 before the one cast, as PyTorch's silu computes
// it; no kernel branches on it at run time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 channels of the I/O dtype <-> 8 floats.
template <typename T> struct Vec8;

template <> struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    uint4 raw;
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(f[2 * i], f[2 * i + 1]));
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <> struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// Input columns of one ring row: the strips cover ceil(Wo/R)*R outputs.
__host__ __device__ inline int ring_cols(int K, int S, int Wo, int R) {
  return (((Wo + R - 1) / R) * R - 1) * S + K;
}

// Ring rows of a block: a step of RP output rows reads (RP-1)*S + K input
// rows while the next step's RP*S rows arrive; a band that fits whole is
// loaded whole, and its slots never wrap.
__host__ __device__ inline int ring_rows(int K, int S, int TH, int RP) {
  const int ring = K + S * (2 * RP - 1), band = (TH - 1) * S + K;
  return ring < band ? ring : band;
}

// Shared memory of one block: fp32 weights [K*K][CG], scale and bias [2][CG],
// then the ring of input rows [ring_cols][CG] in the I/O dtype.
__host__ __device__ inline size_t dw_smem_bytes(int K, int S, int Wo, int TH, int CG, int R,
                                                int RP, int elem_bytes) {
  return (size_t)(K * K + 2) * CG * 4 +
         (size_t)ring_rows(K, S, TH, RP) * ring_cols(K, S, Wo, R) * CG * elem_bytes;
}

// A launch plan: TH output rows per block, CG channels per block, R outputs
// per thread along W, RP output rows computed side by side.
struct Plan {
  int TH, CG, R, RP;
};

template <typename T, int K, int S, int R, bool RELU, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
dw_conv_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ y, int H, int W, int C, int Ho, int Wo, Plan pl, int groups) {
  constexpr int P = K / 2;
  constexpr int WIN = (R - 1) * S + K;   // input columns of one strip
  constexpr int EPC = 16 / sizeof(T);    // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int CG = pl.CG, RP = pl.RP;
  const int NR = ring_rows(K, S, pl.TH, RP);
  const int cols = ring_cols(K, S, Wo, R);
  float* ws = reinterpret_cast<float*>(smem);
  float* affine = ws + K * K * CG;  // scale [CG], then bias [CG]
  T* ring = reinterpret_cast<T*>(affine + 2 * CG);
  const int row_elems = cols * CG;

  const int n = blockIdx.y;
  const int band = blockIdx.x / groups;
  const int c0 = (blockIdx.x - band * groups) * CG;
  const int ho0 = band * pl.TH;
  const int th = min(pl.TH, Ho - ho0);
  const int band_rows = (th - 1) * S + K;
  const int hi0 = ho0 * S - P;           // image row of the band's first input row
  const int NV = CG / 8;
  const int strips = (Wo + R - 1) / R;
  const int tid = threadIdx.x;

  // Input rows [i0, i1) of the band (image row hi0 + i) into ring slots i % NR.
  const int chunks_per_col = CG / EPC;
  const int row_chunks = cols * chunks_per_col;
  auto load_rows = [&](int i0, int i1) {
    i1 = min(i1, band_rows);
    for (int q = tid; q < (i1 - i0) * row_chunks; q += blockDim.x) {
      const int i = i0 + q / row_chunks, rq = q % row_chunks;
      const int col = rq / chunks_per_col;
      const int e = (rq - col * chunks_per_col) * EPC;
      const int h = hi0 + i, wi = col - P;
      const bool ok = h >= 0 && h < H && wi >= 0 && wi < W;
      cp_async16(ring + (i % NR) * row_elems + col * CG + e,
                 ok ? x + (((size_t)n * H + h) * W + wi) * C + c0 + e : x, ok);
    }
  };

  // Weights: ws[((tap * 2 + half) * NV + v) * 4 + i] = w[tap][c0 + v*8 + half*4 + i].
  for (int i = tid; i < K * K * CG; i += blockDim.x) {
    const int tap = i / CG, c = i - tap * CG;
    const int v = c / 8, half = (c / 4) & 1, j = c & 3;
    ws[((tap * 2 + half) * NV + v) * 4 + j] = w[tap * C + c0 + c];
  }
  for (int i = tid; i < CG; i += blockDim.x) {
    affine[i] = scale[c0 + i];
    affine[CG + i] = bias[c0 + i];
  }
  load_rows(0, (RP - 1) * S + K);
  cp_async_commit();

  const int v = tid % NV;                // this thread's channel vector
  const int strip = (tid / NV) % strips;
  const int rr = tid / (NV * strips);    // its row within a step
  const int wo0 = strip * R;

  for (int t0 = 0; t0 < th; t0 += RP) {
    __syncthreads();  // the previous step is done with the slots about to be refilled
    load_rows((t0 + RP - 1) * S + K, (t0 + 2 * RP - 1) * S + K);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int t = t0 + rr;
    if (t >= th) continue;

    float acc[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const T* row = ring + ((t * S + dy) % NR) * row_elems + (wo0 * S) * CG + v * 8;
      float wk[K][8];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float4 a = *reinterpret_cast<const float4*>(ws + (((dy * K + dx) * 2) * NV + v) * 4);
        const float4 b =
            *reinterpret_cast<const float4*>(ws + (((dy * K + dx) * 2 + 1) * NV + v) * 4);
        wk[dx][0] = a.x; wk[dx][1] = a.y; wk[dx][2] = a.z; wk[dx][3] = a.w;
        wk[dx][4] = b.x; wk[dx][5] = b.y; wk[dx][6] = b.z; wk[dx][7] = b.w;
      }
#pragma unroll
      for (int c = 0; c < WIN; ++c) {
        float xv[8];
        Vec8<T>::load(row + c * CG, xv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int dx = c - r * S;
          if (dx >= 0 && dx < K) {
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][i] += xv[i] * wk[dx][i];
          }
        }
      }
    }
    T* out = y + (((size_t)n * Ho + ho0 + t) * Wo + wo0) * C + c0 + v * 8;
    float sc[8], bi[8];
    Vec8<float>::load(affine + v * 8, sc);
    Vec8<float>::load(affine + CG + v * 8, bi);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (wo0 + r < Wo) {
        float o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[i] = acc[r][i] * sc[i] + bi[i];
          if (RELU) o[i] = fmaxf(o[i], 0.f);
          if (SILU) o[i] = o[i] / (1.f + expf(-o[i]));
        }
        Vec8<T>::store(out + (size_t)r * C, o);
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int K, int S, int R, bool RELU, bool SILU>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* y,
           int N, int H, int W, int C, Plan pl, cudaStream_t stream) {
  const int Ho = (H + 2 * (K / 2) - K) / S + 1;
  const int Wo = (W + 2 * (K / 2) - K) / S + 1;
  const int threads = (pl.CG / 8) * ((Wo + R - 1) / R) * pl.RP;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = dw_smem_bytes(K, S, Wo, pl.TH, pl.CG, R, pl.RP, (int)sizeof(T));
  auto kernel = dw_conv_kernel<T, K, S, R, RELU, SILU>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = C / pl.CG;
  const dim3 grid(((Ho + pl.TH - 1) / pl.TH) * groups, N);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), H, W, C, Ho, Wo, pl, groups);
  return (int)cudaGetLastError();
}

// act: 0 none, 1 ReLU, 2 SiLU.
template <typename T, int K, int S, int R>
int dispatch_act(int act, const void* x, const void* w, const void* scale, const void* bias,
                 void* y, int N, int H, int W, int C, Plan pl, cudaStream_t s) {
#define DW_ARGS x, w, scale, bias, y, N, H, W, C, pl, s
  if (act == 1) return launch<T, K, S, R, true, false>(DW_ARGS);
  if (act == 2) return launch<T, K, S, R, false, true>(DW_ARGS);
  if (act == 0) return launch<T, K, S, R, false, false>(DW_ARGS);
#undef DW_ARGS
  return (int)cudaErrorInvalidValue;
}

template <typename T, int K, int S>
int dispatch_strip(int act, const void* x, const void* w, const void* scale, const void* bias,
                   void* y, int N, int H, int W, int C, Plan pl, cudaStream_t s) {
#define DW_ARGS act, x, w, scale, bias, y, N, H, W, C, pl, s
  if (pl.R == 2) return dispatch_act<T, K, S, 2>(DW_ARGS);
  if (pl.R == 7) return dispatch_act<T, K, S, 7>(DW_ARGS);
#undef DW_ARGS
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(int k, int stride, int relu, const void* x, const void* w, const void* scale,
             const void* bias, void* y, int N, int H, int W, int C, Plan pl, cudaStream_t s) {
#define DW_ARGS relu, x, w, scale, bias, y, N, H, W, C, pl, s
  if (k == 3 && stride == 1) return dispatch_strip<T, 3, 1>(DW_ARGS);
  if (k == 3 && stride == 2) return dispatch_strip<T, 3, 2>(DW_ARGS);
  if (k == 5 && stride == 1) return dispatch_strip<T, 5, 1>(DW_ARGS);
  if (k == 5 && stride == 2) return dispatch_strip<T, 5, 2>(DW_ARGS);
#undef DW_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block for a plan; the Python planner computes
// the same number (ops/cuda/dw_conv.py:smem_bytes).
long long dw_conv_smem_bytes(int k, int stride, int Wo, int TH, int CG, int R, int RP,
                             int elem_bytes) {
  return (long long)dw_smem_bytes(k, stride, Wo, TH, CG, R, RP, elem_bytes);
}

// x (N,H,W,C) and y (N,Ho,Wo,C) in bf16 (is_bf16=1) or fp32, 16-byte
// aligned; w (k,k,C), scale and bias (C,) fp32. Plan: TH output rows per
// block, CG channels per block (a multiple of 8 dividing C), R outputs per
// thread (2 or 7), RP rows side by side; (CG/8)*ceil(Wo/R)*RP threads, at
// most 512. relu: the epilogue's activation, 0 none, 1 ReLU, 2 SiLU. Returns
// cudaGetLastError().
int dw_conv_bn_act(const void* x, const void* w, const void* scale, const void* bias, void* y,
                   int N, int H, int W, int C, int k, int stride, int relu, int is_bf16,
                   int TH, int CG, int R, int RP, void* stream) {
  if (CG % 8 || C % CG || TH < 1 || RP < 1) return (int)cudaErrorInvalidValue;
  const Plan pl{TH, CG, R, RP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(k, stride, relu, x, w, scale, bias, y, N, H, W, C, pl, s);
  return dispatch<float>(k, stride, relu, x, w, scale, bias, y, N, H, W, C, pl, s);
}

}  // extern "C"
