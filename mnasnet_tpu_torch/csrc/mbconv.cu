// The whole inference MBConv block in one kernel, NHWC, for Hopper (sm_90a):
//   expand 1x1 GEMM -> folded BN -> ReLU -> depthwise k x k (stride 1/2)
//   -> folded BN -> ReLU -> project 1x1 GEMM -> folded BN [+ residual]
//
// Replaces the Pallas kernel _mbconv_kernel (mnasnet_tpu/ops/pallas/mbconv.py:58),
// reached through mbconv_fused (:141). It owes that kernel its arithmetic and
// its point, which is that the expanded tensor (3x or 6x the block's input)
// never reaches device memory: the block reads x once and writes y once.
// Rounding, as in the Pallas kernel (:80-126): weights in the I/O dtype; the
// expand accumulates in fp32, applies its affine and ReLU in fp32 and rounds
// once to the I/O dtype (mid); the depthwise does the same (z); the project
// accumulates in fp32, applies its affine in fp32 and adds the residual in
// fp32 before the one store.
//
// What bounds it on an H100: at batch 128 in bf16 the early blocks move more
// bytes than their FLOPs need (s0b0: 70.7 MB against 3.7 GFLOP, a bound of
// 21 us at 3.35 TB/s) and the late ones are bound by FLOPs (s5b0: 7.5 GFLOP).
// This first version runs its three products as SIMT fp32 FMAs, so it is
// bound by the SMs' FMA rate (67 TFLOP/s), not by the tensor cores (989);
// wgmma, TMA and mma.sync are later work.
//
// Design. The TPU kernel keeps a whole padded plane of the expanded tensor
// per sample in VMEM (up to 114x114x72 bf16 = 1.9 MB); a Hopper block has at
// most 227 KB of shared memory. So one block owns a tile of TH x TW output
// pixels of one sample:
//   1. it stages the tile's input halo, ((TH-1)*s+k) x ((TW-1)*s+k) pixels
//      x Cin, clipped to the image, in shared memory once;
//   2. it walks Cmid in chunks of MC channels; per chunk it
//      a. expands the halo pixels that lie inside the image into a shared
//         mid tile (positions outside the image stay 0: the reference pads
//         the expanded tensor with zeros, it does not expand a zero-padded x);
//      b. runs the depthwise conv from the mid tile into a shared z tile;
//      c. accumulates z . wp into an fp32 tile of TH*TW x Cout in shared memory;
//   3. the epilogue applies the project affine, adds the residual from the
//      staged x, and stores y once.
// Halo pixels are expanded again by each neighbouring tile; the planner in
// ops/cuda/mbconv.py picks the tile that keeps that recompute smallest within
// the shared-memory budget, and PERF.md records its cost. Weights are read
// from global memory, where every block of the grid shares them in L2.
// The GEMMs give each thread a 4 x 4 register tile and step the reduction two
// channels at a time, so every shared-memory load is a 2-element pair; row
// strides are padded by 2 elements to spread the pairs over the banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads of a block are a launch argument (ops/cuda/mbconv.py:THREADS).
constexpr int kMaxThreads = 512;

template <typename T> struct IO;

template <> struct IO<float> {
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ void copy2(float* d, const float* s) {
    *reinterpret_cast<float2*>(d) = *reinterpret_cast<const float2*>(s);
  }
};

template <> struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
  }
  static __device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ void copy2(__nv_bfloat16* d, const __nv_bfloat16* s) {
    *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
  }
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Shared-memory plan of one block; ops/cuda/mbconv.py:smem_bytes computes the
// same total.
struct Layout {
  int xs_stride, mid_stride, z_stride;  // elements per pixel (padded by 2)
  size_t off_mid, off_z, off_acc, off_wd, off_vec, total;
};

__host__ __device__ inline Layout mb_layout(int TH, int TW, int MC, int Cin, int Cout, int K,
                                            int S, int eb) {
  Layout L;
  const size_t halo = (size_t)((TH - 1) * S + K) * ((TW - 1) * S + K);
  L.xs_stride = Cin + 2;
  L.mid_stride = MC + 2;
  L.z_stride = MC + 2;
  size_t off = align16(halo * L.xs_stride * eb);     // x halo, in-image part
  L.off_mid = off;
  off += align16(halo * L.mid_stride * eb);           // expanded chunk
  L.off_z = off;
  off += align16((size_t)TH * TW * L.z_stride * eb);  // depthwise output chunk
  L.off_acc = off;
  off += align16((size_t)TH * TW * Cout * 4);         // fp32 project accumulator
  L.off_wd = off;
  off += align16((size_t)K * K * MC * 4);             // fp32 dw weights of the chunk
  L.off_vec = off;
  off += align16((size_t)4 * MC * 4);                 // se, be, sd, bd of the chunk
  L.total = off;
  return L;
}

template <typename T, int K, int S, bool RES>
__global__ void __launch_bounds__(kMaxThreads)
mbconv_kernel(const T* __restrict__ x, const T* __restrict__ we, const float* __restrict__ se,
              const float* __restrict__ be, const T* __restrict__ wd,
              const float* __restrict__ sd, const float* __restrict__ bd,
              const T* __restrict__ wp, const float* __restrict__ sp,
              const float* __restrict__ bp, T* __restrict__ y, int H, int W, int Cin, int Cmid,
              int Cout, int Ho, int Wo, int TH, int TW, int MC, int tiles_w) {
  using io = IO<T>;
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = mb_layout(TH, TW, MC, Cin, Cout, K, S, (int)sizeof(T));
  T* xs = reinterpret_cast<T*>(smem);
  T* mid = reinterpret_cast<T*>(smem + L.off_mid);
  T* zs = reinterpret_cast<T*>(smem + L.off_z);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  float* wds = reinterpret_cast<float*>(smem + L.off_wd);
  float* vec = reinterpret_cast<float*>(smem + L.off_vec);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = blockIdx.y;
  const int oh0 = (blockIdx.x / tiles_w) * TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int th = min(TH, Ho - oh0), tw = min(TW, Wo - ow0);
  const int hr = (th - 1) * S + K, hc = (tw - 1) * S + K;  // this tile's halo
  const int h_in0 = oh0 * S - P, w_in0 = ow0 * S - P;      // image coords of halo (0, 0)
  // The in-image part of the halo: rows [r0, r1), cols [c0, c1).
  const int r0 = max(0, -h_in0), r1 = min(hr, H - h_in0);
  const int c0 = max(0, -w_in0), c1 = min(hc, W - w_in0);
  const int nc = c1 - c0;
  const int M1 = (r1 - r0) * nc;  // pixels to expand
  const int Mo = th * tw;         // output pixels

  // Stage x: xs[m][Cin], m = (r - r0) * nc + (c - c0).
  const int cin2 = Cin / 2;
  for (int i = tid; i < M1 * cin2; i += nt) {
    const int m = i / cin2, c = (i - m * cin2) * 2;
    const int r = r0 + m / nc, col = c0 + m % nc;
    io::copy2(xs + m * L.xs_stride + c,
              x + (((size_t)n * H + h_in0 + r) * W + (w_in0 + col)) * Cin + c);
  }
  // Zero the mid tile once: positions outside the image are never written.
  {
    uint32_t* m32 = reinterpret_cast<uint32_t*>(mid);
    const int words = hr * hc * L.mid_stride * (int)sizeof(T) / 4;
    for (int i = tid; i < words; i += nt) m32[i] = 0u;
  }
  for (int i = tid; i < Mo * Cout; i += nt) acc[i] = 0.f;

  for (int m0 = 0; m0 < Cmid; m0 += MC) {
    const int mc = min(MC, Cmid - m0);
    __syncthreads();  // the previous chunk is done with wds, vec, mid and zs
    for (int i = tid; i < mc; i += nt) {
      vec[i] = se[m0 + i];
      vec[MC + i] = be[m0 + i];
      vec[2 * MC + i] = sd[m0 + i];
      vec[3 * MC + i] = bd[m0 + i];
    }
    for (int i = tid; i < K * K * mc; i += nt) {
      const int tap = i / mc, c = i - tap * mc;
      wds[tap * MC + c] = io::to_f(wd[(size_t)tap * Cmid + m0 + c]);
    }
    __syncthreads();

    // a. expand: mid[pixel][j] = relu((x . we)[pixel][m0 + j] * se + be), j < mc.
    {
      const int ng = mc / 4;
      const int tiles = ((M1 + 3) / 4) * ng;
      for (int t = tid; t < tiles; t += nt) {
        const int rg = t / ng, col = (t - rg * ng) * 4;
        const int row = rg * 4;
        const T* xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xr[i] = xs + min(row + i, M1 - 1) * L.xs_stride;
        const T* wcol = we + m0 + col;
        float a[4][4] = {};
#pragma unroll 2
        for (int c = 0; c < Cin; c += 2) {
          const float4 w0 = io::ldg4(wcol + (size_t)c * Cmid);
          const float4 w1 = io::ldg4(wcol + (size_t)(c + 1) * Cmid);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 v = io::load2(xr[i] + c);
            a[i][0] += v.x * w0.x + v.y * w1.x;
            a[i][1] += v.x * w0.y + v.y * w1.y;
            a[i][2] += v.x * w0.z + v.y * w1.z;
            a[i][3] += v.x * w0.w + v.y * w1.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = row + i;
          if (m >= M1) break;
          const int r = r0 + m / nc, cc = c0 + m % nc;
          T* dst = mid + (r * hc + cc) * L.mid_stride + col;
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = fmaxf(a[i][j] * vec[col + j] + vec[MC + col + j], 0.f);
          io::store2(dst, make_float2(o[0], o[1]));
          io::store2(dst + 2, make_float2(o[2], o[3]));
        }
      }
    }
    __syncthreads();

    // b. depthwise: z[o][j] = relu(sum_taps mid * wd * sd + bd), channel pairs.
    {
      const int mp = mc / 2;
      for (int i = tid; i < Mo * mp; i += nt) {
        const int o = i / mp, c = (i - o * mp) * 2;
        const int oh = o / tw, ow = o - oh * tw;
        float2 s = make_float2(0.f, 0.f);
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const float2 v = io::load2(mid + ((oh * S + dy) * hc + ow * S + dx) * L.mid_stride + c);
            const float2 w = *reinterpret_cast<const float2*>(wds + (dy * K + dx) * MC + c);
            s.x += v.x * w.x;
            s.y += v.y * w.y;
          }
        }
        const float zx = fmaxf(s.x * vec[2 * MC + c] + vec[3 * MC + c], 0.f);
        const float zy = fmaxf(s.y * vec[2 * MC + c + 1] + vec[3 * MC + c + 1], 0.f);
        io::store2(zs + o * L.z_stride + c, make_float2(zx, zy));
      }
    }
    __syncthreads();

    // c. project: acc[o][co] += sum_j z[o][j] * wp[m0 + j][co].
    {
      const int ng = Cout / 4;
      const int tiles = ((Mo + 3) / 4) * ng;
      for (int t = tid; t < tiles; t += nt) {
        const int rg = t / ng, col = (t - rg * ng) * 4;
        const int row = rg * 4;
        const T* zr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) zr[i] = zs + min(row + i, Mo - 1) * L.z_stride;
        const T* wcol = wp + (size_t)m0 * Cout + col;
        float a[4][4] = {};
#pragma unroll 2
        for (int j = 0; j < mc; j += 2) {
          const float4 w0 = io::ldg4(wcol + (size_t)j * Cout);
          const float4 w1 = io::ldg4(wcol + (size_t)(j + 1) * Cout);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 v = io::load2(zr[i] + j);
            a[i][0] += v.x * w0.x + v.y * w1.x;
            a[i][1] += v.x * w0.y + v.y * w1.y;
            a[i][2] += v.x * w0.z + v.y * w1.z;
            a[i][3] += v.x * w0.w + v.y * w1.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (row + i >= Mo) break;
          float4* dst = reinterpret_cast<float4*>(acc + (row + i) * Cout + col);
          float4 v = *dst;
          v.x += a[i][0];
          v.y += a[i][1];
          v.z += a[i][2];
          v.w += a[i][3];
          *dst = v;
        }
      }
    }
  }
  __syncthreads();

  // Epilogue: y = acc * sp + bp [+ x], one store in the I/O dtype.
  const int co2 = Cout / 2;
  for (int i = tid; i < Mo * co2; i += nt) {
    const int o = i / co2, c = (i - o * co2) * 2;
    const int oh = o / tw, ow = o - oh * tw;
    float2 v = make_float2(acc[o * Cout + c] * sp[c] + bp[c],
                           acc[o * Cout + c + 1] * sp[c + 1] + bp[c + 1]);
    if (RES) {  // stride 1 and Cin == Cout: x at this pixel is halo (oh + P, ow + P)
      const int m = (oh + P - r0) * nc + (ow + P - c0);
      const float2 r = io::load2(xs + m * L.xs_stride + c);
      v.x += r.x;
      v.y += r.y;
    }
    io::store2(y + (((size_t)n * Ho + oh0 + oh) * Wo + ow0 + ow) * Cout + c, v);
  }
}

template <typename T, int K, int S, bool RES>
int launch(const void* x, const void* we, const void* se, const void* be, const void* wd,
           const void* sd, const void* bd, const void* wp, const void* sp, const void* bp,
           void* y, int N, int H, int W, int Cin, int Cmid, int Cout, int TH, int TW, int MC,
           int threads, cudaStream_t stream) {
  const int Ho = (H + 2 * (K / 2) - K) / S + 1;
  const int Wo = (W + 2 * (K / 2) - K) / S + 1;
  const Layout L = mb_layout(TH, TW, MC, Cin, Cout, K, S, (int)sizeof(T));
  auto kernel = mbconv_kernel<T, K, S, RES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (Wo + TW - 1) / TW;
  const dim3 grid(((Ho + TH - 1) / TH) * tiles_w, N);
  kernel<<<grid, threads, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we), static_cast<const float*>(se),
      static_cast<const float*>(be), static_cast<const T*>(wd), static_cast<const float*>(sd),
      static_cast<const float*>(bd), static_cast<const T*>(wp), static_cast<const float*>(sp),
      static_cast<const float*>(bp), static_cast<T*>(y), H, W, Cin, Cmid, Cout, Ho, Wo, TH, TW,
      MC, tiles_w);
  return (int)cudaGetLastError();
}

template <typename T, int K, int S>
int dispatch_res(int res, const void* x, const void* we, const void* se, const void* be,
                 const void* wd, const void* sd, const void* bd, const void* wp, const void* sp,
                 const void* bp, void* y, int N, int H, int W, int Cin, int Cmid, int Cout,
                 int TH, int TW, int MC, int threads, cudaStream_t s) {
  if (res)
    return launch<T, K, S, true>(x, we, se, be, wd, sd, bd, wp, sp, bp, y, N, H, W, Cin, Cmid,
                                 Cout, TH, TW, MC, threads, s);
  return launch<T, K, S, false>(x, we, se, be, wd, sd, bd, wp, sp, bp, y, N, H, W, Cin, Cmid,
                                Cout, TH, TW, MC, threads, s);
}

template <typename T>
int dispatch(int k, int stride, int res, const void* x, const void* we, const void* se,
             const void* be, const void* wd, const void* sd, const void* bd, const void* wp,
             const void* sp, const void* bp, void* y, int N, int H, int W, int Cin, int Cmid,
             int Cout, int TH, int TW, int MC, int threads, cudaStream_t s) {
#define MB_ARGS \
  res, x, we, se, be, wd, sd, bd, wp, sp, bp, y, N, H, W, Cin, Cmid, Cout, TH, TW, MC, threads, s
  if (k == 3 && stride == 1) return dispatch_res<T, 3, 1>(MB_ARGS);
  if (k == 3 && stride == 2) return dispatch_res<T, 3, 2>(MB_ARGS);
  if (k == 5 && stride == 1) return dispatch_res<T, 5, 1>(MB_ARGS);
  if (k == 5 && stride == 2) return dispatch_res<T, 5, 2>(MB_ARGS);
#undef MB_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block for a tile plan.
long long mbconv_smem_bytes(int TH, int TW, int MC, int Cin, int Cout, int k, int stride,
                            int elem_bytes) {
  return (long long)mb_layout(TH, TW, MC, Cin, Cout, k, stride, elem_bytes).total;
}

// x (N,H,W,Cin) and y (N,Ho,Wo,Cout) in bf16 (is_bf16=1) or fp32; we (Cin,Cmid),
// wd (k,k,Cmid) and wp (Cmid,Cout) in the same dtype; se, be, sd, bd (Cmid,)
// and sp, bp (Cout,) fp32. Cin even, Cmid and MC multiples of 8, Cout a
// multiple of 4; residual only with stride 1 and Cin == Cout; threads a
// multiple of 32, at most 512.
// Returns cudaGetLastError() of the launch.
int mbconv_block(const void* x, const void* we, const void* se, const void* be, const void* wd,
                 const void* sd, const void* bd, const void* wp, const void* sp, const void* bp,
                 void* y, int N, int H, int W, int Cin, int Cmid, int Cout, int k, int stride,
                 int residual, int is_bf16, int TH, int TW, int MC, int threads, void* stream) {
  if (Cin % 2 || Cmid % 8 || MC % 8 || Cout % 4 || (residual && (stride != 1 || Cin != Cout)) ||
      threads % 32 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(k, stride, residual, x, we, se, be, wd, sd, bd, wp, sp, bp, y,
                                   N, H, W, Cin, Cmid, Cout, TH, TW, MC, threads, s);
  return dispatch<float>(k, stride, residual, x, we, se, be, wd, sd, bd, wp, sp, bp, y, N, H, W,
                         Cin, Cmid, Cout, TH, TW, MC, threads, s);
}

}  // extern "C"
