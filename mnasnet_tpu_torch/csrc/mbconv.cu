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
// 21 us at 3.35 TB/s) and the late ones are bound by FLOPs (s5b0: 7.5 GFLOP,
// 7.6 us at 989 TFLOP/s). The two GEMMs carry almost all of the FLOPs.
//
// Tiling (both kernels). The TPU kernel keeps a whole padded plane of the
// expanded tensor per sample in VMEM (up to 114x114x72 bf16 = 1.9 MB); a
// Hopper block has at most 227 KB of shared memory. So one block owns a tile
// of TH x TW output pixels of one sample:
//   1. it stages the tile's input halo, ((TH-1)*s+k) x ((TW-1)*s+k) pixels
//      x Cin, clipped to the image, in shared memory once;
//   2. it walks Cmid in chunks of MC channels; per chunk it
//      a. expands the halo pixels that lie inside the image into a shared
//         mid tile (positions outside the image stay 0: the reference pads
//         the expanded tensor with zeros, it does not expand a zero-padded x);
//      b. runs the depthwise conv from the mid tile into a shared z tile;
//      c. accumulates z . wp into the project's fp32 accumulator;
//   3. the epilogue applies the project affine, adds the residual from the
//      staged x, and stores y once.
// Halo pixels are expanded again by each neighbouring tile; the planner in
// ops/cuda/mbconv.py picks the tile and PERF.md records the recompute.
//
// bf16 kernel (mbconv_tc_kernel, the serving path): both GEMMs run on the
// tensor cores as mma.sync m16n8k16 bf16 x bf16 -> fp32, their operands
// brought from shared memory by ldmatrix (A row-major, B [K][N] through
// ldmatrix.trans). The expand's A is the staged x halo [M1 x Cin], its B the
// chunk of we [Cin x MC]; its epilogue applies the affine and ReLU in fp32
// registers and rounds once to bf16 into the mid tile. The depthwise step is
// SIMT fp32 with 16-byte shared reads of 8 channels; each thread computes two
// neighbouring outputs, which share their weights and most of their input
// columns, since shared-memory loads bound this step. The project's A is z
// [Mo x MC], its B the chunk of wp [MC x Cout]; its fp32 accumulators stay in
// registers across all chunks (NI items of 16 x 32 outputs per warp). The
// next chunk's we, wd and wp tiles arrive by 16-byte cp.async while the
// current chunk computes (two buffers), as does the x halo at the start.
// Shared row strides are 16-byte multiples with a 16-byte skew (an odd number
// of 16-byte units), so the eight rows an ldmatrix phase reads fall in
// distinct banks; K dimensions (Cin, the tail of Cmid) are zero-padded to 16
// in shared memory, and rows beyond M1 or Mo are clamped to the last row and
// their results discarded. The output tile is staged in shared memory and
// stored as 16-byte vectors.
//
// fp32 kernel (mbconv_kernel): the products stay SIMT fp32 FMAs, because on
// the tensor cores fp32 would be TF32 and break the fp32 tolerance. Each
// thread owns a 4 x 4 register tile and steps the reduction two channels at a
// time; rows are padded by 2 elements to spread the pairs over the banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads of a block are a launch argument (ops/cuda/mbconv.py:THREADS).
constexpr int kMaxThreads = 512;
// Project items (16 output pixels x 32 output channels) each warp of the bf16
// kernel keeps in registers.
constexpr int kItemsPerWarp = 4;

// Phase clocks of the bf16 kernel, for tools/mbconv_phases.py, which builds
// this file with -DMBCONV_PHASE_CLOCKS: at the end of each phase (after its
// barrier, where it has one) thread 0 adds the cycles since its previous mark
// to that phase's counter. In the normal build the marks are empty.
#ifdef MBCONV_PHASE_CLOCKS
__device__ unsigned long long g_phase[8];
#define PHASE_START long long t_mark_ = clock64();
#define PHASE_MARK(i)                                                   \
  if (tid == 0) {                                                       \
    const long long now_ = clock64();                                   \
    atomicAdd(&g_phase[i], (unsigned long long)(now_ - t_mark_));       \
    t_mark_ = now_;                                                     \
  }
#define PHASE_END(i) \
  __syncthreads();   \
  PHASE_MARK(i)
#else
#define PHASE_START
#define PHASE_MARK(i)
#define PHASE_END(i)
#endif

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }
__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// bf16: tensor cores.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// d += a . b for one m16n8k16 tile: a row-major 16x16, b 16x8, d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(a, b));
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void unpack8(const uint4 raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Shared-memory plan of one bf16 block; ops/cuda/mbconv.py:smem_bytes
// computes the same total. Strides are in elements.
struct TcLayout {
  int xs_stride, mc_stride, wp_stride, ys_stride, cin16, cout16;
  size_t off_mid, off_zs, off_we, off_wp, off_wd, we_bytes, wp_bytes, wd_bytes, total;
};

__host__ __device__ inline TcLayout tc_layout(int TH, int TW, int MC, int Cin, int Cout, int K,
                                              int S) {
  TcLayout L;
  const size_t halo = (size_t)((TH - 1) * S + K) * ((TW - 1) * S + K);
  const size_t mo = (size_t)TH * TW;
  L.cin16 = round_up(Cin, 16);
  L.cout16 = round_up(Cout, 16);
  L.xs_stride = L.cin16 + 8;
  L.mc_stride = MC + 8;
  L.wp_stride = L.cout16 + 8;
  L.ys_stride = Cout + 8;
  size_t off = align16(halo * L.xs_stride * 2);            // x halo, in-image part
  L.off_mid = off;                                          // mid chunk; the output
  const size_t mid = halo * L.mc_stride * 2;                // tile reuses it at the end
  const size_t ys = mo * L.ys_stride * 2;
  off += align16(mid > ys ? mid : ys);
  L.off_zs = off;
  off += align16(mo * L.mc_stride * 2);                     // depthwise output chunk
  L.we_bytes = align16((size_t)L.cin16 * L.mc_stride * 2);  // we chunk, two buffers
  L.off_we = off;
  off += 2 * L.we_bytes;
  L.wp_bytes = align16((size_t)MC * L.wp_stride * 2);       // wp chunk, two buffers
  L.off_wp = off;
  off += 2 * L.wp_bytes;
  L.wd_bytes = align16((size_t)K * K * MC * 2);             // wd chunk, two buffers
  L.off_wd = off;
  off += 2 * L.wd_bytes;
  L.total = off;
  return L;
}

template <int K, int S, bool RES>
__global__ void __launch_bounds__(kMaxThreads, 1)
mbconv_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ we,
                 const float* __restrict__ se, const float* __restrict__ be,
                 const __nv_bfloat16* __restrict__ wd, const float* __restrict__ sd,
                 const float* __restrict__ bd, const __nv_bfloat16* __restrict__ wp,
                 const float* __restrict__ sp, const float* __restrict__ bp,
                 __nv_bfloat16* __restrict__ y, int H, int W, int Cin, int Cmid, int Cout, int Ho,
                 int Wo, int TH, int TW, int MC, int tiles_w) {
  using bf = __nv_bfloat16;
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L = tc_layout(TH, TW, MC, Cin, Cout, K, S);
  bf* xs = reinterpret_cast<bf*>(smem);
  bf* mid = reinterpret_cast<bf*>(smem + L.off_mid);
  bf* zs = reinterpret_cast<bf*>(smem + L.off_zs);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
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
  PHASE_START

  // The chunk of we [Cin16][MC], wp [MC][Cout16] and wd [K*K][MC] that starts
  // at expanded channel m0, into buffer b; zero where past Cin, Cmid or Cout.
  auto load_chunk = [&](int m0, int b) {
    bf* wes = reinterpret_cast<bf*>(smem + L.off_we + b * L.we_bytes);
    bf* wps = reinterpret_cast<bf*>(smem + L.off_wp + b * L.wp_bytes);
    bf* wds = reinterpret_cast<bf*>(smem + L.off_wd + b * L.wd_bytes);
    const int mv = MC / 8;
    for (int i = tid; i < L.cin16 * mv; i += nt) {
      const int k = i / mv, j = (i - k * mv) * 8;
      const bool ok = k < Cin && m0 + j < Cmid;
      cp_async16(wes + k * L.mc_stride + j, ok ? we + (size_t)k * Cmid + m0 + j : we, ok);
    }
    const int ov = L.cout16 / 8;
    for (int i = tid; i < MC * ov; i += nt) {
      const int k = i / ov, j = (i - k * ov) * 8;
      const bool ok = m0 + k < Cmid && j < Cout;
      cp_async16(wps + k * L.wp_stride + j, ok ? wp + (size_t)(m0 + k) * Cout + j : wp, ok);
    }
    for (int i = tid; i < K * K * mv; i += nt) {
      const int tap = i / mv, j = (i - tap * mv) * 8;
      const bool ok = m0 + j < Cmid;
      cp_async16(wds + tap * MC + j, ok ? wd + (size_t)tap * Cmid + m0 + j : wd, ok);
    }
  };

  // Stage x: xs[m][Cin16], m = (r - r0) * nc + (c - c0), columns past Cin zero.
  {
    const int cv = Cin / 8, pv = (L.cin16 - Cin) / 8;
    for (int i = tid; i < M1 * cv; i += nt) {
      const int m = i / cv, c = (i - m * cv) * 8;
      const int r = r0 + m / nc, col = c0 + m % nc;
      cp_async16(xs + m * L.xs_stride + c,
                 x + (((size_t)n * H + h_in0 + r) * W + (w_in0 + col)) * Cin + c, true);
    }
    for (int i = tid; i < M1 * pv; i += nt) {
      const int m = i / pv, c = Cin + (i - m * pv) * 8;
      *reinterpret_cast<uint4*>(xs + m * L.xs_stride + c) = make_uint4(0, 0, 0, 0);
    }
  }
  load_chunk(0, 0);
  cp_async_commit();
  // Zero the mid tile once: positions outside the image are never written.
  {
    uint4* m16 = reinterpret_cast<uint4*>(mid);
    const int n16 = hr * hc * L.mc_stride / 8;
    for (int i = tid; i < n16; i += nt) m16[i] = make_uint4(0, 0, 0, 0);
  }
  PHASE_MARK(0)  // staging issued, mid zeroed

  // Project accumulators: item it = warp + j * nwarps covers output pixels
  // [16 * (it / pg), +16) and channels [32 * (it % pg), +32).
  const int pg = (Cout + 31) / 32;
  const int pitems = ((Mo + 15) / 16) * pg;
  float acc[kItemsPerWarp][4][4];
#pragma unroll
  for (int j = 0; j < kItemsPerWarp; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][q][e] = 0.f;

  const int g = lane >> 2, t4 = lane & 3;
  const int nchunks = (Cmid + MC - 1) / MC;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int m0 = ci * MC, mc = min(MC, Cmid - m0), b = ci & 1;
    __syncthreads();  // the previous chunk is done with mid, zs and buffer b ^ 1
    PHASE_MARK(1)     // the previous chunk's project and this barrier
    if (ci + 1 < nchunks) load_chunk(m0 + MC, b ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    PHASE_MARK(2)  // the next chunk issued, the wait for this one
    const bf* wes = reinterpret_cast<const bf*>(smem + L.off_we + b * L.we_bytes);
    const bf* wps = reinterpret_cast<const bf*>(smem + L.off_wp + b * L.wp_bytes);
    const bf* wds = reinterpret_cast<const bf*>(smem + L.off_wd + b * L.wd_bytes);

    // a. expand: mid[pixel][j] = relu((x . we)[pixel][m0 + j] * se + be), j < mc.
    {
      const int eg = (MC + 31) / 32;  // items of up to 16 pixels x 32 channels
      const int items = ((M1 + 15) / 16) * eg;
      for (int it = warp; it < items; it += nwarps) {
        const int mt = it / eg, n0 = (it - mt * eg) * 32;
        float e[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) e[q][i] = 0.f;
        const bf* arow = xs + min(mt * 16 + (lane & 15), M1 - 1) * L.xs_stride + (lane >> 4) * 8;
        const bf* brow = wes + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.mc_stride + n0 +
                         (lane >> 4) * 8;
        for (int k0 = 0; k0 < L.cin16; k0 += 16) {
          uint32_t a[4], bq[4];
          ldsm_x4(a, arow + k0);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            if (n0 + 16 * p < MC) {
              ldsm_x4_trans(bq, brow + k0 * L.mc_stride + p * 16);
              mma_bf16(e[2 * p], a, bq[0], bq[1]);
              mma_bf16(e[2 * p + 1], a, bq[2], bq[3]);
            }
          }
        }
        int pos[2];  // mid positions of the fragment's two rows, -1 outside M1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          pos[h] = m < M1 ? (r0 + m / nc) * hc + c0 + m % nc : -1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (n0 + q * 8 >= MC) break;
          const int col = n0 + q * 8 + 2 * t4;
          const bool ok = col < mc;
          const float2 s = ok ? *reinterpret_cast<const float2*>(se + m0 + col) : make_float2(0, 0);
          const float2 o = ok ? *reinterpret_cast<const float2*>(be + m0 + col) : make_float2(0, 0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (pos[h] >= 0)
              *reinterpret_cast<uint32_t*>(mid + pos[h] * L.mc_stride + col) =
                  pack_bf16(fmaxf(e[q][2 * h] * s.x + o.x, 0.f),
                            fmaxf(e[q][2 * h + 1] * s.y + o.y, 0.f));
          }
        }
      }
    }
    __syncthreads();
    PHASE_MARK(3)  // expand

    // b. depthwise: z[o][j] = relu(sum_taps mid * wd * sd + bd); a thread takes
    // 8 channels of two neighbouring outputs of a row, which share K - S of
    // their K + S input columns and all their weights.
    {
      const int mv = MC / 8, strips = (tw + 1) / 2;
      for (int i = tid; i < th * strips * mv; i += nt) {
        const int v = i % mv, q = i / mv;
        const int oh = q / strips, ow = (q - oh * strips) * 2;
        const bool two = ow + 1 < tw;
        uint4 out[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
        if (v * 8 < mc) {
          float s0[8] = {}, s1[8] = {};
#pragma unroll
          for (int dy = 0; dy < K; ++dy) {
            const bf* row = mid + ((oh * S + dy) * hc + ow * S) * L.mc_stride + v * 8;
            const bf* wrow = wds + dy * K * MC + v * 8;
#pragma unroll
            for (int c = 0; c < K + S; ++c) {
              if (c >= K && !two) break;
              float xv[8], wv[8];
              unpack8(*reinterpret_cast<const uint4*>(row + c * L.mc_stride), xv);
              if (c < K) {
                unpack8(*reinterpret_cast<const uint4*>(wrow + c * MC), wv);
#pragma unroll
                for (int j = 0; j < 8; ++j) s0[j] += xv[j] * wv[j];
              }
              if (c >= S && two) {
                unpack8(*reinterpret_cast<const uint4*>(wrow + (c - S) * MC), wv);
#pragma unroll
                for (int j = 0; j < 8; ++j) s1[j] += xv[j] * wv[j];
              }
            }
          }
          const int ch = m0 + v * 8;
          float sc[8], bi[8];
          *reinterpret_cast<float4*>(sc) = *reinterpret_cast<const float4*>(sd + ch);
          *reinterpret_cast<float4*>(sc + 4) = *reinterpret_cast<const float4*>(sd + ch + 4);
          *reinterpret_cast<float4*>(bi) = *reinterpret_cast<const float4*>(bd + ch);
          *reinterpret_cast<float4*>(bi + 4) = *reinterpret_cast<const float4*>(bd + ch + 4);
          uint32_t* o0 = reinterpret_cast<uint32_t*>(&out[0]);
          uint32_t* o1 = reinterpret_cast<uint32_t*>(&out[1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            o0[j] = pack_bf16(fmaxf(s0[2 * j] * sc[2 * j] + bi[2 * j], 0.f),
                              fmaxf(s0[2 * j + 1] * sc[2 * j + 1] + bi[2 * j + 1], 0.f));
            o1[j] = pack_bf16(fmaxf(s1[2 * j] * sc[2 * j] + bi[2 * j], 0.f),
                              fmaxf(s1[2 * j + 1] * sc[2 * j + 1] + bi[2 * j + 1], 0.f));
          }
        }
        const int o = oh * tw + ow;
        *reinterpret_cast<uint4*>(zs + o * L.mc_stride + v * 8) = out[0];
        if (two) *reinterpret_cast<uint4*>(zs + (o + 1) * L.mc_stride + v * 8) = out[1];
      }
    }
    __syncthreads();
    PHASE_MARK(4)  // depthwise

    // c. project: acc[o][co] += sum_j z[o][j] * wp[m0 + j][co].
#pragma unroll
    for (int j = 0; j < kItemsPerWarp; ++j) {
      const int it = warp + j * nwarps;
      if (it < pitems) {
        const int mt = it / pg, n0 = (it - mt * pg) * 32;
        const bf* arow = zs + min(mt * 16 + (lane & 15), Mo - 1) * L.mc_stride + (lane >> 4) * 8;
        const bf* brow = wps + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.wp_stride + n0 +
                         (lane >> 4) * 8;
        for (int k0 = 0; k0 < MC; k0 += 16) {
          uint32_t a[4], bq[4];
          ldsm_x4(a, arow + k0);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            if (n0 + 16 * p < L.cout16) {
              ldsm_x4_trans(bq, brow + k0 * L.wp_stride + p * 16);
              mma_bf16(acc[j][2 * p], a, bq[0], bq[1]);
              mma_bf16(acc[j][2 * p + 1], a, bq[2], bq[3]);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the last chunk is done with mid: the output tile takes it

  // Epilogue: y = acc * sp + bp [+ x] in fp32, rounded once into the output
  // tile, then stored as 16-byte vectors.
  bf* ys = mid;
#pragma unroll
  for (int j = 0; j < kItemsPerWarp; ++j) {
    const int it = warp + j * nwarps;
    if (it < pitems) {
      const int mt = it / pg, n0 = (it - mt * pg) * 32;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = n0 + q * 8 + 2 * t4;
        if (col < Cout) {
          const float2 s = *reinterpret_cast<const float2*>(sp + col);
          const float2 o = *reinterpret_cast<const float2*>(bp + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * 16 + g + 8 * h;
            if (m < Mo) {
              float v0 = acc[j][q][2 * h] * s.x + o.x, v1 = acc[j][q][2 * h + 1] * s.y + o.y;
              if (RES) {  // stride 1 and Cin == Cout: x at this pixel is halo (oh + P, ow + P)
                const int oh = m / tw, ow = m - oh * tw;
                const int xm = (oh + P - r0) * nc + (ow + P - c0);
                const float2 r = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(xs + xm * L.xs_stride + col));
                v0 += r.x;
                v1 += r.y;
              }
              *reinterpret_cast<uint32_t*>(ys + m * L.ys_stride + col) = pack_bf16(v0, v1);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  const int ov = Cout / 8;
  for (int i = tid; i < Mo * ov; i += nt) {
    const int m = i / ov, c = (i - m * ov) * 8;
    const int oh = m / tw, ow = m - oh * tw;
    *reinterpret_cast<uint4*>(y + (((size_t)n * Ho + oh0 + oh) * Wo + ow0 + ow) * Cout + c) =
        *reinterpret_cast<const uint4*>(ys + m * L.ys_stride + c);
  }
  PHASE_END(5)  // the last chunk's project and the epilogue
}

// ---------------------------------------------------------------------------
// fp32: SIMT FMAs.

// Shared-memory plan of one fp32 block; ops/cuda/mbconv.py:smem_bytes
// computes the same total.
struct Layout {
  int xs_stride, mid_stride, z_stride;  // elements per pixel (padded by 2)
  size_t off_mid, off_z, off_acc, off_wd, off_vec, total;
};

__host__ __device__ inline Layout mb_layout(int TH, int TW, int MC, int Cin, int Cout, int K,
                                            int S) {
  Layout L;
  const size_t halo = (size_t)((TH - 1) * S + K) * ((TW - 1) * S + K);
  L.xs_stride = Cin + 2;
  L.mid_stride = MC + 2;
  L.z_stride = MC + 2;
  size_t off = align16(halo * L.xs_stride * 4);      // x halo, in-image part
  L.off_mid = off;
  off += align16(halo * L.mid_stride * 4);           // expanded chunk
  L.off_z = off;
  off += align16((size_t)TH * TW * L.z_stride * 4);  // depthwise output chunk
  L.off_acc = off;
  off += align16((size_t)TH * TW * Cout * 4);        // fp32 project accumulator
  L.off_wd = off;
  off += align16((size_t)K * K * MC * 4);            // fp32 dw weights of the chunk
  L.off_vec = off;
  off += align16((size_t)4 * MC * 4);                // se, be, sd, bd of the chunk
  L.total = off;
  return L;
}

template <int K, int S, bool RES>
__global__ void __launch_bounds__(kMaxThreads)
mbconv_kernel(const float* __restrict__ x, const float* __restrict__ we,
              const float* __restrict__ se, const float* __restrict__ be,
              const float* __restrict__ wd, const float* __restrict__ sd,
              const float* __restrict__ bd, const float* __restrict__ wp,
              const float* __restrict__ sp, const float* __restrict__ bp, float* __restrict__ y,
              int H, int W, int Cin, int Cmid, int Cout, int Ho, int Wo, int TH, int TW, int MC,
              int tiles_w) {
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = mb_layout(TH, TW, MC, Cin, Cout, K, S);
  float* xs = reinterpret_cast<float*>(smem);
  float* mid = reinterpret_cast<float*>(smem + L.off_mid);
  float* zs = reinterpret_cast<float*>(smem + L.off_z);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  float* wds = reinterpret_cast<float*>(smem + L.off_wd);
  float* vec = reinterpret_cast<float*>(smem + L.off_vec);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = blockIdx.y;
  const int oh0 = (blockIdx.x / tiles_w) * TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int th = min(TH, Ho - oh0), tw = min(TW, Wo - ow0);
  const int hr = (th - 1) * S + K, hc = (tw - 1) * S + K;
  const int h_in0 = oh0 * S - P, w_in0 = ow0 * S - P;
  const int r0 = max(0, -h_in0), r1 = min(hr, H - h_in0);
  const int c0 = max(0, -w_in0), c1 = min(hc, W - w_in0);
  const int nc = c1 - c0;
  const int M1 = (r1 - r0) * nc;
  const int Mo = th * tw;

  const int cin2 = Cin / 2;
  for (int i = tid; i < M1 * cin2; i += nt) {
    const int m = i / cin2, c = (i - m * cin2) * 2;
    const int r = r0 + m / nc, col = c0 + m % nc;
    *reinterpret_cast<float2*>(xs + m * L.xs_stride + c) = *reinterpret_cast<const float2*>(
        x + (((size_t)n * H + h_in0 + r) * W + (w_in0 + col)) * Cin + c);
  }
  for (int i = tid; i < hr * hc * L.mid_stride; i += nt) mid[i] = 0.f;
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
      wds[tap * MC + c] = wd[(size_t)tap * Cmid + m0 + c];
    }
    __syncthreads();

    // a. expand: mid[pixel][j] = relu((x . we)[pixel][m0 + j] * se + be), j < mc.
    {
      const int ng = mc / 4;
      const int tiles = ((M1 + 3) / 4) * ng;
      for (int t = tid; t < tiles; t += nt) {
        const int rg = t / ng, col = (t - rg * ng) * 4;
        const int row = rg * 4;
        const float* xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xr[i] = xs + min(row + i, M1 - 1) * L.xs_stride;
        const float* wcol = we + m0 + col;
        float a[4][4] = {};
#pragma unroll 2
        for (int c = 0; c < Cin; c += 2) {
          const float4 w0 = __ldg(reinterpret_cast<const float4*>(wcol + (size_t)c * Cmid));
          const float4 w1 = __ldg(reinterpret_cast<const float4*>(wcol + (size_t)(c + 1) * Cmid));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 v = *reinterpret_cast<const float2*>(xr[i] + c);
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
          float* dst = mid + (r * hc + cc) * L.mid_stride + col;
#pragma unroll
          for (int j = 0; j < 4; ++j) dst[j] = fmaxf(a[i][j] * vec[col + j] + vec[MC + col + j], 0.f);
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
            const float2 v = *reinterpret_cast<const float2*>(
                mid + ((oh * S + dy) * hc + ow * S + dx) * L.mid_stride + c);
            const float2 w = *reinterpret_cast<const float2*>(wds + (dy * K + dx) * MC + c);
            s.x += v.x * w.x;
            s.y += v.y * w.y;
          }
        }
        *reinterpret_cast<float2*>(zs + o * L.z_stride + c) =
            make_float2(fmaxf(s.x * vec[2 * MC + c] + vec[3 * MC + c], 0.f),
                        fmaxf(s.y * vec[2 * MC + c + 1] + vec[3 * MC + c + 1], 0.f));
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
        const float* zr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) zr[i] = zs + min(row + i, Mo - 1) * L.z_stride;
        const float* wcol = wp + (size_t)m0 * Cout + col;
        float a[4][4] = {};
#pragma unroll 2
        for (int j = 0; j < mc; j += 2) {
          const float4 w0 = __ldg(reinterpret_cast<const float4*>(wcol + (size_t)j * Cout));
          const float4 w1 = __ldg(reinterpret_cast<const float4*>(wcol + (size_t)(j + 1) * Cout));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 v = *reinterpret_cast<const float2*>(zr[i] + j);
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

  // Epilogue: y = acc * sp + bp [+ x], one store.
  const int co2 = Cout / 2;
  for (int i = tid; i < Mo * co2; i += nt) {
    const int o = i / co2, c = (i - o * co2) * 2;
    const int oh = o / tw, ow = o - oh * tw;
    float2 v = make_float2(acc[o * Cout + c] * sp[c] + bp[c],
                           acc[o * Cout + c + 1] * sp[c + 1] + bp[c + 1]);
    if (RES) {  // stride 1 and Cin == Cout: x at this pixel is halo (oh + P, ow + P)
      const int m = (oh + P - r0) * nc + (ow + P - c0);
      const float2 r = *reinterpret_cast<const float2*>(xs + m * L.xs_stride + c);
      v.x += r.x;
      v.y += r.y;
    }
    *reinterpret_cast<float2*>(y + (((size_t)n * Ho + oh0 + oh) * Wo + ow0 + ow) * Cout + c) = v;
  }
}

// ---------------------------------------------------------------------------

struct Args {
  const void *x, *we, *se, *be, *wd, *sd, *bd, *wp, *sp, *bp;
  void* y;
  int N, H, W, Cin, Cmid, Cout, TH, TW, MC, threads;
};

size_t smem_total(int is_bf16, int TH, int TW, int MC, int Cin, int Cout, int K, int S) {
  return is_bf16 ? tc_layout(TH, TW, MC, Cin, Cout, K, S).total
                 : mb_layout(TH, TW, MC, Cin, Cout, K, S).total;
}

template <int K, int S, bool RES>
int launch(int is_bf16, const Args& a, cudaStream_t stream) {
  const int Ho = (a.H + 2 * (K / 2) - K) / S + 1;
  const int Wo = (a.W + 2 * (K / 2) - K) / S + 1;
  const size_t smem = smem_total(is_bf16, a.TH, a.TW, a.MC, a.Cin, a.Cout, K, S);
  const int tiles_w = (Wo + a.TW - 1) / a.TW;
  const dim3 grid(((Ho + a.TH - 1) / a.TH) * tiles_w, a.N);
  cudaError_t err;
  if (is_bf16) {
    using bf = __nv_bfloat16;
    auto kernel = mbconv_tc_kernel<K, S, RES>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, a.threads, smem, stream>>>(
        static_cast<const bf*>(a.x), static_cast<const bf*>(a.we),
        static_cast<const float*>(a.se), static_cast<const float*>(a.be),
        static_cast<const bf*>(a.wd), static_cast<const float*>(a.sd),
        static_cast<const float*>(a.bd), static_cast<const bf*>(a.wp),
        static_cast<const float*>(a.sp), static_cast<const float*>(a.bp), static_cast<bf*>(a.y),
        a.H, a.W, a.Cin, a.Cmid, a.Cout, Ho, Wo, a.TH, a.TW, a.MC, tiles_w);
  } else {
    auto kernel = mbconv_kernel<K, S, RES>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, a.threads, smem, stream>>>(
        static_cast<const float*>(a.x), static_cast<const float*>(a.we),
        static_cast<const float*>(a.se), static_cast<const float*>(a.be),
        static_cast<const float*>(a.wd), static_cast<const float*>(a.sd),
        static_cast<const float*>(a.bd), static_cast<const float*>(a.wp),
        static_cast<const float*>(a.sp), static_cast<const float*>(a.bp),
        static_cast<float*>(a.y), a.H, a.W, a.Cin, a.Cmid, a.Cout, Ho, Wo, a.TH, a.TW, a.MC,
        tiles_w);
  }
  return (int)cudaGetLastError();
}

template <int K, int S>
int dispatch_res(int res, int is_bf16, const Args& a, cudaStream_t s) {
  return res ? launch<K, S, true>(is_bf16, a, s) : launch<K, S, false>(is_bf16, a, s);
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block for a tile plan, by I/O element size.
long long mbconv_smem_bytes(int TH, int TW, int MC, int Cin, int Cout, int k, int stride,
                            int elem_bytes) {
  return (long long)smem_total(elem_bytes == 2, TH, TW, MC, Cin, Cout, k, stride);
}

// x (N,H,W,Cin) and y (N,Ho,Wo,Cout) in bf16 (is_bf16=1) or fp32; we (Cin,Cmid),
// wd (k,k,Cmid) and wp (Cmid,Cout) in the same dtype; se, be, sd, bd (Cmid,)
// and sp, bp (Cout,) fp32; all 16-byte aligned. Residual only with stride 1
// and Cin == Cout; threads a multiple of 32, at most 512.
// bf16: Cin, Cmid and Cout multiples of 8, MC a multiple of 16 (at most 128),
// and ceil(TH*TW/16) * ceil(Cout/32) project items at most 4 per warp.
// fp32: Cin even, Cmid and MC multiples of 8, Cout a multiple of 4.
// Returns cudaGetLastError() of the launch.
int mbconv_block(const void* x, const void* we, const void* se, const void* be, const void* wd,
                 const void* sd, const void* bd, const void* wp, const void* sp, const void* bp,
                 void* y, int N, int H, int W, int Cin, int Cmid, int Cout, int k, int stride,
                 int residual, int is_bf16, int TH, int TW, int MC, int threads, void* stream) {
  if ((residual && (stride != 1 || Cin != Cout)) || threads % 32 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const int items = ((TH * TW + 15) / 16) * ((Cout + 31) / 32);
    if (Cin % 8 || Cmid % 8 || Cout % 8 || MC % 16 || MC > 128 ||
        items > kItemsPerWarp * (threads / 32))
      return (int)cudaErrorInvalidValue;
  } else if (Cin % 2 || Cmid % 8 || MC % 8 || Cout % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, we, se, be, wd, sd, bd, wp, sp, bp, y, N, H, W, Cin, Cmid, Cout, TH, TW, MC,
               threads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3 && stride == 1) return dispatch_res<3, 1>(residual, is_bf16, a, s);
  if (k == 3 && stride == 2) return dispatch_res<3, 2>(residual, is_bf16, a, s);
  if (k == 5 && stride == 1) return dispatch_res<5, 1>(residual, is_bf16, a, s);
  if (k == 5 && stride == 2) return dispatch_res<5, 2>(residual, is_bf16, a, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef MBCONV_PHASE_CLOCKS
// Copies the 8 phase counters to out and zeroes them; returns a cudaError_t.
int mbconv_phase_cycles(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));
}
#endif

}  // extern "C"
