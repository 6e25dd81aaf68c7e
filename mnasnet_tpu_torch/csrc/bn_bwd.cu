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
// The ReLU mask is the forward's, bit for bit. The forward (the plain version,
// ops/cuda/bn_bwd.py:_fwd_math, and bn_apply_relu_kernel below) clamps x * a_io
// + b_io computed as two PyTorch ops in x's dtype, with a and b rounded to that
// dtype first: one rounding after the multiply and one after the add. The
// kernels repeat exactly that (Io<T>::positive): in bf16
// the product of two bf16 values is exact in fp32 and is rounded to bf16, then
// the sum is rounded to bf16; in fp32 __fmul_rn / __fadd_rn keep nvcc from
// contracting the two into one FMA the forward never did (nor may bf16x2
// __hfma2 / __hmul2 stand in: they round once where the forward rounds twice).
// a and b are computed from the fp32 vectors with the same intrinsics, as
// PyTorch computes them, and inv is the wrapper's torch.rsqrt, not rsqrtf.
// One flipped element would leak gradient through a unit the forward clamped.
//
// What bounds them on an H100: memory. The reduce reads x and dy once, the dx
// pass reads both again and writes dx: per element about 10 fp32 operations
// against 4 (reduce) or 6 (dx) bytes moved in bf16. Over the 35 BN+ReLU regions
// of mnasnet1_0 @ 224 at batch 128 (614 M elements) that is 0.733 ms and 1.10
// ms at 3.35 TB/s.
//
// The reduce: one launch, deterministic, no float atomics. The TPU reduce
// carries its sums from one grid step to the next; here blocks run in no
// order. Rows (N*H*W of them, C channels each) are cut into slabs and channels
// into tiles; block (tile, slab) streams its slab:
//   * a thread owns one vector of V adjacent channels: 16 bytes (8 bf16 or 4
//     fp32) where C and the pointers allow, else 8 or 4 bytes (a template
//     parameter); neighbouring threads take neighbouring vectors and then
//     rows, so a warp reads contiguous runs of each row;
//   * the row loop is unrolled by kUnroll, so a thread has that many rows of
//     x and dy in flight; the loads skip L1 (nothing is read twice) and ask
//     L2 for whole 256-byte blocks, which the next lanes and the neighbouring
//     tiles read;
//   * the channels' mask and xhat factors wait in shared memory, read where
//     they are used, not in 32 registers, so that the 16-byte kernel fits
//     three blocks per SM;
//   * the block sums its row lanes through shared memory in a fixed order
//     (column_sums: consecutive threads share a column, each adds every S-th
//     row in order, warp shuffles add the S sums in a fixed tree) and writes
//     one fp32 partial row per (tile, slab);
//   * the last block of a tile to finish (a ticket per tile from atomicInc,
//     which wraps it back to 0 for the next launch) reads the tile's partials
//     from L2 and sums them over the slabs, in slab order, with the same
//     routine. Atomics only hand out tickets: no sum depends on which block
//     finishes last, so two launches give the same bits.
// The finish reads 8 * slabs * tile-channels bytes after everything else; the
// planner (reduce_plan in ops/cuda/bn_bwd.py) keeps tiles to ~64 bytes of a
// row, so that small regions fill the card with tiles rather than slabs, and
// bounds the finish.
//
// The dx pass: blockDim.x = TP channel pairs, blockDim.y = R row lanes,
// blockIdx.x = slab, blockIdx.y = channel tile; each thread computes its
// channels' constants once and then streams rows (plan in ops/cuda/bn_bwd.py).
//
// The region's forward (bn_fwd_stats, bn_relu_apply). These replace no Pallas
// kernel: the reference's forward (mnasnet_tpu/ops/pallas/bn_bwd.py:_fwd_math)
// is plain JAX, which XLA fuses into a pass or two on the TPU. In PyTorch the
// same arithmetic ran as some seven full-plane library kernels a region (an
// fp32 cast, two means, a square, the bf16 multiply, add and ReLU: ~34 bytes
// an element against the 6 needed), the largest block of the training step
// that far from its bound. So:
//   * bn_stats_kernel: the (2, C) fp32 sums [sum(x - s), sum((x - s)^2)] of x
//     for a (C,) shift s (none: zero), reading x once. The wrapper launches it
//     once for the one-pass moments (s = 0), twice for the two-pass ones (s =
//     0 for the mean, then s = mean). Its design is the reduce's with one
//     input: row slabs x channel tiles, a 16-byte vector of channels a thread,
//     the row loop unrolled (kStatsUnroll rows in flight, as many bytes as the
//     reduce keeps), loads past L1, and the same fixed-order finish
//     (finish_tile): deterministic, no float atomics.
//   * bn_apply_relu_kernel: y = relu(x * a_io + b_io), a and b from
//     mask_factors, rounded as the backward's mask rounds them (above), so
//     y > 0 is that mask bit for bit; the ReLU is PyTorch's clamp_min (NaN
//     kept, fmaxf otherwise). x read once and y written once in 16-byte
//     vectors; each thread holds its channels' factors in registers and walks
//     rows, blockIdx.x = channel tile, blockIdx.y = slab.
// Both are bound by memory: 2 bytes an element read (stats) and 4 moved
// (apply) in bf16, 0.367 and 0.733 ms at 3.35 TB/s over the 35 regions of
// mnasnet1_0 @ 224 at batch 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Io;

template <> struct Io<float> {
  using P2 = float2;
  static constexpr int kPerWord = 1;  // elements in a 32-bit word
  static __device__ __forceinline__ float2 to_f2(float2 v) { return v; }
  static __device__ __forceinline__ float2 from_f2(float2 v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
  // The forward's x * a + b > 0 in fp32: two roundings, never an FMA.
  static __device__ __forceinline__ bool positive(float x, float a, float b) {
    return __fadd_rn(__fmul_rn(x, a), b) > 0.f;
  }
};

template <> struct Io<__nv_bfloat16> {
  using P2 = __nv_bfloat162;
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ __nv_bfloat162 from_f2(float2 v) { return __float22bfloat162_rn(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // A bf16 is the high half of the fp32 with the same value; the element at
  // the lower address is the word's low half.
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
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

// ---------------------------------------------------------------------------
// The reduce.

constexpr int kReduceThreads = 256;     // most threads of a reduce block
constexpr int kReduceBlocksPerSM = 3;    // resident blocks the registers must allow
constexpr int kSumUnroll = 16;           // table rows in flight per thread in column_sums
constexpr int kReduceSmemLimit = 48 * 1024;

// One vector of kWords 32-bit words (16, 8 or 4 bytes) from global memory:
// read-only, past L1 (nothing is read twice), and with L2 fetching the whole
// 256-byte block, which the neighbouring lanes and tiles read next.
template <int kWords>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[kWords]) {
  if constexpr (kWords == 4)
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
  else if constexpr (kWords == 2)
    asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
        : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  else
    asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];" : "=r"(w[0]) : "l"(p));
}

// A channel's factors of the mask and of xhat, staged in shared memory:
// {a_io, b_io, mean, inv}. Read with a volatile load where they are used, so
// that the compiler does not keep all V of them in registers across the row
// loop (they would cost the 16-byte kernel a third of its blocks per SM).
__device__ __forceinline__ float4 load_factors(const float4* f) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(f))
               : "memory");
  return v;
}

// Adds U rows' vectors of x and dy into the thread's sums, each channel's
// rows in order; fac holds the thread's V channels' factors.
template <typename T, int kWords, int U>
__device__ __forceinline__ void accumulate(const uint32_t (&xw)[U][kWords],
                                           const uint32_t (&dw)[U][kWords], const float4* fac,
                                           float* db, float* dg) {
  constexpr int P = Io<T>::kPerWord;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int e = w * P + k;
      const float4 f = load_factors(fac + e);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float xf[P], df[P];
        Io<T>::unpack(xw[u][w], xf);
        Io<T>::unpack(dw[u][w], df);
        const float g = Io<T>::positive(xf[k], f.x, f.y) ? df[k] : 0.f;
        db[e] += g;
        dg[e] += g * ((xf[k] - f.z) * f.w);
      }
    }
  }
}

// Sums each column of a (rows x ncols) fp32 table, in an order fixed by the
// shape alone: S consecutive threads (a power of two, at most 32, so one warp
// holds them) share a column, thread s of them adds rows s, s + S, ... in
// order, and warp shuffles add the S sums in a fixed tree; the block covers
// the columns in passes of blockDim.x / S. S is chosen to need the fewest
// rounds of kSumUnroll loads. Every thread of the block must call it, and
// blockDim.x must be a multiple of 32.
template <class Load, class Store>
__device__ __forceinline__ void column_sums(int rows, int ncols, Load load, Store store) {
  const int nthreads = blockDim.x;
  int S = 1, best = 0x7fffffff;
  for (int s = 1; s <= 32; s *= 2) {
    const int per_pass = nthreads / s;
    const int cost = ((ncols + per_pass - 1) / per_pass) *
                     ((rows + s * kSumUnroll - 1) / (s * kSumUnroll));
    if (cost < best) {
      best = cost;
      S = s;
    }
  }
  const int per_pass = nthreads / S;
  const int sub = threadIdx.x % S;
  for (int j0 = 0; j0 < ncols; j0 += per_pass) {
    const int j = j0 + threadIdx.x / S;
    float v = 0.f;
    if (j < ncols) {
      // kSumUnroll loads issued together, then added in row order.
      for (int r0 = sub; r0 < rows; r0 += S * kSumUnroll) {
        float t[kSumUnroll];
#pragma unroll
        for (int u = 0; u < kSumUnroll; ++u) {
          const int r = r0 + u * S;
          t[u] = r < rows ? load(r, j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kSumUnroll; ++u) v += t[u];
      }
    }
    for (int o = S / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (sub == 0 && j < ncols) store(j, v);
  }
}

// The end every ticketed reduce shares. Row lane `lane` of the block (when
// `active`) puts its two sums of V channels into its row of the table
// [lanes][2 * Ct + 1] (first, then second, at the thread's channel group
// `grp`); the block sums its lanes in a fixed order into its partial row
// (partial: [tiles][slabs][2][Ct]); the last block of the tile to finish (a
// ticket per tile from atomicInc, which wraps it back to 0 for the next
// launch) sums the tile's partials in slab order into out [2][C]. Atomics only
// hand out tickets: no sum depends on which block finishes last. Every thread
// of the block must call it.
template <int V>
__device__ __forceinline__ void finish_tile(const float (&first)[V], const float (&second)[V],
                                            bool active, float* table, int lanes, int lane,
                                            int grp, int Ct, float* __restrict__ partial,
                                            unsigned int* __restrict__ tickets,
                                            float* __restrict__ out, int C) {
  __shared__ bool last;
  const int ncols = 2 * Ct;
  const int pitch = ncols + 1;  // odd: lanes of one column fall in other banks
  if (active) {
    float* row = table + lane * pitch + grp * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      row[e] = first[e];
      row[Ct + e] = second[e];
    }
  }
  __syncthreads();
  const int slabs = gridDim.y;
  float* tile = partial + (size_t)blockIdx.x * slabs * ncols;
  float* mine = tile + (size_t)blockIdx.y * ncols;
  column_sums(lanes, ncols, [&](int r, int j) { return table[r * pitch + j]; },
              [&](int j, float v) { mine[j] = v; });
  // Publish the partial row, then take a ticket; the last block of the tile
  // sums the tile's partials in slab order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&tickets[blockIdx.x], (unsigned int)(slabs - 1)) == (unsigned int)(slabs - 1);
  __syncthreads();
  if (!last) return;
  const int cbase = blockIdx.x * Ct;
  column_sums(slabs, ncols, [&](int r, int j) { return __ldcg(tile + (size_t)r * ncols + j); },
              [&](int j, float v) {
                const int q = j >= Ct;
                const int c = cbase + j - q * Ct;
                if (c < C) out[q * C + c] = v;
              });
}

// Rows of x and dy a thread keeps in flight.
constexpr int kUnroll = 4;

// Block (tile, slab) of a reduce launch, blockDim.x threads: thread t owns
// channel group t % TG of the tile (V channels from c0) and row lane t / TG.
// partial: [tiles][slabs][2][TG * V] fp32 (dg, then db); tickets: [tiles],
// zero before the launch and after it; out: [2][C] fp32 (dg, then db).
// Shared memory: the tile's factors [TG * V] float4, then the table of row
// lane sums [lanes][2 * TG * V + 1] fp32.
template <typename T, int kWords>
__global__ void __launch_bounds__(kReduceThreads, kReduceBlocksPerSM)
bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ partial, unsigned int* __restrict__ tickets,
                 float* __restrict__ out, long long M, int C, int TG, long long rows_per_slab) {
  constexpr int V = kWords * Io<T>::kPerWord;
  extern __shared__ float4 smem[];
  const int lanes = blockDim.x / TG;
  const int grp = threadIdx.x % TG, lane = threadIdx.x / TG;
  const int Ct = TG * V;  // channels of a tile
  float4* fac = smem;
  float* table = reinterpret_cast<float*>(smem + Ct);
  for (int k = threadIdx.x; k < Ct; k += blockDim.x) {
    const int c = blockIdx.x * Ct + k;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < C) {
      mask_factors<T>(mean[c], inv[c], gamma[c], beta[c], &f.x, &f.y);
      f.z = mean[c];
      f.w = inv[c];
    }
    fac[k] = f;
  }
  __syncthreads();
  const int c0 = (blockIdx.x * TG + grp) * V;
  float db[V], dg[V];
#pragma unroll
  for (int e = 0; e < V; ++e) db[e] = dg[e] = 0.f;
  if (lane < lanes && c0 < C) {
    const float4* mine = fac + grp * V;
    const long long row0 = (long long)blockIdx.y * rows_per_slab;
    const long long row1 = min(M, row0 + rows_per_slab);
    const T* xp = x + c0;
    const T* dp = dy + c0;
    long long r = row0 + lane;
    for (; r + (long long)(kUnroll - 1) * lanes < row1; r += (long long)kUnroll * lanes) {
      uint32_t xw[kUnroll][kWords], dw[kUnroll][kWords];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = (size_t)(r + (long long)u * lanes) * C;
        load_words<kWords>(xp + off, xw[u]);
        load_words<kWords>(dp + off, dw[u]);
      }
      accumulate<T, kWords, kUnroll>(xw, dw, mine, db, dg);
    }
    for (; r < row1; r += lanes) {
      uint32_t xw[1][kWords], dw[1][kWords];
      const size_t off = (size_t)r * C;
      load_words<kWords>(xp + off, xw[0]);
      load_words<kWords>(dp + off, dw[0]);
      accumulate<T, kWords, 1>(xw, dw, mine, db, dg);
    }
  }
  // The block's row lanes, summed in a fixed order, into its partial row.
  finish_tile<V>(dg, db, lane < lanes, table, lanes, lane, grp, Ct, partial, tickets, out, C);
}

struct ReduceArgs {
  const void *x, *dy;
  const float *mean, *inv, *gamma, *beta;
  float* partial;
  unsigned int* tickets;
  float* out;
  long long M;
  int C, threads, TG, slabs;
};

template <typename T, int kWords>
int launch_reduce(const ReduceArgs& a, cudaStream_t stream) {
  constexpr int V = kWords * Io<T>::kPerWord;
  if (a.C % V) return (int)cudaErrorInvalidValue;
  const int tiles = (a.C / V + a.TG - 1) / a.TG;
  const size_t smem = (size_t)a.TG * V * sizeof(float4) +
                      (size_t)(a.threads / a.TG) * (2 * a.TG * V + 1) * sizeof(float);
  if (smem > kReduceSmemLimit) return (int)cudaErrorInvalidValue;
  const long long rows_per_slab = (a.M + a.slabs - 1) / a.slabs;
  bn_reduce_kernel<T, kWords><<<dim3(tiles, a.slabs), a.threads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.mean, a.inv, a.gamma, a.beta,
      a.partial, a.tickets, a.out, a.M, a.C, a.TG, rows_per_slab);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward's statistics.

// Rows of x a stats thread keeps in flight: the bytes the reduce keeps of x
// and dy together.
constexpr int kStatsUnroll = 2 * kUnroll;

// Adds U rows' vectors of x, less the shift, into the thread's sums and sums
// of squares, each channel's rows in order.
template <typename T, int kWords, int U>
__device__ __forceinline__ void accumulate_moments(const uint32_t (&xw)[U][kWords],
                                                   const float* sh, float* s1, float* s2) {
  constexpr int P = Io<T>::kPerWord;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int e = w * P + k;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float xf[P];
        Io<T>::unpack(xw[u][w], xf);
        const float d = xf[k] - sh[e];
        s1[e] += d;
        s2[e] = fmaf(d, d, s2[e]);
      }
    }
  }
}

// Block (tile, slab) of a stats launch, blockDim.x threads: thread t owns
// channel group t % TG of the tile (V channels from c0) and row lane t / TG.
// shift: (C,) fp32 or null (zero); partial, tickets and out as the reduce's
// (out: sum(x - s), then sum((x - s)^2)). Shared memory: the table of row
// lane sums [lanes][2 * TG * V + 1] fp32.
template <typename T, int kWords>
__global__ void __launch_bounds__(kReduceThreads, kReduceBlocksPerSM)
bn_stats_kernel(const T* __restrict__ x, const float* __restrict__ shift,
                float* __restrict__ partial, unsigned int* __restrict__ tickets,
                float* __restrict__ out, long long M, int C, int TG, long long rows_per_slab) {
  constexpr int V = kWords * Io<T>::kPerWord;
  extern __shared__ float4 smem[];
  const int lanes = blockDim.x / TG;
  const int grp = threadIdx.x % TG, lane = threadIdx.x / TG;
  const int Ct = TG * V;
  float* table = reinterpret_cast<float*>(smem);
  const int c0 = (blockIdx.x * TG + grp) * V;
  float s1[V], s2[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = sh[e] = 0.f;
  if (lane < lanes && c0 < C) {
    if (shift != nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) sh[e] = shift[c0 + e];
    }
    const long long row0 = (long long)blockIdx.y * rows_per_slab;
    const long long row1 = min(M, row0 + rows_per_slab);
    const T* xp = x + c0;
    long long r = row0 + lane;
    for (; r + (long long)(kStatsUnroll - 1) * lanes < row1;
         r += (long long)kStatsUnroll * lanes) {
      uint32_t xw[kStatsUnroll][kWords];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        load_words<kWords>(xp + (size_t)(r + (long long)u * lanes) * C, xw[u]);
      accumulate_moments<T, kWords, kStatsUnroll>(xw, sh, s1, s2);
    }
    for (; r < row1; r += lanes) {
      uint32_t xw[1][kWords];
      load_words<kWords>(xp + (size_t)r * C, xw[0]);
      accumulate_moments<T, kWords, 1>(xw, sh, s1, s2);
    }
  }
  finish_tile<V>(s1, s2, lane < lanes, table, lanes, lane, grp, Ct, partial, tickets, out, C);
}

struct StatsArgs {
  const void* x;
  const float* shift;
  float* partial;
  unsigned int* tickets;
  float* out;
  long long M;
  int C, threads, TG, slabs;
};

template <typename T, int kWords>
int launch_stats(const StatsArgs& a, cudaStream_t stream) {
  constexpr int V = kWords * Io<T>::kPerWord;
  if (a.C % V) return (int)cudaErrorInvalidValue;
  const int tiles = (a.C / V + a.TG - 1) / a.TG;
  const size_t smem = (size_t)(a.threads / a.TG) * (2 * a.TG * V + 1) * sizeof(float);
  if (smem > kReduceSmemLimit) return (int)cudaErrorInvalidValue;
  const long long rows_per_slab = (a.M + a.slabs - 1) / a.slabs;
  bn_stats_kernel<T, kWords><<<dim3(tiles, a.slabs), a.threads, smem, stream>>>(
      static_cast<const T*>(a.x), a.shift, a.partial, a.tickets, a.out, a.M, a.C, a.TG,
      rows_per_slab);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward's normalise-and-ReLU.

constexpr int kApplyThreads = 256;  // most threads of an apply block
constexpr int kApplyUnroll = 4;     // rows of x a thread keeps in flight

template <int kWords>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[kWords]) {
  if constexpr (kWords == 4)
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (kWords == 2)
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *static_cast<uint32_t*>(p) = w[0];
}

// y = relu(x * a + b) of one element, as the forward's PyTorch ops compute it:
// the product and the sum each rounded to T (Io<T>::positive's arithmetic),
// then clamp_min(0), which keeps a NaN and is fmaxf otherwise.
template <typename T>
__device__ __forceinline__ float apply_relu(float x, float a, float b) {
  const float v = Io<T>::round(__fadd_rn(Io<T>::round(__fmul_rn(x, a)), b));
  return v != v ? v : fmaxf(v, 0.f);
}

// One vector of kWords words of x, normalised in place. A bf16 result is a
// bf16 value held in an fp32, whose low half is zero, so its high half is the
// bf16's bits.
template <typename T, int kWords>
__device__ __forceinline__ void apply_words(uint32_t (&w)[kWords], const float* a,
                                            const float* b) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (Io<T>::kPerWord == 1) {
      w[i] = __float_as_uint(apply_relu<T>(__uint_as_float(w[i]), a[i], b[i]));
    } else {
      float f[2];
      Io<T>::unpack(w[i], f);
      const float lo = apply_relu<T>(f[0], a[2 * i], b[2 * i]);
      const float hi = apply_relu<T>(f[1], a[2 * i + 1], b[2 * i + 1]);
      w[i] = (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
    }
  }
}

// Block (tile, slab) of an apply launch: thread t owns channel group t % TG of
// the tile (V channels from c0) and row lane t / TG; it computes its
// channels' factors once and streams the slab's rows.
template <typename T, int kWords>
__global__ void __launch_bounds__(kApplyThreads)
bn_apply_relu_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ inv, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y, long long M, int C,
                     int TG, long long rows_per_slab) {
  constexpr int V = kWords * Io<T>::kPerWord;
  const int lanes = blockDim.x / TG;
  const int grp = threadIdx.x % TG, lane = threadIdx.x / TG;
  const int c0 = (blockIdx.x * TG + grp) * V;
  if (lane >= lanes || c0 >= C) return;
  float a[V], b[V];
#pragma unroll
  for (int e = 0; e < V; ++e)
    mask_factors<T>(mean[c0 + e], inv[c0 + e], gamma[c0 + e], beta[c0 + e], &a[e], &b[e]);
  const long long row0 = (long long)blockIdx.y * rows_per_slab;
  const long long row1 = min(M, row0 + rows_per_slab);
  const T* xp = x + c0;
  T* yp = y + c0;
  long long r = row0 + lane;
  for (; r + (long long)(kApplyUnroll - 1) * lanes < row1; r += (long long)kApplyUnroll * lanes) {
    uint32_t w[kApplyUnroll][kWords];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u)
      load_words<kWords>(xp + (size_t)(r + (long long)u * lanes) * C, w[u]);
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      apply_words<T, kWords>(w[u], a, b);
      store_words<kWords>(yp + (size_t)(r + (long long)u * lanes) * C, w[u]);
    }
  }
  for (; r < row1; r += lanes) {
    uint32_t w[kWords];
    load_words<kWords>(xp + (size_t)r * C, w);
    apply_words<T, kWords>(w, a, b);
    store_words<kWords>(yp + (size_t)r * C, w);
  }
}

template <typename T, int kWords>
int launch_apply(const void* x, const float* mean, const float* inv, const float* gamma,
                 const float* beta, void* y, long long M, int C, int threads, int TG, int slabs,
                 cudaStream_t stream) {
  constexpr int V = kWords * Io<T>::kPerWord;
  if (C % V) return (int)cudaErrorInvalidValue;
  const int tiles = (C / V + TG - 1) / TG;
  const long long rows_per_slab = (M + slabs - 1) / slabs;
  bn_apply_relu_kernel<T, kWords><<<dim3(tiles, slabs), threads, 0, stream>>>(
      static_cast<const T*>(x), mean, inv, gamma, beta, static_cast<T*>(y), M, C, TG,
      rows_per_slab);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The dx pass.

// Block geometry of the dx kernel: blockDim.x = TP channel pairs,
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

// The vector widths and the alignment the forward's kernels take: 16, 8 or 4
// bytes holding at least two elements, dividing every address.
bool bad_vector(int vec_bytes, int is_bf16, uintptr_t addresses) {
  return (vec_bytes != 4 && vec_bytes != 8 && vec_bytes != 16) || addresses % vec_bytes ||
         (!is_bf16 && vec_bytes == 4);
}

}  // namespace

extern "C" {

// x, dy (M = N*H*W rows, C) in bf16 (is_bf16=1) or fp32, both aligned to
// vec_bytes (16, 8 or 4: the vector a thread loads, at least two elements);
// mean, inv, gamma, beta (C,) fp32; partial fp32 scratch of tiles * slabs * 2 *
// TG * V floats (V = vec_bytes / element size, tiles = ceil(C / V / TG));
// tickets: tiles zeroed uint32, left zeroed; out (2, C) fp32: dg, then db.
// One launch of `threads` threads a block; C even. Returns its
// cudaGetLastError().
int bn_bwd_reduce(const void* x, const void* dy, const void* mean, const void* inv,
                  const void* gamma, const void* beta, void* partial, void* tickets, void* out,
                  long long M, int C, int vec_bytes, int threads, int TG, int slabs, int is_bf16,
                  void* stream) {
  if (M <= 0 || C <= 0 || C % 2 || threads <= 0 || threads % 32 || threads > kReduceThreads ||
      TG <= 0 || TG > threads || slabs <= 0 || slabs > 65535 ||
      (vec_bytes != 4 && vec_bytes != 8 && vec_bytes != 16) ||
      ((uintptr_t)x | (uintptr_t)dy) % vec_bytes || (!is_bf16 && vec_bytes == 4))
    return (int)cudaErrorInvalidValue;
  const ReduceArgs a{x, dy, static_cast<const float*>(mean), static_cast<const float*>(inv),
                     static_cast<const float*>(gamma), static_cast<const float*>(beta),
                     static_cast<float*>(partial), static_cast<unsigned int*>(tickets),
                     static_cast<float*>(out), M, C, threads, TG, slabs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec_bytes == 16) return launch_reduce<__nv_bfloat16, 4>(a, s);
    if (vec_bytes == 8) return launch_reduce<__nv_bfloat16, 2>(a, s);
    return launch_reduce<__nv_bfloat16, 1>(a, s);
  }
  if (vec_bytes == 16) return launch_reduce<float, 4>(a, s);
  return launch_reduce<float, 2>(a, s);
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

// x (M, C) in bf16 or fp32, aligned to vec_bytes; shift (C,) fp32, or null for
// zero; partial, tickets and the launch as the reduce's; out (2, C) fp32:
// sum(x - shift), then sum((x - shift)^2). C even.
int bn_fwd_stats(const void* x, const void* shift, void* partial, void* tickets, void* out,
                 long long M, int C, int vec_bytes, int threads, int TG, int slabs, int is_bf16,
                 void* stream) {
  if (M <= 0 || C <= 0 || C % 2 || threads <= 0 || threads % 32 || threads > kReduceThreads ||
      TG <= 0 || TG > threads || slabs <= 0 || slabs > 65535 ||
      bad_vector(vec_bytes, is_bf16, (uintptr_t)x))
    return (int)cudaErrorInvalidValue;
  const StatsArgs a{x, static_cast<const float*>(shift), static_cast<float*>(partial),
                    static_cast<unsigned int*>(tickets), static_cast<float*>(out), M, C,
                    threads, TG, slabs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec_bytes == 16) return launch_stats<__nv_bfloat16, 4>(a, s);
    if (vec_bytes == 8) return launch_stats<__nv_bfloat16, 2>(a, s);
    return launch_stats<__nv_bfloat16, 1>(a, s);
  }
  if (vec_bytes == 16) return launch_stats<float, 4>(a, s);
  return launch_stats<float, 2>(a, s);
}

// x and y (M, C) in bf16 or fp32, both aligned to vec_bytes; mean, inv =
// rsqrt(var + eps), gamma, beta (C,) fp32. One launch of `threads` threads a
// block, TG vectors of a row a tile; C even.
int bn_relu_apply(const void* x, const void* mean, const void* inv, const void* gamma,
                  const void* beta, void* y, long long M, int C, int vec_bytes, int threads,
                  int TG, int slabs, int is_bf16, void* stream) {
  if (M <= 0 || C <= 0 || C % 2 || threads <= 0 || threads % 32 || threads > kApplyThreads ||
      TG <= 0 || TG > threads || slabs <= 0 || slabs > 65535 ||
      bad_vector(vec_bytes, is_bf16, (uintptr_t)x | (uintptr_t)y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *m = static_cast<const float*>(mean), *i = static_cast<const float*>(inv),
              *g = static_cast<const float*>(gamma), *b = static_cast<const float*>(beta);
  if (is_bf16) {
    if (vec_bytes == 16)
      return launch_apply<__nv_bfloat16, 4>(x, m, i, g, b, y, M, C, threads, TG, slabs, s);
    if (vec_bytes == 8)
      return launch_apply<__nv_bfloat16, 2>(x, m, i, g, b, y, M, C, threads, TG, slabs, s);
    return launch_apply<__nv_bfloat16, 1>(x, m, i, g, b, y, M, C, threads, TG, slabs, s);
  }
  if (vec_bytes == 16) return launch_apply<float, 4>(x, m, i, g, b, y, M, C, threads, TG, slabs, s);
  return launch_apply<float, 2>(x, m, i, g, b, y, M, C, threads, TG, slabs, s);
}

}  // extern "C"
