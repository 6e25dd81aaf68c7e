// Squeeze-and-excitation on NHWC planes, for Hopper (sm_90a).
//
// Replaces no JAX kernel: the reference's squeeze-and-excitation is plain JAX
// (EfficientNet has no counterpart in mnasnet_tpu/ at all), and XLA fuses it on
// the TPU. In PyTorch the same module ran as library ops over the expanded
// planes: a mean over H and W, a non-vectorised broadcasting multiply, and in
// the backward that autograd builds a broadcast g * gate, a same-shape g * x and
// its sum, and the mean's gradient expanded to the whole plane and added. That
// is some 18-20 bytes an element, about 18 ms of EfficientNet-B4's 123 ms train
// step at batch 64 (380 px, bf16): the largest block of library work in it. So,
// for x (N, HW, C) and per-(n, c) fp32 vectors:
//
//   se_pool_kernel   pool[n, c] = sum_hw x / HW in fp32, rounded to x's dtype
//                    as torch's mean rounds it                 (reads x)
//   se_scale_kernel  y = x * gate[n, c], rounded once           (reads x, writes y)
//   se_dgate_kernel  dgate[n, c] = sum_hw g * x in fp32         (reads g and x)
//   se_dx_kernel     dx = g * gate[n, c] + dpool[n, c] / HW, summed in fp32
//                    and rounded once                           (reads g, writes dx)
//
// The small MLP between pool and scale (two 1x1 convs with bias on (N, C)
// vectors, SiLU, sigmoid) and its backward stay on torch ops
// (ops/cuda/se.py). The pooled mean's gradient and the scale's gradient meet
// in se_dx_kernel's registers, so no plane-sized gradient is expanded or added.
//
// What bounds them on an H100: memory. Per element 6 bytes in the forward
// (pool reads x; scale reads x and writes y) and 8 in the backward (dgate reads
// g and x; dx reads g and writes dx) in bf16, one or two fp32 operations
// against them. Over B4's 32 SE planes at batch 64 (1.251 G elements a step)
// that is 2.24 ms forward and 2.99 ms backward at 3.35 TB/s.
//
// Layout of a launch: blockIdx.x = channel tile, blockIdx.y = row slab,
// blockIdx.z = sample n. Thread t of a block owns channel group t % TG of the
// tile (V adjacent channels: a 16-byte vector where C and the pointers allow,
// else 8 or 4 bytes) and row lane t / TG; neighbouring threads take
// neighbouring vectors and then rows, so a warp reads contiguous runs of each
// row. Loads skip L1 (nothing is read twice by a block) and ask L2 for whole
// 256-byte blocks. The planner (ops/cuda/se.py) picks the tile and the slabs
// from (N, HW, C) alone: the first stage's planes are 36,100 rows of 24-48
// channels, the last 144 rows of 2,688.
//
// The two reductions (pool, dgate) are deterministic, with no float atomics,
// as the BN region reduce of bn_bwd.cu: each thread sums its rows in order;
// the block sums its row lanes through shared memory in a fixed order
// (column_sums) into one fp32 partial row per (n, tile, slab); the last block
// of an (n, tile) to finish (a ticket from atomicInc, which wraps back to 0 for
// the next launch) sums the partials in slab order. Atomics only hand out
// tickets, so two launches give the same bits. A plan of one slab writes its
// sums directly. The elementwise passes (scale, dx) hold their channels'
// vectors in registers and stream the slab's rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Io;

template <> struct Io<float> {
  static constexpr int kPerWord = 1;  // elements in a 32-bit word
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
  static __device__ __forceinline__ uint32_t pack(const float* f) { return __float_as_uint(f[0]); }
  static __device__ __forceinline__ float to_io(float v) { return v; }
};

template <> struct Io<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  // A bf16 is the high half of the fp32 with the same value; the element at
  // the lower address is the word's low half.
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  // Each element rounded to nearest even, the lower address in the low half.
  static __device__ __forceinline__ uint32_t pack(const float* f) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat16 to_io(float v) { return __float2bfloat16_rn(v); }
};

constexpr int kThreads = 256;     // most threads of a block
constexpr int kSumUnroll = 16;    // table rows in flight per thread in column_sums
constexpr int kPoolUnroll = 8;    // rows of x a pool thread keeps in flight
constexpr int kDgateUnroll = 4;   // rows of g and x a dgate thread keeps in flight
constexpr int kMapUnroll = 4;     // rows a scale or dx thread keeps in flight
constexpr int kSmemLimit = 48 * 1024;

// One vector of kWords 32-bit words (16, 8 or 4 bytes) from global memory:
// read-only, past L1, and with L2 fetching the whole 256-byte block, which the
// neighbouring lanes read next.
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

template <int kWords>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[kWords]) {
  if constexpr (kWords == 4)
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (kWords == 2)
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *static_cast<uint32_t*>(p) = w[0];
}

// Sums each column of a (rows x ncols) fp32 table, in an order fixed by the
// shape alone (bn_bwd.cu's routine): S consecutive threads (a power of two, at
// most 32) share a column, thread s of them adds rows s, s + S, ... in order,
// and warp shuffles add the S sums in a fixed tree; the block covers the
// columns in passes of blockDim.x / S. Every thread of the block must call it,
// and blockDim.x must be a multiple of 32.
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

// Adds one row's vector into the thread's V sums: x (pool), or g * x (dgate).
template <typename T, int kWords, bool kProduct>
__device__ __forceinline__ void accumulate(const uint32_t (&aw)[kWords],
                                           const uint32_t (&bw)[kWords], float* s) {
  constexpr int P = Io<T>::kPerWord;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    float a[P], b[P];
    Io<T>::unpack(aw[w], a);
    if constexpr (kProduct) Io<T>::unpack(bw[w], b);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if constexpr (kProduct)
        s[w * P + k] = fmaf(a[k], b[k], s[w * P + k]);
      else
        s[w * P + k] += a[k];
    }
  }
}

// Block (tile, slab, n) of a reduction over the HW rows of sample n: the sums
// of a (pool) or of a * b (dgate), per channel. partial: [N][tiles][slabs][Ct]
// fp32 (Ct = TG * V, the tile's channels); tickets: [N][tiles], zero before the
// launch and after it. The sum of (n, c) goes to finish(n * C + c, sum).
// Shared memory: the table of row-lane sums [lanes][Ct + 1] fp32.
template <typename T, int kWords, bool kProduct, int kU, class Finish>
__device__ __forceinline__ void
reduce_body(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ partial,
            unsigned int* __restrict__ tickets, long long HW, int C, int TG,
            long long rows_per_slab, Finish finish) {
  constexpr int V = kWords * Io<T>::kPerWord;
  extern __shared__ float table[];
  __shared__ bool last;
  const int lanes = blockDim.x / TG;
  const int grp = threadIdx.x % TG, lane = threadIdx.x / TG;
  const int Ct = TG * V;
  const int pitch = Ct + 1;  // odd: lanes of one column fall in other banks
  const int n = blockIdx.z;
  const int c0 = (blockIdx.x * TG + grp) * V;
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
  if (lane < lanes && c0 < C) {
    const long long row0 = (long long)blockIdx.y * rows_per_slab;
    const long long row1 = min(HW, row0 + rows_per_slab);
    const size_t base = (size_t)n * HW * C + c0;
    const T* ap = a + base;
    const T* bp = kProduct ? b + base : a + base;
    long long r = row0 + lane;
    for (; r + (long long)(kU - 1) * lanes < row1; r += (long long)kU * lanes) {
      uint32_t aw[kU][kWords], bw[kU][kWords];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const size_t off = (size_t)(r + (long long)u * lanes) * C;
        load_words<kWords>(ap + off, aw[u]);
        if constexpr (kProduct) load_words<kWords>(bp + off, bw[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) accumulate<T, kWords, kProduct>(aw[u], bw[u], s);
    }
    for (; r < row1; r += lanes) {
      uint32_t aw[1][kWords], bw[1][kWords];
      const size_t off = (size_t)r * C;
      load_words<kWords>(ap + off, aw[0]);
      if constexpr (kProduct) load_words<kWords>(bp + off, bw[0]);
      accumulate<T, kWords, kProduct>(aw[0], bw[0], s);
    }
  }
  if (lane < lanes) {
    float* row = table + lane * pitch + grp * V;
#pragma unroll
    for (int e = 0; e < V; ++e) row[e] = s[e];
  }
  __syncthreads();
  const int cbase = blockIdx.x * Ct;
  const int slabs = gridDim.y;
  auto load_table = [&](int r, int j) { return table[r * pitch + j]; };
  auto store_out = [&](int j, float v) {
    const int c = cbase + j;
    if (c < C) finish((size_t)n * C + c, v);
  };
  if (slabs == 1) {
    column_sums(lanes, Ct, load_table, store_out);
    return;
  }
  // The block's row lanes, summed in a fixed order, into its partial row;
  // then a ticket, and the last block of (n, tile) sums the partials in slab
  // order.
  const size_t tile_id = (size_t)n * gridDim.x + blockIdx.x;
  float* tile = partial + tile_id * slabs * Ct;
  float* mine = tile + (size_t)blockIdx.y * Ct;
  column_sums(lanes, Ct, load_table, [&](int j, float v) { mine[j] = v; });
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&tickets[tile_id], (unsigned int)(slabs - 1)) == (unsigned int)(slabs - 1);
  __syncthreads();
  if (!last) return;
  column_sums(slabs, Ct, [&](int r, int j) { return __ldcg(tile + (size_t)r * Ct + j); },
              store_out);
}

#define SE_REDUCE_PARAMS                                                                \
  const T *__restrict__ a, const T *__restrict__ b, float *__restrict__ partial,        \
      unsigned int *__restrict__ tickets, void *__restrict__ out, long long HW, int C, \
      int TG, long long rows_per_slab

// pool[n, c] = sum over the rows of x, over HW, rounded to T.
template <typename T, int kWords>
__global__ void __launch_bounds__(kThreads) se_pool_kernel(SE_REDUCE_PARAMS) {
  T* o = static_cast<T*>(out);
  const float hw = (float)HW;
  reduce_body<T, kWords, false, kPoolUnroll>(
      a, b, partial, tickets, HW, C, TG, rows_per_slab,
      [&](size_t i, float v) { o[i] = Io<T>::to_io(__fdiv_rn(v, hw)); });
}

// dgate[n, c] = sum over the rows of g * x, fp32.
template <typename T, int kWords>
__global__ void __launch_bounds__(kThreads) se_dgate_kernel(SE_REDUCE_PARAMS) {
  float* o = static_cast<float*>(out);
  reduce_body<T, kWords, true, kDgateUnroll>(a, b, partial, tickets, HW, C, TG, rows_per_slab,
                                             [&](size_t i, float v) { o[i] = v; });
}

// Block (tile, slab, n) of an elementwise pass over sample n's rows:
// out = a * s[n, c] (scale), or a * s[n, c] + t[n, c] / HW in one fused
// multiply-add (dx), rounded once to T. Each thread holds its V channels'
// factors in registers and streams the slab's rows.
template <typename T, int kWords, bool kDx>
__device__ __forceinline__ void map_body(const T* __restrict__ a, const float* __restrict__ s,
                                         const float* __restrict__ t, T* __restrict__ out,
                                         long long HW, int C, int TG, long long rows_per_slab) {
  constexpr int V = kWords * Io<T>::kPerWord;
  constexpr int P = Io<T>::kPerWord;
  const int lanes = blockDim.x / TG;
  const int grp = threadIdx.x % TG, lane = threadIdx.x / TG;
  const int c0 = (blockIdx.x * TG + grp) * V;
  if (lane >= lanes || c0 >= C) return;
  const int n = blockIdx.z;
  float f[V], add[V];
  const float hw = (float)HW;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    f[e] = s[(size_t)n * C + c0 + e];
    add[e] = 0.f;
    if constexpr (kDx) add[e] = __fdiv_rn(t[(size_t)n * C + c0 + e], hw);
  }
  const long long row0 = (long long)blockIdx.y * rows_per_slab;
  const long long row1 = min(HW, row0 + rows_per_slab);
  const size_t base = (size_t)n * HW * C + c0;
  const T* ap = a + base;
  T* op = out + base;
  auto apply = [&](uint32_t (&w)[kWords]) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      float v[P];
      Io<T>::unpack(w[i], v);
#pragma unroll
      for (int k = 0; k < P; ++k)
        v[k] = kDx ? fmaf(v[k], f[i * P + k], add[i * P + k]) : __fmul_rn(v[k], f[i * P + k]);
      w[i] = Io<T>::pack(v);
    }
  };
  long long r = row0 + lane;
  for (; r + (long long)(kMapUnroll - 1) * lanes < row1; r += (long long)kMapUnroll * lanes) {
    uint32_t w[kMapUnroll][kWords];
#pragma unroll
    for (int u = 0; u < kMapUnroll; ++u)
      load_words<kWords>(ap + (size_t)(r + (long long)u * lanes) * C, w[u]);
#pragma unroll
    for (int u = 0; u < kMapUnroll; ++u) {
      apply(w[u]);
      store_words<kWords>(op + (size_t)(r + (long long)u * lanes) * C, w[u]);
    }
  }
  for (; r < row1; r += lanes) {
    uint32_t w[kWords];
    load_words<kWords>(ap + (size_t)r * C, w);
    apply(w);
    store_words<kWords>(op + (size_t)r * C, w);
  }
}

#define SE_MAP_PARAMS                                                                      \
  const T *__restrict__ a, const float *__restrict__ s, const float *__restrict__ t,      \
      T *__restrict__ out, long long HW, int C, int TG, long long rows_per_slab

// y = x * gate[n, c].
template <typename T, int kWords>
__global__ void __launch_bounds__(kThreads) se_scale_kernel(SE_MAP_PARAMS) {
  map_body<T, kWords, false>(a, s, t, out, HW, C, TG, rows_per_slab);
}

// dx = g * gate[n, c] + dpool[n, c] / HW.
template <typename T, int kWords>
__global__ void __launch_bounds__(kThreads) se_dx_kernel(SE_MAP_PARAMS) {
  map_body<T, kWords, true>(a, s, t, out, HW, C, TG, rows_per_slab);
}

struct Launch {
  int N;
  long long HW;
  int C, vec_bytes, threads, TG, slabs, is_bf16;
};

// The checks every entry shares: the plan's ranges, a vector of 16, 8 or 4
// bytes holding at least two elements that divides C and every address.
bool bad_launch(const Launch& l, uintptr_t addresses) {
  const int itemsize = l.is_bf16 ? 2 : 4;
  return l.N <= 0 || l.N > 65535 || l.HW <= 0 || l.C <= 0 || l.threads <= 0 ||
         l.threads % 32 || l.threads > kThreads || l.TG <= 0 || l.TG > l.threads ||
         l.slabs <= 0 || l.slabs > 65535 ||
         (l.vec_bytes != 4 && l.vec_bytes != 8 && l.vec_bytes != 16) ||
         l.vec_bytes / itemsize < 2 || l.C % (l.vec_bytes / itemsize) ||
         addresses % l.vec_bytes;
}

dim3 grid_of(const Launch& l, int V) {
  return dim3((l.C / V + l.TG - 1) / l.TG, l.slabs, l.N);
}

template <typename T, int kWords, bool kProduct>
int launch_reduce(const void* a, const void* b, void* partial, void* tickets, void* out,
                  const Launch& l, cudaStream_t stream) {
  constexpr int V = kWords * Io<T>::kPerWord;
  const size_t smem = (size_t)(l.threads / l.TG) * (l.TG * V + 1) * sizeof(float);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const long long rows_per_slab = (l.HW + l.slabs - 1) / l.slabs;
  auto kernel = kProduct ? se_dgate_kernel<T, kWords> : se_pool_kernel<T, kWords>;
  kernel<<<grid_of(l, V), l.threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(partial),
      static_cast<unsigned int*>(tickets), out, l.HW, l.C, l.TG, rows_per_slab);
  return (int)cudaGetLastError();
}

template <bool kProduct>
int reduce_entry(const void* a, const void* b, void* partial, void* tickets, void* out,
                 const Launch& l, void* stream) {
  if (bad_launch(l, (uintptr_t)a | (uintptr_t)b)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l.is_bf16) {
    if (l.vec_bytes == 16)
      return launch_reduce<__nv_bfloat16, 4, kProduct>(a, b, partial, tickets, out, l, st);
    if (l.vec_bytes == 8)
      return launch_reduce<__nv_bfloat16, 2, kProduct>(a, b, partial, tickets, out, l, st);
    return launch_reduce<__nv_bfloat16, 1, kProduct>(a, b, partial, tickets, out, l, st);
  }
  if (l.vec_bytes == 16)
    return launch_reduce<float, 4, kProduct>(a, b, partial, tickets, out, l, st);
  return launch_reduce<float, 2, kProduct>(a, b, partial, tickets, out, l, st);
}

template <typename T, int kWords, bool kDx>
int launch_map(const void* a, const float* s, const float* t, void* out, const Launch& l,
               cudaStream_t stream) {
  constexpr int V = kWords * Io<T>::kPerWord;
  const long long rows_per_slab = (l.HW + l.slabs - 1) / l.slabs;
  auto kernel = kDx ? se_dx_kernel<T, kWords> : se_scale_kernel<T, kWords>;
  kernel<<<grid_of(l, V), l.threads, 0, stream>>>(static_cast<const T*>(a), s, t,
                                                  static_cast<T*>(out), l.HW, l.C, l.TG,
                                                  rows_per_slab);
  return (int)cudaGetLastError();
}

template <bool kDx>
int map_entry(const void* a, const void* s, const void* t, void* out, const Launch& l,
              void* stream) {
  if (bad_launch(l, (uintptr_t)a | (uintptr_t)out)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *sf = static_cast<const float*>(s), *tf = static_cast<const float*>(t);
  if (l.is_bf16) {
    if (l.vec_bytes == 16) return launch_map<__nv_bfloat16, 4, kDx>(a, sf, tf, out, l, st);
    if (l.vec_bytes == 8) return launch_map<__nv_bfloat16, 2, kDx>(a, sf, tf, out, l, st);
    return launch_map<__nv_bfloat16, 1, kDx>(a, sf, tf, out, l, st);
  }
  if (l.vec_bytes == 16) return launch_map<float, 4, kDx>(a, sf, tf, out, l, st);
  return launch_map<float, 2, kDx>(a, sf, tf, out, l, st);
}

}  // namespace

extern "C" {

// x (N, HW, C) in bf16 (is_bf16=1) or fp32, aligned to vec_bytes (16, 8 or 4:
// the vector a thread loads, at least two elements, dividing C); partial fp32
// scratch of N * tiles * slabs * TG * V floats (V = vec_bytes / element size,
// tiles = ceil(C / V / TG)), unused when slabs is 1; tickets: N * tiles zeroed
// uint32, left zeroed; out (N, C) in x's dtype: the mean over HW. One launch
// of `threads` threads a block. Returns its cudaGetLastError().
int se_pool(const void* x, void* partial, void* tickets, void* out, int N, long long HW, int C,
            int vec_bytes, int threads, int TG, int slabs, int is_bf16, void* stream) {
  const Launch l{N, HW, C, vec_bytes, threads, TG, slabs, is_bf16};
  return reduce_entry<false>(x, x, partial, tickets, out, l, stream);
}

// g and x (N, HW, C), one dtype, both aligned to vec_bytes; partial, tickets
// and the launch as se_pool's; out (N, C) fp32: the sum over HW of g * x.
int se_dgate(const void* g, const void* x, void* partial, void* tickets, void* out, int N,
             long long HW, int C, int vec_bytes, int threads, int TG, int slabs, int is_bf16,
             void* stream) {
  const Launch l{N, HW, C, vec_bytes, threads, TG, slabs, is_bf16};
  return reduce_entry<true>(g, x, partial, tickets, out, l, stream);
}

// x and y (N, HW, C) in bf16 or fp32, both aligned to vec_bytes; gate (N, C)
// fp32. y = x * gate, rounded once to x's dtype.
int se_scale(const void* x, const void* gate, void* y, int N, long long HW, int C, int vec_bytes,
             int threads, int TG, int slabs, int is_bf16, void* stream) {
  const Launch l{N, HW, C, vec_bytes, threads, TG, slabs, is_bf16};
  return map_entry<false>(x, gate, nullptr, y, l, stream);
}

// g and dx (N, HW, C), both aligned to vec_bytes; gate, dpool (N, C) fp32.
// dx = g * gate + dpool / HW in fp32, rounded once to g's dtype.
int se_dx(const void* g, const void* gate, const void* dpool, void* dx, int N, long long HW,
          int C, int vec_bytes, int threads, int TG, int slabs, int is_bf16, void* stream) {
  const Launch l{N, HW, C, vec_bytes, threads, TG, slabs, is_bf16};
  return map_entry<true>(g, gate, dpool, dx, l, stream);
}

}  // extern "C"
