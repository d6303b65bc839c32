// Paged decode/verify attention that walks the page table over the block pool
// in place, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` (vtpu/ops/decode_attn.py:347,
// driven by `_paged_call`, :403, exposed as `paged_decode_attention`, :462).
// On the TPU the grid's second axis walks the window pages in order and the
// online-softmax state carries across grid steps in VMEM scratch. Hopper
// blocks run in no order, so that sequential axis becomes a loop inside one
// block and nothing carries across blocks.
//
// Schedule: one block per (slot b, head h). The block reads its own table
// row, and for each window page j loads the [page, Dh] K and V tiles of head
// h from pool block table[b, j] of plane `layer` into shared memory (the
// whole page in flight at once through cp.async; K rows padded so the
// per-key dot products hit distinct banks). It forms the T x page scores
// in f32, SELECTS masked entries (k_pos >= kv_len[b, t]) to -1e30 and their
// p to exactly 0 -- never 0 x value, so garbage in the null block 0 cannot
// leak -- and folds the page into an online softmax with f32 running
// max/denominator and an f32 (T, Dh) accumulator in shared memory (thread d
// owns column d). P is rounded to the pool's type before P.V, as the TPU
// kernel casts p to v's dtype. One output write per (b, t, h, d). Pages past the row's longest kv_len contribute
// nothing, so the walk stops there instead of streaming null-block padding.
//
// What bounds it on this card (H100 SXM data-sheet peaks, 700 W power
// limit): a decode tick moves up to ~21 MB of K/V per call at window 1280 for
// the flagship serving shape (~6.3 us at 3.35 TB/s) and does almost no
// arithmetic, so the bound is bytes. B x H blocks (32 at 4 slots x
// 8 heads) occupy a quarter of the 132 SMs, and each block loads its pages
// one after another with no overlap of loads and arithmetic, so this version
// is latency-bound above the byte floor. Splitting the page walk across
// blocks with a combine pass (flash-decoding) and double-buffered TMA page
// loads are the follow-up that fills the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int MAXT = 16;  // queries per slot per call (1 for decode, K+1 for verify)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// K rows carry 16 bytes of padding: threads reading 16-byte chunks of
// consecutive keys' rows then hit distinct banks in each 8-thread phase.
template <typename T>
__host__ __device__ constexpr int k_row_elems(int dh) { return dh + 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ size_t smem_layout(int t, int dh, int page, size_t* off_v, size_t* off_q,
                                       size_t* off_s, size_t* off_stats) {
  size_t off = align16(sizeof(T) * (size_t)page * k_row_elems<T>(dh));
  *off_v = off;
  off = align16(off + sizeof(T) * (size_t)page * dh);
  *off_q = off;
  off = align16(off + 2 * sizeof(float) * (size_t)t * dh);  // q, then the accumulator
  *off_s = off;
  off = align16(off + sizeof(float) * (size_t)t * page);
  *off_stats = off;
  return off + sizeof(float) * 3 * (size_t)t;
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// q . k for one key row held in shared memory, read as 16-byte chunks
template <typename T>
__device__ __forceinline__ float dot_row(const float* qrow, const T* krow, int dh) {
  float s = 0.f;
  const uint4* k16 = reinterpret_cast<const uint4*>(krow);
  for (int c = 0; c < dh * (int)sizeof(T) / 16; ++c) {
    const uint4 w = k16[c];
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const float* qc = qrow + 8 * c;
      s += qc[0] * bf16_lo(w.x) + qc[1] * bf16_hi(w.x) + qc[2] * bf16_lo(w.y) +
           qc[3] * bf16_hi(w.y) + qc[4] * bf16_lo(w.z) + qc[5] * bf16_hi(w.z) +
           qc[6] * bf16_lo(w.w) + qc[7] * bf16_hi(w.w);
    } else {
      const float* qc = qrow + 4 * c;
      s += qc[0] * __uint_as_float(w.x) + qc[1] * __uint_as_float(w.y) +
           qc[2] * __uint_as_float(w.z) + qc[3] * __uint_as_float(w.w);
    }
  }
  return s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode(const T* __restrict__ q, const T* __restrict__ kpool, const T* __restrict__ vpool,
             const int* __restrict__ table, const int* __restrict__ kv_len, T* __restrict__ out,
             int nt, int H, int dh, int nb, int page, int wp, int layer, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  size_t off_v, off_q, off_s, off_stats;
  smem_layout<T>(nt, dh, page, &off_v, &off_q, &off_s, &off_stats);
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + off_v);
  float* sQ = reinterpret_cast<float*>(smem + off_q);
  float* sAcc = sQ + (size_t)nt * dh;
  float* sS = reinterpret_cast<float*>(smem + off_s);
  float* sM = reinterpret_cast<float*>(smem + off_stats);
  float* sL = sM + nt;
  float* sA = sL + nt;

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = THREADS / 32;
  const int ldk = k_row_elems<T>(dh);
  const size_t row_stride = (size_t)H * dh;  // pool elements between token rows
  const int* lens = kv_len + (size_t)b * nt;

  int max_len = 0;
  for (int t = 0; t < nt; ++t) max_len = max(max_len, lens[t]);
  const int n_pages = min(wp, (max_len + page - 1) / page);

  for (int i = tid; i < nt * dh; i += THREADS) {
    const int t = i / dh, d = i % dh;
    sQ[i] = to_f(q[(((size_t)b * nt + t) * H + h) * dh + d]);
    sAcc[i] = 0.f;
  }
  for (int t = tid; t < nt; t += THREADS) {
    sM[t] = NEG_INF;
    sL[t] = 0.f;
  }

  const int chunks = dh * (int)sizeof(T) / 16;  // 16-byte chunks per token row
  for (int j = 0; j < n_pages; ++j) {
    int blk = table[(size_t)b * wp + j];
    if ((unsigned)blk >= (unsigned)nb) blk = 0;  // never read outside the pool
    const size_t base = (((size_t)layer * nb + blk) * page) * row_stride + (size_t)h * dh;
    __syncthreads();  // the previous page's tiles and probabilities are consumed
    // the whole page of K and V in flight at once (cp.async: no registers
    // held per load), then one wait
    for (int i = tid; i < page * chunks; i += THREADS) {
      const int p = i / chunks, c = i % chunks;
      const size_t g = base + (size_t)p * row_stride;
      cp_async16(reinterpret_cast<uint4*>(sK + (size_t)p * ldk) + c,
                 reinterpret_cast<const uint4*>(kpool + g) + c);
      cp_async16(reinterpret_cast<uint4*>(sV + (size_t)p * dh) + c,
                 reinterpret_cast<const uint4*>(vpool + g) + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    for (int p = tid; p < page; p += THREADS) {
      const int kpos = j * page + p;
      const T* krow = sK + (size_t)p * ldk;
      for (int t = 0; t < nt; ++t) {
        const float s = dot_row<T>(sQ + t * dh, krow, dh) * scale;
        sS[t * page + p] = kpos < lens[t] ? s : NEG_INF;
      }
    }
    __syncthreads();

    for (int t = warp; t < nt; t += nwarps) {
      float mx = NEG_INF;
      for (int p = lane; p < page; p += 32) mx = fmaxf(mx, sS[t * page + p]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[t];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = lane; p < page; p += 32) {
        const bool ok = j * page + p < lens[t];
        const float e = ok ? expf(sS[t * page + p] - m_new) : 0.f;
        sum += e;
        sS[t * page + p] = to_f(from_f<T>(e));  // P in the pool's type
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[t] = alpha;
        sL[t] = sL[t] * alpha + sum;
        sM[t] = m_new;
      }
    }
    __syncthreads();

    // thread d owns accumulator column d of every query row
    for (int d = tid; d < dh; d += THREADS) {
      for (int t = 0; t < nt; ++t) {
        const float* pr = sS + t * page;
        float a = sAcc[t * dh + d] * sA[t];
        for (int p = 0; p < page; ++p) a += pr[p] * to_f(sV[(size_t)p * dh + d]);
        sAcc[t * dh + d] = a;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < nt * dh; i += THREADS) {
    const int t = i / dh;
    const float l = sL[t];
    out[(((size_t)b * nt + t) * H + h) * dh + i % dh] = from_f<T>(l > 0.f ? sAcc[i] / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table, const int* kv_len,
           void* out, int B, int nt, int H, int dh, int nb, int page, int wp, int layer,
           float scale, cudaStream_t stream) {
  size_t ov, oq, os, ost;
  const size_t smem = smem_layout<T>(nt, dh, page, &ov, &oq, &os, &ost);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode<T><<<dim3(B, H), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      kv_len, static_cast<T*>(out), nt, H, dh, nb, page, wp, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, H, Dh], pools [L, nb, page, H, Dh], out [B, T, H, Dh]: contiguous,
// dtype 0 = float32, 1 = bfloat16. table [B, Wp] and kv_len [B, T]: int32,
// contiguous. Requires 1 <= T <= 16 and Dh * itemsize % 16 == 0.
// Runs on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int vtpu_paged_decode_attention(const void* q, const void* k_pool,
                                           const void* v_pool, const int* table,
                                           const int* kv_len, void* out, int dtype, int B,
                                           int T, int H, int Dh, int nb, int page, int wp,
                                           int layer, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 1 || T > MAXT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, kv_len, out, B, T, H, Dh, nb, page, wp,
                         layer, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, kv_len, out, B, T, H, Dh, nb,
                                 page, wp, layer, scale, s);
  return (int)cudaErrorInvalidValue;
}
