// The key-tile walk shared by the decode/verify attention kernels
// (paged_decode_attention.cu walks pool blocks through a page table,
// decode_attention.cu walks a dense cache), hand-written for Hopper (sm_90a).
//
// One block per (row b, head h). The block walks its keys in tiles, where a
// tile's rows are consecutive rows of a [rows, H, Dh] array (a pool block for
// the paged source, a run of cache positions for the dense one). For each
// tile it loads the [rows, Dh] K and V slices of head h into shared memory
// (the whole tile in flight at once through cp.async; K rows padded so the
// per-key dot products hit distinct banks), forms the T x rows scores in f32,
// SELECTS masked entries (k_pos >= kv_len[b, t]) to -1e30 and their p to
// exactly 0, and folds the tile into an online softmax with f32 running
// max/denominator and an f32 (T, Dh) accumulator in shared memory (thread d
// owns column d). P is rounded to q's type before P.V, as the TPU kernels
// cast p to v's dtype. The walk stops at the row's longest kv_len: keys past
// it contribute nothing, so they are never read.
//
// KV may be q's type or int8. int8 keys and values are converted to f32 in
// registers (exact, as the reference's int8 -> bf16 is) and never
// dequantized in memory. The per-token-per-head f32 scales sit beside them
// in [rows, H] arrays and apply after the products exactly as the
// reference's `_attend_head` (vtpu/ops/decode_attn.py:143) places them:
// k_scale multiplies the scaled score BEFORE the mask, max and exp; the
// denominator sums the unscaled exp(s - m); v_scale multiplies p only where
// p enters P.V, before its rounding to q's type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int MAXT = 16;  // queries per row per call (1 for decode, K+1 for verify)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// K rows carry 16 bytes of padding: threads reading 16-byte chunks of
// consecutive keys' rows then hit distinct banks in each 8-thread phase.
template <typename KV>
__host__ __device__ constexpr int k_row_elems(int dh) { return dh + 16 / (int)sizeof(KV); }

struct Smem {
  size_t v, q, s, scales, stats, total;
};

// shared memory of one block: K tile, V tile, q and the accumulator (f32),
// scores/probabilities, the tile's k/v scales, and the running stats
template <typename KV>
__host__ __device__ Smem smem_layout(int t, int dh, int tile) {
  Smem m;
  m.v = align16(sizeof(KV) * (size_t)tile * k_row_elems<KV>(dh));
  m.q = align16(m.v + sizeof(KV) * (size_t)tile * dh);
  m.s = align16(m.q + 2 * sizeof(float) * (size_t)t * dh);
  m.scales = align16(m.s + sizeof(float) * (size_t)t * tile);
  m.stats = align16(m.scales + 2 * sizeof(float) * (size_t)tile);
  m.total = m.stats + sizeof(float) * 3 * (size_t)t;
  return m;
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// signed byte i of a little-endian word, sign-extended (exact in f32)
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

__device__ __forceinline__ float dot4_i8(const float* qc, uint32_t w) {
  return qc[0] * i8_at(w, 0) + qc[1] * i8_at(w, 1) + qc[2] * i8_at(w, 2) + qc[3] * i8_at(w, 3);
}

// q . k for one key row held in shared memory, read as 16-byte chunks
template <typename KV>
__device__ __forceinline__ float dot_row(const float* qrow, const KV* krow, int dh) {
  float s = 0.f;
  const uint4* k16 = reinterpret_cast<const uint4*>(krow);
  for (int c = 0; c < dh * (int)sizeof(KV) / 16; ++c) {
    const uint4 w = k16[c];
    if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
      const float* qc = qrow + 8 * c;
      s += qc[0] * bf16_lo(w.x) + qc[1] * bf16_hi(w.x) + qc[2] * bf16_lo(w.y) +
           qc[3] * bf16_hi(w.y) + qc[4] * bf16_lo(w.z) + qc[5] * bf16_hi(w.z) +
           qc[6] * bf16_lo(w.w) + qc[7] * bf16_hi(w.w);
    } else if constexpr (std::is_same<KV, int8_t>::value) {
      const float* qc = qrow + 16 * c;
      s += dot4_i8(qc, w.x) + dot4_i8(qc + 4, w.y) + dot4_i8(qc + 8, w.z) +
           dot4_i8(qc + 12, w.w);
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

// T: q/out type (float or bf16); KV: cache type (T or int8_t); Src says where
// each tile's rows live: Src::limit(max_len) is the number of keys the block
// reads, Src::tile_row(b, j) the row index of tile j's first key (its rows
// are consecutive), Src::tile the keys per tile. ks/vs are [rows, H] f32
// scales for int8 caches and null otherwise.
template <typename T, typename KV, typename Src>
__global__ void __launch_bounds__(THREADS)
decode_tiles(const T* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ kv_len, T* __restrict__ out, int nt, int H, int dh,
             float scale, Src src) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = src.tile;
  const Smem lay = smem_layout<KV>(nt, dh, tile);
  KV* sK = reinterpret_cast<KV*>(smem);
  KV* sV = reinterpret_cast<KV*>(smem + lay.v);
  float* sQ = reinterpret_cast<float*>(smem + lay.q);
  float* sAcc = sQ + (size_t)nt * dh;
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sKs = reinterpret_cast<float*>(smem + lay.scales);
  float* sVs = sKs + tile;
  float* sM = reinterpret_cast<float*>(smem + lay.stats);
  float* sL = sM + nt;
  float* sA = sL + nt;

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = THREADS / 32;
  const bool scaled = ks != nullptr;
  const int ldk = k_row_elems<KV>(dh);
  const size_t row_stride = (size_t)H * dh;  // cache elements between token rows
  const int* lens = kv_len + (size_t)b * nt;

  int max_len = 0;
  for (int t = 0; t < nt; ++t) max_len = max(max_len, lens[t]);
  const int limit = src.limit(max_len);
  const int n_tiles = (limit + tile - 1) / tile;

  for (int i = tid; i < nt * dh; i += THREADS) {
    const int t = i / dh, d = i % dh;
    sQ[i] = to_f(q[(((size_t)b * nt + t) * H + h) * dh + d]);
    sAcc[i] = 0.f;
  }
  for (int t = tid; t < nt; t += THREADS) {
    sM[t] = NEG_INF;
    sL[t] = 0.f;
  }

  const int chunks = dh * (int)sizeof(KV) / 16;  // 16-byte chunks per token row
  for (int j = 0; j < n_tiles; ++j) {
    const size_t r0 = src.tile_row(b, j);
    const int rows = min(tile, limit - j * tile);
    __syncthreads();  // the previous tile and its probabilities are consumed
    // the whole tile of K and V in flight at once (cp.async: no registers
    // held per load), then one wait
    for (int i = tid; i < rows * chunks; i += THREADS) {
      const int p = i / chunks, c = i % chunks;
      const size_t g = (r0 + p) * row_stride + (size_t)h * dh;
      cp_async16(reinterpret_cast<uint4*>(sK + (size_t)p * ldk) + c,
                 reinterpret_cast<const uint4*>(kc + g) + c);
      cp_async16(reinterpret_cast<uint4*>(sV + (size_t)p * dh) + c,
                 reinterpret_cast<const uint4*>(vc + g) + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (scaled) {
      // head h's scales: one float per key, stride H
      for (int p = tid; p < rows; p += THREADS) {
        sKs[p] = ks[(r0 + p) * H + h];
        sVs[p] = vs[(r0 + p) * H + h];
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    for (int p = tid; p < rows; p += THREADS) {
      const int kpos = j * tile + p;
      const KV* krow = sK + (size_t)p * ldk;
      const float kscale = scaled ? sKs[p] : 1.f;
      for (int t = 0; t < nt; ++t) {
        float s = dot_row<KV>(sQ + t * dh, krow, dh) * scale;
        if (scaled) s *= kscale;  // before the mask, max and exp
        sS[t * tile + p] = kpos < lens[t] ? s : NEG_INF;
      }
    }
    __syncthreads();

    for (int t = warp; t < nt; t += nwarps) {
      float mx = NEG_INF;
      for (int p = lane; p < rows; p += 32) mx = fmaxf(mx, sS[t * tile + p]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[t];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = lane; p < rows; p += 32) {
        const bool ok = j * tile + p < lens[t];
        const float e = ok ? expf(sS[t * tile + p] - m_new) : 0.f;
        sum += e;  // the denominator sees the unscaled p
        // P in q's type; v_scale rides p only on its way into P.V
        sS[t * tile + p] = to_f(from_f<T>(scaled ? e * sVs[p] : e));
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
        const float* pr = sS + t * tile;
        float a = sAcc[t * dh + d] * sA[t];
        for (int p = 0; p < rows; ++p) a += pr[p] * to_f(sV[(size_t)p * dh + d]);
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

// One launch on `stream`: grid (B, H), dynamic shared memory sized for the
// tile. Allocates nothing; returns cudaGetLastError().
template <typename T, typename KV, typename Src>
int launch_tiles(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 const int* kv_len, void* out, int B, int nt, int H, int dh, float scale,
                 const Src& src, cudaStream_t stream) {
  const size_t smem = smem_layout<KV>(nt, dh, src.tile).total;
  cudaError_t err = cudaFuncSetAttribute(
      decode_tiles<T, KV, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_tiles<T, KV, Src><<<dim3(B, H), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs,
      kv_len, static_cast<T*>(out), nt, H, dh, scale, src);
  return (int)cudaGetLastError();
}

}  // namespace
