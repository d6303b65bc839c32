// The key-tile walks shared by the decode/verify attention kernels
// (paged_decode_attention.cu walks pool blocks through a page table,
// decode_attention.cu walks a dense cache), hand-written for Hopper (sm_90a).
// Two walks over the same tile sources: `decode_tiles` below, one block per
// (row, head) loading each tile before computing it, which the paged kernels
// launch; and the split walk further down (`decode_split` + `split_combine`,
// the key range cut across blocks with a ring of tiles in flight), which the
// dense kernel launches and the paged kernels are to move onto.
//
// decode_tiles: one block per (row b, head h). The block walks its keys in tiles, where a
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

// ---------------------------------------------------------------------------
// The split walk (flash-decoding): the same tile source, scale placement,
// masking and rounding of P as decode_tiles above, with each (row, head)'s
// key range cut across blocks. Grid (B, H, n_split): of the n_tiles tiles
// of the key range, block z walks [z * n_tiles / n_split, (z + 1) * n_tiles
// / n_split) (balanced; the caller keeps every split two tiles or more),
// stopping at the row's longest kv_len;
// a block whose range starts past it writes an empty partial (m = -1e30,
// l = 0) and exits. Within a block:
// - tiles stream through a ring of SPLIT_STAGES slots by cp.async, so two
//   tiles are in flight while the current one is computed;
// - all 128 threads score: THREADS / tile threads per key (2 at 64-key
//   tiles), each over every so-many-th 16-byte chunk of the key's row (rows
//   padded so the 8 threads of a phase hit distinct banks), summed with
//   shuffles; int8 chunks convert to f32 once per tile, not per query;
// - P.V: thread (key group kg, column group cg) owns PV_COLS accumulator
//   columns of every query over the keys p = kg (mod kgs), converting each
//   V element once per tile; the key groups' sums meet once, at the end of
//   the split.
// With one split the block divides by l and writes the output; otherwise it
// writes (m, l, acc) in f32 to the partial buffers and a second launch
// (split_combine) weights each split by exp(m_i - max m) and divides by the
// combined l. A (row, query) with no live key gives 0, never NaN.

constexpr int SPLIT_STAGES = 3;
constexpr int PV_COLS = 8;

// threads that share one key's scores: all THREADS cover a tile that
// divides them, one thread a key otherwise
__host__ __device__ constexpr int split_parts(int tile) {
  return tile <= THREADS && THREADS % tile == 0 ? THREADS / tile : 1;
}

// K row stride in 16-byte chunks: = parts (mod 8), so the `parts` threads of
// a key, reading chunks part, part + parts, ..., and the next keys' threads
// in the same 8-thread phase read 8 distinct 16-byte bank groups
template <typename KV>
__host__ __device__ constexpr int split_k_stride(int dh, int parts) {
  return dh * (int)sizeof(KV) / 16 + ((parts % 8 - dh * (int)sizeof(KV) / 16) % 8 + 8) % 8;
}

struct SplitSmem {
  size_t v, scales, stage, q, s, stats, total;
};

// one ring slot (K tile, V tile, the tile's k/v scales), then q (f32),
// scores/probabilities and the running stats
template <typename KV>
__host__ __device__ SplitSmem split_layout(int mt, int dh, int tile) {
  SplitSmem m;
  m.v = (size_t)tile * split_k_stride<KV>(dh, split_parts(tile)) * 16;
  m.scales = m.v + align16(sizeof(KV) * (size_t)tile * dh);
  m.stage = align16(m.scales + 2 * sizeof(float) * (size_t)tile);
  m.q = SPLIT_STAGES * m.stage;
  m.s = m.q + align16(sizeof(float) * (size_t)mt * dh);
  m.stats = m.s + align16(sizeof(float) * (size_t)mt * tile);
  m.total = m.stats + 3 * sizeof(float) * (size_t)mt;
  return m;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

// one 16-byte chunk of a K row as f32
template <typename KV>
__device__ __forceinline__ void chunk_f(uint4 w, float (&f)[16 / sizeof(KV)]) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_lo(ws[i]);
      f[2 * i + 1] = bf16_hi(ws[i]);
    }
  } else if constexpr (std::is_same<KV, int8_t>::value) {
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = i8_at(ws[i / 4], i % 4);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(ws[i]);
  }
}

// PV_COLS consecutive V elements as f32
template <typename KV>
__device__ __forceinline__ void load_cols(const KV* p, float (&v)[PV_COLS]) {
  if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    chunk_f<KV>(w, v);
  } else if constexpr (std::is_same<KV, int8_t>::value) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i8_at(i < 4 ? w.x : w.y, i % 4);
  } else {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 c = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = c.x, v[5] = c.y, v[6] = c.z, v[7] = c.w;
  }
}

// cp.async of tile j's K rows (padded to kstride chunks), V rows and, for
// int8 caches, head h's k/v scales into ring slot `st`
template <typename KV, typename Src>
__device__ __forceinline__ void issue_tile(unsigned char* st, const SplitSmem& lay, const KV* kc,
                                           const KV* vc, const float* ks, const float* vs,
                                           const Src& src, int b, int h, int j, int limit,
                                           int H, int dh, int kstride) {
  const int tile = src.tile, tid = threadIdx.x;
  const int chunks = dh * (int)sizeof(KV) / 16;
  const size_t row_stride = (size_t)H * dh;
  KV* sK = reinterpret_cast<KV*>(st);
  KV* sV = reinterpret_cast<KV*>(st + lay.v);
  float* sKs = reinterpret_cast<float*>(st + lay.scales);
  const size_t r0 = src.tile_row(b, j);
  const int rows = min(tile, limit - j * tile);
  for (int i = tid; i < rows * chunks; i += THREADS) {
    const int p = i / chunks, c = i % chunks;
    const size_t g = (r0 + p) * row_stride + (size_t)h * dh;
    cp_async16(reinterpret_cast<uint4*>(sK) + (size_t)p * kstride + c,
               reinterpret_cast<const uint4*>(kc + g) + c);
    cp_async16(reinterpret_cast<uint4*>(sV + (size_t)p * dh) + c,
               reinterpret_cast<const uint4*>(vc + g) + c);
  }
  if (ks != nullptr) {
    for (int p = tid; p < rows; p += THREADS) {  // head h's scales: stride H
      cp_async4(sKs + p, ks + (r0 + p) * H + h);
      cp_async4(sKs + tile + p, vs + (r0 + p) * H + h);
    }
  }
}

// MT: the most queries per row this instantiation takes (1, or MAXT)
template <typename T, typename KV, int MT, typename Src>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ kv_len, T* __restrict__ out, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int nt, int H, int dh, float scale, Src src,
             int n_tiles) {
  constexpr int VEC = 16 / (int)sizeof(KV);  // K elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = src.tile;
  const SplitSmem lay = split_layout<KV>(MT, dh, tile);
  float* sQ = reinterpret_cast<float*>(smem + lay.q);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sM = reinterpret_cast<float*>(smem + lay.stats);
  float* sL = sM + MT;
  float* sA = sL + MT;

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = THREADS / 32;
  const bool scaled = ks != nullptr, direct = gridDim.z == 1;
  const int parts = split_parts(tile);                  // threads per key when scoring
  const int kstride = split_k_stride<KV>(dh, parts);    // in 16-byte chunks
  const int chunks = dh * (int)sizeof(KV) / 16;         // 16-byte chunks per token row
  const int* lens = kv_len + (size_t)b * nt;
  const size_t rows_total = (size_t)gridDim.x * nt * H;  // (b, t, h) rows of the output

  int max_len = 0;
  for (int t = 0; t < nt; ++t) max_len = max(max_len, lens[t]);
  const int limit = src.limit(max_len);
  const int j0 = (int)((long long)split * n_tiles / gridDim.z);
  const int j1 = min((int)((long long)(split + 1) * n_tiles / gridDim.z), (limit + tile - 1) / tile);

  if (j0 >= j1) {  // nothing of this row in the range
    for (int i = tid; i < nt * dh; i += THREADS) {
      const size_t r = ((size_t)b * nt + i / dh) * H + h;
      if (direct) out[r * dh + i % dh] = from_f<T>(0.f);
      else if (i % dh == 0) {
        part_ml[2 * ((size_t)split * rows_total + r)] = NEG_INF;
        part_ml[2 * ((size_t)split * rows_total + r) + 1] = 0.f;
      }
    }
    return;
  }

  for (int i = tid; i < nt * dh; i += THREADS)
    sQ[i] = to_f(q[(((size_t)b * nt + i / dh) * H + h) * dh + i % dh]);
  for (int t = tid; t < nt; t += THREADS) {
    sM[t] = NEG_INF;
    sL[t] = 0.f;
  }


  // P.V ownership
  const int cgroups = dh / PV_COLS, kgs = THREADS / cgroups;
  const int cg = tid % cgroups, kg = tid / cgroups;
  float acc[MT][PV_COLS];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int c = 0; c < PV_COLS; ++c) acc[t][c] = 0.f;

#pragma unroll
  for (int i = 0; i < SPLIT_STAGES - 1; ++i) {
    if (j0 + i < j1)
      issue_tile<KV>(smem + (size_t)i * lay.stage, lay, kc, vc, ks, vs, src, b, h, j0 + i, limit,
                     H, dh, kstride);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int j = j0; j < j1; ++j) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SPLIT_STAGES - 2));
    __syncthreads();  // tile j has landed; every thread is done with tile j - 1
    if (j + SPLIT_STAGES - 1 < j1)
      issue_tile<KV>(smem + (size_t)((j - j0 + SPLIT_STAGES - 1) % SPLIT_STAGES) * lay.stage, lay,
                     kc, vc, ks, vs, src, b, h, j + SPLIT_STAGES - 1, limit, H, dh, kstride);
    asm volatile("cp.async.commit_group;\n" ::);

    const unsigned char* st = smem + (size_t)((j - j0) % SPLIT_STAGES) * lay.stage;
    const KV* sK = reinterpret_cast<const KV*>(st);
    const KV* sV = reinterpret_cast<const KV*>(st + lay.v);
    const float* sKs = reinterpret_cast<const float*>(st + lay.scales);
    const float* sVs = sKs + tile;
    const int rows = min(tile, limit - j * tile);

    // scores: threads parts * p .. parts * p + parts - 1 share key p (one
    // pass over the tile when parts > 1, so every lane meets the shuffles)
    for (int p = tid / parts; p < tile; p += THREADS / parts) {
      float s[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) s[t] = 0.f;
      if (p < rows) {
        const uint4* krow = reinterpret_cast<const uint4*>(sK) + (size_t)p * kstride;
        for (int c = tid % parts; c < chunks; c += parts) {
          float kf[VEC];
          chunk_f<KV>(krow[c], kf);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            if (t < nt) {
              const float* qc = sQ + t * dh + c * VEC;
#pragma unroll
              for (int e = 0; e < VEC; ++e) s[t] += qc[e] * kf[e];
            }
          }
        }
      }
      for (int o = parts / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int t = 0; t < MT; ++t) s[t] += __shfl_xor_sync(0xffffffffu, s[t], o);
      }
      if (tid % parts == 0) {
        const int kpos = j * tile + p;
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          if (t < nt) {
            float v = s[t] * scale;
            if (scaled && p < rows) v *= sKs[p];  // before the mask, max and exp
            sS[t * tile + p] = (p < rows && kpos < lens[t]) ? v : NEG_INF;
          }
        }
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

    if (kg < kgs) {
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < nt) {
          const float a = sA[t];
#pragma unroll
          for (int c = 0; c < PV_COLS; ++c) acc[t][c] *= a;
        }
      }
      for (int p = kg; p < rows; p += kgs) {
        float v[PV_COLS];
        load_cols<KV>(sV + (size_t)p * dh + cg * PV_COLS, v);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          if (t < nt) {
            const float pt = sS[t * tile + p];
#pragma unroll
            for (int c = 0; c < PV_COLS; ++c) acc[t][c] += pt * v[c];
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // the key groups' sums meet in the (now idle) ring, one query at a time
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    if (t < nt) {
      if (kg < kgs) {
#pragma unroll
        for (int c = 0; c < PV_COLS; ++c) red[kg * dh + cg * PV_COLS + c] = acc[t][c];
      }
      __syncthreads();
      const size_t r = ((size_t)b * nt + t) * H + h;
      for (int d = tid; d < dh; d += THREADS) {
        float a = 0.f;
        for (int g = 0; g < kgs; ++g) a += red[g * dh + d];
        if (direct) {
          const float l = sL[t];
          out[r * dh + d] = from_f<T>(l > 0.f ? a / l : 0.f);
        } else {
          part_acc[((size_t)split * rows_total + r) * dh + d] = a;
        }
      }
      if (!direct && tid == 0) {
        part_ml[2 * ((size_t)split * rows_total + r)] = sM[t];
        part_ml[2 * ((size_t)split * rows_total + r) + 1] = sL[t];
      }
      __syncthreads();
    }
  }
}

// One warp per output row (b, t, h): the splits' partials weighted by
// exp(m_i - max m) over the live splits (l_i > 0), divided by the combined l.
template <typename T>
__global__ void __launch_bounds__(THREADS)
split_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
              T* __restrict__ out, int rows, int dh, int n_split) {
  const int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  float mx = NEG_INF;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = part_ml + 2 * ((size_t)s * rows + r);
    if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
  }
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = part_ml + 2 * ((size_t)s * rows + r);
    if (ml[1] > 0.f) l += ml[1] * expf(ml[0] - mx);
  }
  for (int d = lane; d < dh; d += 32) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ml = part_ml + 2 * ((size_t)s * rows + r);
      if (ml[1] > 0.f) a += part_acc[((size_t)s * rows + r) * dh + d] * expf(ml[0] - mx);
    }
    out[(size_t)r * dh + d] = from_f<T>(l > 0.f ? a / l : 0.f);
  }
}

template <typename T, typename KV, int MT, typename Src>
int launch_split_mt(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                    const int* kv_len, void* out, float* part_acc, float* part_ml, int B, int nt,
                    int H, int dh, float scale, const Src& src, int n_split, int n_tiles,
                    cudaStream_t stream) {
  const size_t smem = split_layout<KV>(MT, dh, src.tile).total;
  cudaError_t err = cudaFuncSetAttribute(decode_split<T, KV, MT, Src>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_split<T, KV, MT, Src><<<dim3(B, H, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs,
      kv_len, static_cast<T*>(out), part_acc, part_ml, nt, H, dh, scale, src, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int rows = B * nt * H, per_block = THREADS / 32;
  split_combine<T><<<(rows + per_block - 1) / per_block, THREADS, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), rows, dh, n_split);
  return (int)cudaGetLastError();
}

// The split walk and, for n_split > 1, the combine, both on `stream`. The
// partial buffers ([n_split, B, T, H, Dh] and [n_split, B, T, H, 2] f32) come
// from the caller; with one split they are not touched. Requires
// Dh % PV_COLS == 0 and Dh / PV_COLS <= THREADS. Returns cudaGetLastError().
template <typename T, typename KV, typename Src>
int launch_split(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 const int* kv_len, void* out, float* part_acc, float* part_ml, int B, int nt,
                 int H, int dh, float scale, const Src& src, int n_split, int n_tiles,
                 cudaStream_t stream) {
  if (dh % PV_COLS != 0 || dh / PV_COLS > THREADS || n_split < 1 || n_split > n_tiles)
    return (int)cudaErrorInvalidValue;
  if (nt == 1)
    return launch_split_mt<T, KV, 1>(q, k, v, ks, vs, kv_len, out, part_acc, part_ml, B, nt, H,
                                     dh, scale, src, n_split, n_tiles, stream);
  return launch_split_mt<T, KV, MAXT>(q, k, v, ks, vs, kv_len, out, part_acc, part_ml, B, nt, H,
                                      dh, scale, src, n_split, n_tiles, stream);
}

}  // namespace
