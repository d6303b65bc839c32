// The key-tile walk shared by the decode/verify attention kernels, hand-written
// for Hopper (sm_90a): one walk (`decode_split` + `split_combine`, launched by
// `launch_split`) over two tile sources. paged_decode_attention.cu's source
// maps a tile to sub-page rows of a pool block through the page table;
// decode_attention.cu's to a run of positions of a dense cache. A source
// gives Src::tile (keys per tile), Src::limit(max_len) (the keys a row needs
// read) and Src::tile_row(b, j) (the [rows, H, Dh] row index of tile j's
// first key; its tile rows are consecutive).
//
// The split walk (flash-decoding). Grid (B, H, n_split): of the n_tiles
// tiles of the key range, block z walks [z * n_tiles / n_split, (z + 1) *
// n_tiles / n_split) (balanced; the caller keeps every split two tiles or
// more), stopping at the row's longest kv_len, so keys past it are never
// read; a block whose range starts past it writes an empty partial (m =
// -1e30, l = 0) and exits. Within a block:
// - tiles stream through a ring of SPLIT_STAGES slots by cp.async, so two
//   tiles are in flight while the current one is computed;
// - all 128 threads score: THREADS / tile threads per key (4 at 32-key
//   tiles, at most a warp), each over every so-many-th 16-byte chunk of the
//   key's row (rows padded so the 8 threads of a phase hit distinct banks),
//   summed with shuffles; int8 chunks convert to f32 once per tile, not per
//   query. Masked scores (k_pos >= kv_len[b, t]) are SELECTED to -1e30 and
//   their p to exactly 0, so garbage past a row's length never leaks;
// - the online softmax keeps f32 running max/denominator per query, and P
//   is rounded to q's type before P.V, as the TPU kernels cast p to v's
//   dtype;
// - P.V: thread (key group kg, column group cg) owns PV_COLS accumulator
//   columns of every query over the keys p = kg (mod kgs), converting each
//   V element once per tile; the key groups' sums meet once, at the end of
//   the split.
// With one split the block divides by l and writes the output; otherwise it
// writes (m, l, acc) in f32 to the partial buffers and a second launch
// (split_combine) weights each split by exp(m_i - max m) and divides by the
// combined l. A (row, query) with no live key gives 0, never NaN. A (row,
// head)'s arithmetic depends only on its tiles and n_split, never on B or H.
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

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// signed byte i of a little-endian word, sign-extended (exact in f32)
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

constexpr int SPLIT_STAGES = 3;
constexpr int PV_COLS = 8;
// Programmatic dependent launch: the walk and the combine may be launched
// while the kernel before each is still running, and each waits
// (griddepcontrol.wait: the earlier grid complete and its writes visible)
// before it reads anything; the walk lets the combine launch once its
// blocks are past their loads. Hides a launch's latency behind the tail of
// the kernel before it.
constexpr bool SPLIT_PDL = true;

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// threads that share one key's scores: all THREADS cover a tile that
// divides them, one thread a key otherwise; never more than a warp, which
// the shuffles that sum them stay inside (tiles of 1 or 2 keys leave warps
// idle while scoring)
__host__ __device__ constexpr int split_parts(int tile) {
  return tile <= THREADS && THREADS % tile == 0 ? (THREADS / tile < 32 ? THREADS / tile : 32)
                                                : 1;
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

  wait_prior_grid();
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
  let_dependents_launch();
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

// One block per output row (b, t, h). First every split's weight at once
// (thread s reads split s's (m, l)): exp(m_i - max m) over the live splits
// (l_i > 0), 0 for the empty ones, into shared memory beside the combined l.
// Then thread d sums column d of the splits' partials with loads that
// depend on nothing before them, and divides by l. An empty split's
// partial was never written: it is read but selected away, never
// multiplied. Src only names the walk it combines, so that a profile tells
// the paged kernels' combine from the dense kernel's.
template <typename T, typename Src>
__global__ void __launch_bounds__(THREADS)
split_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
              T* __restrict__ out, int rows, int dh, int n_split) {
  extern __shared__ float sw[];  // [n_split] weights
  __shared__ float red[THREADS / 32];
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  wait_prior_grid();
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + r;  // split s at s * rows
  float mx = NEG_INF;
  for (int s = tid; s < n_split; s += THREADS) {
    const float2 v = ml[(size_t)s * rows];
    if (v.y > 0.f) mx = fmaxf(mx, v.x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();
  float l = 0.f;
  for (int s = tid; s < n_split; s += THREADS) {
    const float2 v = ml[(size_t)s * rows];
    const float w = v.y > 0.f ? expf(v.x - mx) : 0.f;
    sw[s] = w;
    l += v.y * w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) l += red[w];
  for (int d = tid; d < dh; d += THREADS) {
    const float* col = part_acc + (size_t)r * dh + d;  // split s at s * rows * dh
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float w = sw[s], x = col[(size_t)s * rows * dh];
      a += w > 0.f ? w * x : 0.f;
    }
    out[(size_t)r * dh + d] = from_f<T>(l > 0.f ? a / l : 0.f);
  }
}

// One launch of `kernel` on `stream`, allowed to begin before the kernel
// ahead of it on the stream ends when SPLIT_PDL is set.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t stream,
                       Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = SPLIT_PDL ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
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
  err = launch_pdl(decode_split<T, KV, MT, Src>, dim3(B, H, n_split), smem, stream,
                   static_cast<const T*>(q), static_cast<const KV*>(k),
                   static_cast<const KV*>(v), ks, vs, kv_len, static_cast<T*>(out), part_acc,
                   part_ml, nt, H, dh, scale, src, n_tiles);
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int rows = B * nt * H;
  const size_t weights = sizeof(float) * (size_t)n_split;
  if (weights > 48 * 1024) {
    err = cudaFuncSetAttribute(split_combine<T, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)weights);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_pdl(split_combine<T, Src>, dim3(rows), weights, stream,
                         static_cast<const float*>(part_acc),
                         static_cast<const float*>(part_ml), static_cast<T*>(out), rows, dh,
                         n_split);
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
