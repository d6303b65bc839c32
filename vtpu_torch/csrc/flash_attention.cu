// Causal flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` (vtpu/ops/attention.py:210,
// called through `flash_attention`, :235). The TPU kernel keeps one
// (batch, head)'s whole K and V resident in VMEM and runs a single K pass per
// 128-row q block. That schedule does not carry over: at the serving shape
// [B, 1024, 8, 128] bf16, K and V are 512 KB per (b, h), more than the 227 KB
// of shared memory a Hopper block can use.
//
// Schedule here: one block of 4 warps per (64-row q tile, head, batch row);
// each warp owns 16 q rows. The block reads q, k and v in place through
// their [B, S, H, Dh] strides (no transposed copies in device memory),
// streams 64-key K/V tiles through shared memory and stops at the causal
// diagonal (block skipping: tile kt is visited only for kt <= qt). Both
// products run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate): Q stays in registers as A fragments for the whole block, the
// score fragments are rescaled and exponentiated in registers, and P is
// rounded to bf16 and fed straight back as the A operand of P.V, as the TPU
// kernel casts p to v's dtype. The softmax is online with f32 running max,
// denominator and accumulator. Keys past the diagonal or past S are selected
// to -1e30 and their p set to 0, so the ragged tail of any S is masked here.
//
// What bounds it on this card (H100 SXM data-sheet peaks, 700 W power
// limit): at [4, 1024, 8, 128] bf16 the work is ~8.6 GFLOP causal (~8.7 us
// at 989 TFLOP/s) against ~33.5 MB of q/k/v/o (~10 us at 3.35 TB/s), so the
// bound is bytes. This version reloads each K/V tile
// once per q tile that needs it, with no copy/compute overlap and mma.sync
// rather than wgmma; a TMA ring of K/V tiles, wgmma and warp specialisation
// are the follow-up that moves it toward the bound. Heavy tiles (late q
// tiles see the most keys) are launched first to shorten the tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // q rows per block (16 per warp)
constexpr int BK = 64;        // keys per tile (== BQ: the diagonal tile is kt == qt)
constexpr int THREADS = 128;  // 4 warps
constexpr int LDV = BK + 8;   // transposed-V row: 8 bf16 of padding spread the banks
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate. Fragment
// layout (g = lane / 4, t = lane % 4): a0 (g, 2t..), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); b0 (k 2t.., n g), b1 (k 2t+8.., n g);
// d0,d1 (g, 2t..), d2,d3 (g+8, 2t..).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          bf16* __restrict__ o, int S, Strides st, float scale) {
  constexpr int LDK = DH + 8;  // K row: 8 bf16 of padding spread the banks
  constexpr int KS = DH / 16;  // k-steps of Q.K^T
  constexpr int NT = BK / 8;   // key n-tiles of the score block
  constexpr int DT = DH / 8;   // head_dim n-tiles of P.V
  constexpr int CH = DH / 8;   // 16-byte chunks per K/V row
  __shared__ __align__(16) bf16 sK[BK * LDK];   // [key][d]
  __shared__ __align__(16) bf16 sVt[DH * LDV];  // [d][key]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two q rows

  const bf16* qbase = q + b * st.qb + h * st.qh;
  const bf16* kbase = k + b * st.kb + h * st.kh;
  const bf16* vbase = v + b * st.vb + h * st.vh;

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = r0 < S ? ld32(qbase + r0 * st.qs + c) : 0u;
    qa[kk][1] = r1 < S ? ld32(qbase + r1 * st.qs + c) : 0u;
    qa[kk][2] = r0 < S ? ld32(qbase + r0 * st.qs + c + 8) : 0u;
    qa[kk][3] = r1 < S ? ld32(qbase + r1 * st.qs + c + 8) : 0u;
  }

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int key = i / CH, c = i % CH, s = k0 + key;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (s < S) kv = *reinterpret_cast<const uint4*>(kbase + s * st.ks + 8 * c);
      *reinterpret_cast<uint4*>(sK + key * LDK + 8 * c) = kv;
    }
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int key = i % BK, c = i / BK, s = k0 + key;  // consecutive keys per warp
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (s < S) vv = *reinterpret_cast<const uint4*>(vbase + s * st.vs + 8 * c);
      const uint32_t ws[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sVt[(8 * c + j) * LDV + key] =
            __ushort_as_bfloat16(static_cast<unsigned short>(ws[j >> 1] >> (16 * (j & 1))));
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* kr = sK + (8 * j + g) * LDK + 16 * kk + 2 * t;
        mma(sc[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        sc[j][e] = (key <= r0 && key < S) ? sc[j][e] * scale : NEG_INF;
        sc[j][2 + e] = (key <= r1 && key < S) ? sc[j][2 + e] * scale : NEG_INF;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    }
    // the 4 threads of a quad hold one row's 64 scores between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        const float p0 = (key <= r0 && key < S) ? expf(sc[j][e] - mn0) : 0.f;
        const float p1 = (key <= r1 && key < S) ? expf(sc[j][2 + e] - mn1) : 0.f;
        sc[j][e] = p0;
        sc[j][2 + e] = p1;
        ps0 += p0;
        ps1 += p1;
      }
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;

#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      acc[dn][0] *= al0;
      acc[dn][1] *= al0;
      acc[dn][2] *= al1;
      acc[dn][3] *= al1;
    }
    // the score fragments of key n-tiles 2s, 2s+1 are exactly the A
    // fragment of k-step s of P.V (rounded to bf16 here)
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      const uint32_t pa[4] = {pack(sc[2 * s][0], sc[2 * s][1]), pack(sc[2 * s][2], sc[2 * s][3]),
                              pack(sc[2 * s + 1][0], sc[2 * s + 1][1]),
                              pack(sc[2 * s + 1][2], sc[2 * s + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const bf16* vr = sVt + (8 * dn + g) * LDV + 16 * s + 2 * t;
        mma(acc[dn], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  bf16* obase = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int d = 8 * dn + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(obase + r0 * st.os + d) = pack(acc[dn][0] / l0, acc[dn][1] / l0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(obase + r1 * st.os + d) = pack(acc[dn][2] / l1, acc[dn][3] / l1);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           const Strides& st, float scale, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, st, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: bfloat16 [B, S, H, Dh] given by element strides, in order
// q (b, s, h), k (b, s, h), v (b, s, h), o (b, s, h); the head_dim stride is
// 1, every other stride a multiple of 8 and every base 16-byte aligned.
// Dh in {32, 64, 128}. Runs on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int vtpu_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int H, int Dh, const long long* strides,
                                    float scale, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return launch<32>(q, k, v, o, B, S, H, st, scale, s);
    case 64: return launch<64>(q, k, v, o, B, S, H, st, scale, s);
    case 128: return launch<128>(q, k, v, o, B, S, H, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
