// Causal flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` (vtpu/ops/attention.py:210,
// called through `flash_attention`, :235). The TPU kernel keeps one
// (batch, head)'s whole K and V resident in VMEM and runs a single K pass per
// 128-row q block. That schedule does not carry over: at the serving shape
// [B, 1024, 8, 128] bf16, K and V are 512 KB per (b, h), more than the 227 KB
// of shared memory a Hopper block can use.
//
// What bounds it on this card (H100 SXM data-sheet peaks, 700 W power
// limit): at [4, 1024, 8, 128] bf16 the work is ~8.6 GFLOP causal (~8.7 us
// at 989 TFLOP/s) against ~33.5 MB of q/k/v/o (~10 us at 3.35 TB/s), so the
// bound is bytes, with the tensor-core time just under it: the kernel has to
// keep both the copy engine and the tensor cores busy at once. The first
// version (mma.sync m16n8k16, 64-row tiles, K/V loaded by all threads
// between two barriers, V transposed with scalar stores) ran 0.179 ms there.
//
// Design. One block per (q tile, head, batch row), the heaviest causal tiles
// first. A block is warp-specialised: NC consumer warpgroups of 64 q rows
// each (NC = 2 for 128-row tiles; NC = 1, 64-row tiles, when 128-row tiles
// would give fewer blocks than the card has SMs, as a one-row admission
// does) and one producer warpgroup, whose single thread issues every load
// through the Tensor Memory Accelerator (TMA): Q once, then 128-key K and V
// tiles into a ring of STAGES slots in dynamic shared memory, each slot
// guarded by full (K, V) and empty mbarriers, so the next tile is in flight
// while the current one is computed. `setmaxnreg` moves the producer's
// registers to the consumers. q/k/v/o are [B, S, H, Dh] tensors given by
// element strides, described to TMA as 4-D tensor maps (Dh, H, S, B) with
// 64-row boxes, 128-byte swizzle (64-byte for Dh = 32); rows past S arrive
// as zeros. Both products run on `wgmma` with f32 accumulators: S = Q.K^T
// with Q and K read from shared memory (K-major descriptors whose swizzle
// matches the tensor maps'), and O += P.V with P taken from the score
// registers as the A operand, rounded to bf16 as the TPU kernel casts p to
// v's dtype, and V read in its natural [key, Dh] layout through the
// descriptor's transpose (MN-major). Each consumer warpgroup runs its tiles
// in order (S, softmax, P.V); the two warpgroups of a block overlap each
// other's softmax with their products. (Issuing S(kt) beside P(kt-1).V(kt-1)
// to hide the softmax inside one warpgroup made ptxas serialize the wgmmas
// and spill, and ran slower on the H100.) The softmax is online, in
// registers, with f32 running max and sum; the scale log2(e)/sqrt(Dh) folds
// into one FFMA per score ahead of `ex2.approx`, which ran faster than
// exp2f of pre-scaled scores. Only the diagonal tile and the ragged last
// tile are masked (keys past the diagonal or past S are selected to -1e30
// and their p set to 0: TMA's zero rows are not a mask), and tiles past the
// diagonal are never loaded. The output is staged in the block's own Q rows in the
// tensor map's swizzled layout and written by a TMA store, which drops rows
// past S.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is reached through dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BK = 128;        // keys per K/V tile
constexpr int WG_ROWS = 64;    // q rows per consumer warpgroup (the wgmma M)
constexpr int BOX_ROWS = 64;   // rows per TMA box
constexpr int STAGES = 2;      // K/V tiles in the ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory tile layout for head dim DH: a tile of R rows is CB column
// blocks of [R rows x SWB bytes], each in the swizzled layout TMA writes.
template <int DH>
struct Layout {
  static constexpr int SWB = DH * 2 >= 128 ? 128 : DH * 2;  // swizzle span = TMA box row bytes
  static constexpr int CB = DH * 2 / SWB;                     // column blocks per row
  static constexpr uint64_t SWIZZLE = SWB == 128 ? 1 : 2;     // descriptor code: 128 B or 64 B
  static constexpr int SWMASK = SWB / 16 - 1;                 // 16-byte chunk bits the swizzle XORs
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed; a phase that never
// completes (a lost arrival or byte count) traps, failing the launch, rather
// than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map (Dh, H, S, B) into shared memory, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int col, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(h), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int h,
                                          int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(h), "r"(row), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads of wgmma registers above the wait (and
// from reusing an A operand's registers before it)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode
template <int DH>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (Layout<DH>::SWIZZLE << 62);
}

// K-major operand (Q as A, K as B): rows r0.. of a tile of `rows` rows, the
// 16-column k-step ks
template <int DH>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int r0, int ks) {
  using L = Layout<DH>;
  const int byte = ks * 32;
  const uint32_t addr = tile + (byte / L::SWB) * rows * L::SWB + r0 * L::SWB + byte % L::SWB;
  return make_desc<DH>(addr, 16, 8 * L::SWB);
}

// V as the transposed (MN-major) B operand of P.V: keys 16 ks .. 16 ks + 15,
// every head-dim column (column blocks LBO apart)
template <int DH>
__device__ __forceinline__ uint64_t vt_desc(uint32_t tile, int ks) {
  using L = Layout<DH>;
  return make_desc<DH>(tile + ks * 16 * L::SWB, BK * L::SWB, 8 * L::SWB);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] = A[64 x 16] . B[16 x 128]: the first k-step, D's old values dead
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers, B from shared memory
// (MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B from shared memory
// (MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers, B from shared memory
// (MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (DH == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

// S = Q.K^T for one warpgroup: its 64 Q rows (starting at q_rows, in a tile
// of `q_tile_rows` rows) against the 128 keys of the K tile at k_tile
template <int DH>
__device__ __forceinline__ void qk_issue(float (&sc)[BK / 2], uint32_t q_rows, uint32_t k_tile,
                                         int q_tile_rows) {
  wgmma_ss_n128_first(sc, kmajor_desc<DH>(q_rows, q_tile_rows, 0, 0), kmajor_desc<DH>(k_tile, BK, 0, 0));
#pragma unroll
  for (int ks = 1; ks < DH / 16; ++ks)
    wgmma_ss_n128(sc, kmajor_desc<DH>(q_rows, q_tile_rows, 0, ks), kmajor_desc<DH>(k_tile, BK, 0, ks));
}

// O += P.V over the 128 keys of the V tile at v_tile
template <int DH>
__device__ __forceinline__ void pv_issue(float (&o)[DH / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) wgmma_pv<DH>(o, pa[ks], vt_desc<DH>(v_tile, ks));
}

// 2^x in one MUFU op (flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile of the online softmax, in place: the raw scores s of keys k0 ..
// k0 + 127 become p = 2^(s * sl2 - m_new) (0 where masked), with the running
// max m kept in the log2 domain; this thread's partial sums advance, and
// al0/al1 receive the factors the accumulator rows must be rescaled by.
// Accumulator element 4j + e is (row g, key k0 + 8j + 2t + e), 4j + 2 + e
// (row g + 8, the same key).
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], int k0, int rw0, int row0,
                                             int row1, int t, int S, float sl2, float& m0,
                                             float& m1, float& l0, float& l1, float& al0,
                                             float& al1) {
  const bool edge = k0 + BK - 1 > rw0 || k0 + BK > S;  // diagonal or ragged tile
  float mx0 = NEG_INF, mx1 = NEG_INF;
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        if (!(key <= row0 && key < S)) sc[4 * j + e] = NEG_INF;
        if (!(key <= row1 && key < S)) sc[4 * j + 2 + e] = NEG_INF;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx0 = fmaxf(mx0, sc[4 * j + e]);
      mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
    }
  }
  // the 4 threads of a quad hold one row's 128 scores between them
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
  al0 = ex2(m0 - mn0);
  al1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p0 = ex2(fmaf(sc[4 * j + e], sl2, -mn0));
      float p1 = ex2(fmaf(sc[4 * j + 2 + e], sl2, -mn1));
      if (edge) {
        p0 = sc[4 * j + e] == NEG_INF ? 0.f : p0;
        p1 = sc[4 * j + 2 + e] == NEG_INF ? 0.f : p1;
      }
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
      ps0 += p0;
      ps1 += p1;
    }
  }
  l0 = l0 * al0 + ps0;
  l1 = l1 * al1 + ps1;
}

template <int DH, int NC>
constexpr int smem_bytes() {
  // 1 KB of slack aligns the tiles to the 1024-byte swizzle atom
  return 1024 + NC * WG_ROWS * DH * 2 + 2 * STAGES * BK * DH * 2 + 8 * (1 + 3 * STAGES);
}

template <int DH, int NC>
__global__ void __launch_bounds__(384, 1)
flash_fwd(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to, int S,
          float sl2) {
  using L = Layout<DH>;
  constexpr int BQ = NC * WG_ROWS;
  constexpr int Q_BYTES = BQ * DH * 2, KV_BYTES = BK * DH * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base, sk = base + Q_BYTES, sv = sk + STAGES * KV_BYTES;
  const uint32_t full_q = sv + STAGES * KV_BYTES;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * STAGES, empty = full_v + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int n_kt = min((S + BK - 1) / BK, (q0 + BQ - 1) / BK + 1);  // never past the diagonal
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == NC * 128) {
      mbar_expect_tx(full_q, Q_BYTES);
      for (int r = 0; r < BQ; r += BOX_ROWS)
        for (int cb = 0; cb < L::CB; ++cb)
          tma_load(&tq, sq + cb * BQ * L::SWB + r * L::SWB, full_q, cb * L::SWB / 2, h, q0 + r, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);  // the first round passes
        const uint32_t kb = sk + s * KV_BYTES, vb = sv + s * KV_BYTES;
        mbar_expect_tx(full_k + 8 * s, KV_BYTES);
        for (int r = 0; r < BK; r += BOX_ROWS)
          for (int cb = 0; cb < L::CB; ++cb)
            tma_load(&tk, kb + cb * BK * L::SWB + r * L::SWB, full_k + 8 * s, cb * L::SWB / 2, h,
                     kt * BK + r, b);
        mbar_expect_tx(full_v + 8 * s, KV_BYTES);
        for (int r = 0; r < BK; r += BOX_ROWS)
          for (int cb = 0; cb < L::CB; ++cb)
            tma_load(&tv, vb + cb * BK * L::SWB + r * L::SWB, full_v + 8 * s, cb * L::SWB / 2, h,
                     kt * BK + r, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows rw0 .. rw0 + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int rw0 = q0 + wg * WG_ROWS;
    const int row0 = rw0 + warp * 16 + g, row1 = row0 + 8;  // this thread's two rows
    float o[DH / 2], sc[BK / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums

    mbar_wait(full_q, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t parity = (kt / STAGES) & 1;
      mbar_wait(full_k + 8 * s, parity);
      wgmma_fence();
      qk_issue<DH>(sc, sq + wg * WG_ROWS * Layout<DH>::SWB, sk + s * KV_BYTES, BQ);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      float al0, al1;
      softmax_tile(sc, kt * BK, rw0, row0, row1, t, S, sl2, m0, m1, l0, l1, al0, al1);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      // the p of keys 16 ks .. 16 ks + 15 are exactly the A fragment of
      // k-step ks of P.V (rounded to bf16 here)
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        pa[ks][0] = pack(sc[8 * ks], sc[8 * ks + 1]);
        pa[ks][1] = pack(sc[8 * ks + 2], sc[8 * ks + 3]);
        pa[ks][2] = pack(sc[8 * ks + 4], sc[8 * ks + 5]);
        pa[ks][3] = pack(sc[8 * ks + 6], sc[8 * ks + 7]);
      }
      mbar_wait(full_v + 8 * s, parity);
      wgmma_fence();
      pv_issue<DH>(o, pa, sv + s * KV_BYTES);
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(empty + 8 * s);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    // stage O in this warpgroup's own Q rows (their last reader, the final
    // Q.K^T, has completed), in the tensor map's swizzled layout
    const int rr = wg * WG_ROWS + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int byte = (8 * j + 2 * t) * 2;
      const int off = (byte / L::SWB) * BQ * L::SWB + byte % L::SWB;
      const int o0 = off + rr * L::SWB, o1 = off + (rr + 8) * L::SWB;
      *reinterpret_cast<uint32_t*>(gbase + (o0 ^ (((o0 >> 7) & L::SWMASK) << 4))) =
          pack(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(gbase + (o1 ^ (((o1 >> 7) & L::SWMASK) << 4))) =
          pack(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid % 128 == 0) {
      for (int cb = 0; cb < L::CB; ++cb)  // TMA drops the rows past S
        tma_store(&to, sq + cb * BQ * L::SWB + wg * WG_ROWS * L::SWB, cb * L::SWB / 2, h, rw0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime has loaded (no
// link-time dependency on libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// [B, S, H, DH] bf16 at `ptr` with element strides (sb, ss, sh) as a tensor
// map (Dh, H, S, B) of 64-row boxes one swizzle span wide. 0 on success.
template <int DH>
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, long long sb, long long ss,
           long long sh) {
  using L = Layout<DH>;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(L::SWB / 2), 1, (cuuint32_t)BOX_ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        L::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH, int NC>
int launch(const CUtensorMap (&maps)[4], int B, int S, int H, float sl2, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH, NC>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<DH, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  constexpr int BQ = NC * WG_ROWS;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<DH, NC><<<grid, (NC + 1) * 128, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], S,
                                                             sl2);
  return (int)cudaGetLastError();
}

// 128-row q tiles unless they would leave SMs idle (a one-row admission at
// S = 1024 gives 64 blocks on 132 SMs): then 64-row tiles, twice the blocks
template <int DH>
int run(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
        const long long* st, float sl2, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const int err = encode<DH>(&maps[i], ptrs[i], B, S, H, st[3 * i], st[3 * i + 1], st[3 * i + 2]);
    if (err != 0) return err;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) sms = 132;
  }
  const long long tiles128 = (long long)B * H * ((S + 2 * WG_ROWS - 1) / (2 * WG_ROWS));
  if (tiles128 >= sms) return launch<DH, 2>(maps, B, S, H, sl2, stream);
  return launch<DH, 1>(maps, B, S, H, sl2, stream);
}

}  // namespace

// q, k, v, o: bfloat16 [B, S, H, Dh] given by element strides, in order
// q (b, s, h), k (b, s, h), v (b, s, h), o (b, s, h); the head_dim stride is
// 1, every other stride a multiple of 8 and every base 16-byte aligned.
// Dh in {32, 64, 128}. Runs on `stream`, allocates nothing, returns
// cudaGetLastError() (or the error of encoding a tensor map).
extern "C" int vtpu_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int H, int Dh, const long long* strides,
                                    float scale, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return 0;
  const float sl2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return run<32>(q, k, v, o, B, S, H, strides, sl2, s);
    case 64: return run<64>(q, k, v, o, B, S, H, strides, sl2, s);
    case 128: return run<128>(q, k, v, o, B, S, H, strides, sl2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
