// Decode/verify attention over a dense [B, S, H, Dh] cache, bounded to a read
// bucket, hand-written for Hopper (sm_90a), over bf16/f32 caches and over
// int8 caches with [B, S, H] f32 scales.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (vtpu/ops/decode_attn.py:196)
// in both of its calls behind `decode_attention` (:244): the bf16
// `pallas_call` (:304) and the int8 one (`kern8`, :315, :331). On the TPU the
// grid is (row, S-block) with every head unrolled inside one step, K/V
// streaming as (S_blk, H*Dh) tiles and the softmax state carried across the
// sequential S-block axis in VMEM; the scales were transposed to [B, H,
// bucket] first for the TPU's DMA. Hopper blocks run in no order and carry
// nothing between them, so here the key range of each (row, head) is split
// across blocks (flash-decoding, the split walk of decode_tiles.cuh): grid
// (B, H, n_split), each block walking its 32-key tiles through a three-slot
// cp.async ring up to the row's longest kv_len and never past
// `bucket`, reading the [B, S, H] scales in place (no transposed copy); a
// second launch combines the splits' f32 partials. The caller picks n_split
// from B, H and bucket alone (never from kv_len, which lives on the device).
//
// What bounds it on this card (H100 SXM data-sheet peaks, 700 W power
// limit): at the study's cells (batch 8/32, window 1024/2048, H 8, Dh 128,
// T = 1, lengths in [S/2, S]) a call reads the K/V of the keys the lengths
// need once, about 25-200 MB in bf16 and half that plus 4/Dh of scales in
// int8, against ~4 flops per key element: the bound is bytes. The first
// version ran one block per (row, head), 64 or 256 blocks under one wave of
// the 132 SMs, each loading a tile and then computing it with nothing in
// flight; the split fills the card with blocks and the ring keeps two tiles
// in flight per block while the current one is computed. The walk is bound
// by latency more than by bytes (three barriers a tile, 4 warps a block), so
// small tiles win: 32-key tiles let four blocks share an SM where 64-key
// tiles let two, and the split plan keeps every walk at most 14 tiles long
// (hack/torch_decode_split_sweep.py times tile x ring depth x split plan
// at the study cells; PERF.md has its numbers).

#include "decode_tiles.cuh"

namespace {

constexpr int DENSE_TILE = 32;  // keys per tile: a 3-slot ring of ~53 KB, four blocks per SM

struct DenseSrc {
  int S, bucket, tile;
  __device__ int limit(int max_len) const { return min(max_len, bucket); }
  __device__ size_t tile_row(int b, int j) const { return (size_t)b * S + (size_t)j * tile; }
};

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* kv_len, void* out, float* part_acc, float* part_ml, int B, int nt, int H,
           int dh, int S, int bucket, int n_split, float scale, void* stream) {
  const DenseSrc src{S, bucket, DENSE_TILE};
  return launch_split<T, KV>(q, k, v, ks, vs, kv_len, out, part_acc, part_ml, B, nt, H, dh, scale,
                             src, n_split, (bucket + DENSE_TILE - 1) / DENSE_TILE,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

// q [B, T, H, Dh] and out: contiguous, dtype 0 = float32, 1 = bfloat16.
// k, v [B, S, H, Dh] contiguous: in q's dtype when kv_int8 is 0, else int8
// with k_scale, v_scale [B, S, H] f32 contiguous. kv_len [B, T] int32. Reads
// keys [0, min(kv_len, bucket)) with 1 <= bucket <= S. Split plan: n_split
// blocks per (row, head), split i walking tiles [i * n / n_split, (i + 1) *
// n / n_split) of the bucket's n = ceil(bucket / 32); for n_split > 1, part_acc [n_split, B, T, H, Dh] and part_ml [n_split, B,
// T, H, 2] f32 are scratch. Requires 1 <= T <= 16, Dh % 8 == 0 and
// Dh * itemsize % 16 == 0. Runs on `stream`, allocates nothing, returns
// cudaGetLastError() of the first launch that failed.
extern "C" int vtpu_decode_attention(const void* q, const void* k, const void* v,
                                     const float* k_scale, const float* v_scale,
                                     const int* kv_len, void* out, float* part_acc,
                                     float* part_ml, int dtype, int kv_int8, int B, int T, int H,
                                     int Dh, int S, int bucket, int n_split, float scale,
                                     void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 1 || T > MAXT || bucket < 1 || bucket > S) return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)) return (int)cudaErrorInvalidValue;
  if (kv_int8) {
    if (dtype == 0)
      return launch<float, int8_t>(q, k, v, k_scale, v_scale, kv_len, out, part_acc, part_ml, B,
                                   T, H, Dh, S, bucket, n_split, scale, stream);
    if (dtype == 1)
      return launch<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, kv_len, out, part_acc,
                                           part_ml, B, T, H, Dh, S, bucket, n_split, scale,
                                           stream);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch<float, float>(q, k, v, nullptr, nullptr, kv_len, out, part_acc, part_ml, B, T,
                                H, Dh, S, bucket, n_split, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, kv_len, out, part_acc,
                                                part_ml, B, T, H, Dh, S, bucket, n_split,
                                                scale, stream);
  return (int)cudaErrorInvalidValue;
}
