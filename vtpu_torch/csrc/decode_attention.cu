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
// bucket] first for the TPU's DMA. Here one block per (row, head) walks the
// cache in DENSE_TILE-key tiles (the tile walk of decode_tiles.cuh) up to the
// row's longest kv_len and never past `bucket`, and reads the [B, S, H]
// scales in place: no transposed copy.
//
// What bounds it on this card (H100 SXM data-sheet peaks, 700 W power
// limit): at the study's cells (batch 8/32, window 1024/2048, H 8, Dh 128,
// T = 1, lengths in [S/2, S]) a call reads the K/V of the keys the lengths
// need once, about 25-200 MB in bf16 and half that plus 4/Dh of scales in
// int8, against ~4 flops per key
// element: the bound is bytes. B x H blocks (64 or 256) cover one or two
// waves of the 132 SMs; each loads its tiles one after another with no
// overlap of loads and arithmetic, so this version runs above the byte floor.
// Double-buffered tiles and a split of the walk across blocks are the
// follow-up.

#include "decode_tiles.cuh"

namespace {

constexpr int DENSE_TILE = 64;  // keys per tile

struct DenseSrc {
  int S, bucket, tile;
  __device__ int limit(int max_len) const { return min(max_len, bucket); }
  __device__ size_t tile_row(int b, int j) const { return (size_t)b * S + (size_t)j * tile; }
};

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* kv_len, void* out, int B, int nt, int H, int dh, int S, int bucket,
           float scale, void* stream) {
  const DenseSrc src{S, bucket, DENSE_TILE};
  return launch_tiles<T, KV>(q, k, v, ks, vs, kv_len, out, B, nt, H, dh, scale, src,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

// q [B, T, H, Dh] and out: contiguous, dtype 0 = float32, 1 = bfloat16.
// k, v [B, S, H, Dh] contiguous: in q's dtype when kv_int8 is 0, else int8
// with k_scale, v_scale [B, S, H] f32 contiguous. kv_len [B, T] int32. Reads
// keys [0, min(kv_len, bucket)) with 1 <= bucket <= S. Requires
// 1 <= T <= 16 and Dh * itemsize % 16 == 0. Runs on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int vtpu_decode_attention(const void* q, const void* k, const void* v,
                                     const float* k_scale, const float* v_scale,
                                     const int* kv_len, void* out, int dtype, int kv_int8, int B,
                                     int T, int H, int Dh, int S, int bucket, float scale,
                                     void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 1 || T > MAXT || bucket < 1 || bucket > S) return (int)cudaErrorInvalidValue;
  if (kv_int8) {
    if (dtype == 0)
      return launch<float, int8_t>(q, k, v, k_scale, v_scale, kv_len, out, B, T, H, Dh, S,
                                   bucket, scale, stream);
    if (dtype == 1)
      return launch<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, kv_len, out, B, T, H, Dh,
                                           S, bucket, scale, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch<float, float>(q, k, v, nullptr, nullptr, kv_len, out, B, T, H, Dh, S, bucket,
                                scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, kv_len, out, B, T, H,
                                                Dh, S, bucket, scale, stream);
  return (int)cudaErrorInvalidValue;
}
