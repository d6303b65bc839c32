// Paged decode/verify attention that walks the page table over the block pool
// in place, hand-written for Hopper (sm_90a), over bf16/f32 pools and over
// int8 pools with f32 scale pools.
//
// Replaces the Pallas TPU kernel `_paged_kernel` (vtpu/ops/decode_attn.py:347,
// driven by `_paged_call`, :403): as itself behind `paged_decode_attention`
// (:462) and as `kern8` (:435) behind `paged_decode_attention_int8kv` (:516).
// On the TPU the grid's second axis walks the window pages in order and the
// online-softmax state carries across grid steps in VMEM scratch. Hopper
// blocks run in no order, so that sequential axis becomes a loop inside one
// block and nothing carries across blocks: the tile walk of decode_tiles.cuh
// with one tile per window page. The block reads its own table row, and tile
// j is pool block table[b, j] of plane `layer` (an id outside the pool reads
// the null block 0, never memory outside it). Masked p is exactly 0, so the
// null block's garbage values and scales cannot leak.
//
// What bounds it on this card (H100 SXM data-sheet peaks, 700 W power
// limit): a decode tick moves up to ~21 MB of bf16 K/V per call at window
// 1280 for the flagship serving shape (~6.3 us at 3.35 TB/s), half that plus
// 4/Dh of f32 scales in int8, and does almost no arithmetic, so the bound is
// bytes. int8 pages stream as int8 (16 KB per [page, Dh] tile at page 128,
// Dh 128) and convert to f32 in registers, so the halved bytes are what
// crosses the memory bus. B x H blocks (32 at 4 slots x 8 heads) occupy a
// quarter of the 132 SMs, and each block loads its pages one after another
// with no overlap of loads and arithmetic, so this version is latency-bound
// above the byte floor. Splitting the page walk across blocks with a combine
// pass (flash-decoding) and double-buffered TMA page loads are the follow-up
// that fills the card.

#include "decode_tiles.cuh"

namespace {

struct PagedSrc {
  const int* table;  // [B, wp]
  int wp, nb, layer, tile;  // tile = the page size
  __device__ int limit(int max_len) const { return min(max_len, wp * tile); }
  __device__ size_t tile_row(int b, int j) const {
    int blk = table[(size_t)b * wp + j];
    if ((unsigned)blk >= (unsigned)nb) blk = 0;  // never read outside the pool
    return ((size_t)layer * nb + blk) * tile;
  }
};

template <typename T, typename KV>
int launch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
           const int* table, const int* kv_len, void* out, int B, int nt, int H, int dh, int nb,
           int page, int wp, int layer, float scale, void* stream) {
  const PagedSrc src{table, wp, nb, layer, page};
  return launch_tiles<T, KV>(q, kp, vp, ks, vs, kv_len, out, B, nt, H, dh, scale, src,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

// q [B, T, H, Dh], pools [L, nb, page, H, Dh], out [B, T, H, Dh]: contiguous,
// dtype 0 = float32, 1 = bfloat16 (q, pools and out alike). table [B, Wp] and
// kv_len [B, T]: int32, contiguous. Requires 1 <= T <= 16 and
// Dh * itemsize % 16 == 0. Runs on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int vtpu_paged_decode_attention(const void* q, const void* k_pool,
                                           const void* v_pool, const int* table,
                                           const int* kv_len, void* out, int dtype, int B,
                                           int T, int H, int Dh, int nb, int page, int wp,
                                           int layer, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 1 || T > MAXT) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, table, kv_len, out, B, T,
                                H, Dh, nb, page, wp, layer, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr, table,
                                                kv_len, out, B, T, H, Dh, nb, page, wp, layer,
                                                scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The same over int8 pools [L, nb, page, H, Dh] with f32 scale pools
// [L, nb, page, H]: q and out in `dtype` (0 = float32, 1 = bfloat16).
// Requires Dh % 16 == 0 besides the above.
extern "C" int vtpu_paged_decode_attention_int8kv(
    const void* q, const void* kq_pool, const float* k_scale_pool, const void* vq_pool,
    const float* v_scale_pool, const int* table, const int* kv_len, void* out, int dtype, int B,
    int T, int H, int Dh, int nb, int page, int wp, int layer, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 1 || T > MAXT) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, int8_t>(q, kq_pool, vq_pool, k_scale_pool, v_scale_pool, table, kv_len,
                                 out, B, T, H, Dh, nb, page, wp, layer, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, kq_pool, vq_pool, k_scale_pool, v_scale_pool, table,
                                         kv_len, out, B, T, H, Dh, nb, page, wp, layer, scale,
                                         stream);
  return (int)cudaErrorInvalidValue;
}
