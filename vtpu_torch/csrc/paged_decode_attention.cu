// Paged decode/verify attention that walks the page table over the block pool
// in place, hand-written for Hopper (sm_90a), over bf16/f32 pools and over
// int8 pools with f32 scale pools.
//
// Replaces the Pallas TPU kernel `_paged_kernel` (vtpu/ops/decode_attn.py:347,
// driven by `_paged_call`, :403): as itself behind `paged_decode_attention`
// (:462) and as `kern8` (:435) behind `paged_decode_attention_int8kv` (:516),
// and, called on one rank's head shard, the same kernel under `shard_map`
// (`_shard_body`, :559). On the TPU the grid's second axis walks the window
// pages in order and the online-softmax state carries across grid steps in
// VMEM scratch. Hopper blocks run in no order and carry nothing between
// them, so here each (row, head)'s window is cut across blocks: the split
// walk of decode_tiles.cuh over a paged tile source, then a combine launch.
//
// What bounds it on this card (H100 SXM data-sheet peaks, 700 W power
// limit): bytes. At the flagship serving tick (4 slots, 8 heads, Dh 128,
// window 10 pages of 128, lengths 613-1040) a call must read ~13.8 MB of
// bf16 K/V (4.1 us at 3.35 TB/s), about half that plus 4/Dh of f32 scales
// in int8, against ~4 flops per element. int8 streams as int8 and converts
// to f32 in registers. The first version ran one block per (row, head), 32
// blocks on 132 SMs, each loading a whole page and then computing it with
// nothing in flight: latency, not bytes, set its time. Here:
// - a tile is PAGED_TILE keys, or gcd(page, PAGED_TILE) where the page is
//   not a multiple of it, so a tile never leaves its page (the next pool
//   row belongs to another block). Tile j of a row is rows (j % (page /
//   tile)) * tile.. of pool block table[b, j / (page / tile)] in plane
//   `layer`; an id outside the pool reads the null block 0, never memory
//   outside it. Masked p is exactly 0, so the null block's garbage values
//   and scales cannot leak;
// - small tiles keep the ring small (three 32-key bf16 slots are ~55 KB,
//   four blocks per SM) and the split plan (ops/decode_attn.py,
//   `paged_split_plan`, from B, H, the window and the page only, never from
//   the lengths on the device) puts ~4 blocks on every SM, each walking a
//   few tiles with two in flight.
// hack/torch_decode_split_sweep.py times tile x ring depth x split plan at
// the serving shapes; PERF.md has its numbers.

#include "decode_tiles.cuh"

namespace {

constexpr int PAGED_TILE = 32;  // keys per tile, where the page allows

struct PagedSrc {
  const int* table;  // [B, wp]
  int wp, nb, layer, page, tile;  // tile divides page
  __device__ int limit(int max_len) const { return min(max_len, wp * page); }
  __device__ size_t tile_row(int b, int j) const {
    const int per_page = page / tile;
    int blk = table[(size_t)b * wp + j / per_page];
    if ((unsigned)blk >= (unsigned)nb) blk = 0;  // never read outside the pool
    return ((size_t)layer * nb + blk) * page + (size_t)(j % per_page) * tile;
  }
};

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <typename T, typename KV>
int launch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
           const int* table, const int* kv_len, void* out, float* part_acc, float* part_ml,
           int B, int nt, int H, int dh, int nb, int page, int wp, int layer, int n_split,
           float scale, void* stream) {
  const PagedSrc src{table, wp, nb, layer, page, gcd(page, PAGED_TILE)};
  return launch_split<T, KV>(q, kp, vp, ks, vs, kv_len, out, part_acc, part_ml, B, nt, H, dh,
                             scale, src, n_split, wp * (page / src.tile),
                             static_cast<cudaStream_t>(stream));
}

int check(int T, int page, int wp, int n_split, const float* part_acc, const float* part_ml) {
  if (T < 1 || T > MAXT || page < 1 || wp < 1) return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// q [B, T, H, Dh], pools [L, nb, page, H, Dh], out [B, T, H, Dh]: contiguous,
// dtype 0 = float32, 1 = bfloat16 (q, pools and out alike). table [B, Wp] and
// kv_len [B, T]: int32, contiguous. Split plan: n_split blocks per (row,
// head), split i walking tiles [i * n / n_split, (i + 1) * n / n_split) of
// the window's n = Wp * page / gcd(page, PAGED_TILE) tiles; for n_split > 1,
// part_acc [n_split, B, T, H, Dh] and part_ml [n_split, B, T, H, 2] f32 are
// scratch. Requires 1 <= T <= 16, 1 <= n_split <= n, Dh % 8 == 0 and
// Dh * itemsize % 16 == 0. Runs on `stream`, allocates nothing, returns
// cudaGetLastError() of the first launch that failed.
extern "C" int vtpu_paged_decode_attention(const void* q, const void* k_pool,
                                           const void* v_pool, const int* table,
                                           const int* kv_len, void* out, float* part_acc,
                                           float* part_ml, int dtype, int B, int T, int H,
                                           int Dh, int nb, int page, int wp, int layer,
                                           int n_split, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (int err = check(T, page, wp, n_split, part_acc, part_ml)) return err;
  if (dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, table, kv_len, out,
                                part_acc, part_ml, B, T, H, Dh, nb, page, wp, layer, n_split,
                                scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr, table,
                                                kv_len, out, part_acc, part_ml, B, T, H, Dh, nb,
                                                page, wp, layer, n_split, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The same over int8 pools [L, nb, page, H, Dh] with f32 scale pools
// [L, nb, page, H]: q and out in `dtype` (0 = float32, 1 = bfloat16).
// Requires Dh % 16 == 0 besides the above.
extern "C" int vtpu_paged_decode_attention_int8kv(
    const void* q, const void* kq_pool, const float* k_scale_pool, const void* vq_pool,
    const float* v_scale_pool, const int* table, const int* kv_len, void* out, float* part_acc,
    float* part_ml, int dtype, int B, int T, int H, int Dh, int nb, int page, int wp, int layer,
    int n_split, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (int err = check(T, page, wp, n_split, part_acc, part_ml)) return err;
  if (dtype == 0)
    return launch<float, int8_t>(q, kq_pool, vq_pool, k_scale_pool, v_scale_pool, table, kv_len,
                                 out, part_acc, part_ml, B, T, H, Dh, nb, page, wp, layer,
                                 n_split, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, kq_pool, vq_pool, k_scale_pool, v_scale_pool, table,
                                         kv_len, out, part_acc, part_ml, B, T, H, Dh, nb, page,
                                         wp, layer, n_split, scale, stream);
  return (int)cudaErrorInvalidValue;
}
