// Paged single-query GQA decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// ::paged_decode_attention (_paged_dec_kernel; its pallas_call is at :278).
//
// What bounds it on the card: bytes.  A decode step reads every live K/V
// slot of every sequence once and does about one multiply-add per element
// read (G of them per kv head), far below the H100's ~295 FLOP/byte ridge,
// so the floor is (K + V bytes of slots 0..pos[b], all b) / 3.35 TB/s.
//
// What the design does about it (the body is decode_attention.cuh's, with
// the paged layout below):
//  * the G = H/Kv query heads of a kv head share every K/V row staged, so
//    each page is read once per kv head, never once per query head (no
//    H-expansion copy); in bf16 they are the M rows of mma.sync tiles;
//  * enough loads in flight: a decode batch has only B x Kv (sequence, kv
//    head) pairs, too few to fill 132 SMs, so each pair's slots are split
//    into NS ranges, one CTA each (flash-decoding), and each CTA streams
//    its tiles through a ring in shared memory (bf16: 3 stages of bulk
//    copies, one per slot row; fp32: two of cp.async 16-byte copies),
//    gathering them across pages through its own block-table row;
//  * nothing past pos[b] is read: splits past it load nothing and weigh
//    exactly 0; the null page 0 is touched only by an inactive engine slot
//    (pos 0, all-null row), which reads its slot 0;
//  * each CTA keeps the online fp32 softmax state (m, l, acc) of the TPU
//    kernel; in bf16 the NS CTAs of a pair form a cluster that merges
//    them through distributed shared memory, rescaling by exp(m - max m)
//    and normalizing by max(l, 1e-37), in the same launch; in fp32 a
//    second kernel merges them from scratch (the TPU kernel's
//    ``partials``).

#include "decode_attention.cuh"

namespace {

// slot -> its page's row in the pool, through sequence b's block-table row
struct PagedLayout {
  const int* block_tables;
  const int* pos;
  int nmax;
  int ps;
  __device__ int last(int b) const { return min(pos[b], nmax * ps - 1); }
  __device__ size_t row(int b, int slot) const {
    const size_t page = static_cast<size_t>(
        block_tables[static_cast<size_t>(b) * nmax + slot / ps]);
    return page * ps + slot % ps;
  }
};

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* pos, void* out,
           void* scratch, int B, int Kv, int G, int hd, int ps, int nmax,
           int NS, int tps, float scale, float softcap, cudaStream_t stream) {
  const PagedLayout layout{static_cast<const int*>(block_tables),
                           static_cast<const int*>(pos), nmax, ps};
  return repro::decode::launch<T>(q, k_pages, v_pages, layout, out, scratch,
                                  B, Kv, G, hd, NS, tps, scale, softcap,
                                  stream);
}

}  // namespace

// q (B,H,hd); k_pages/v_pages (P,ps,Kv,hd); block_tables (B,nmax) int32;
// pos (B,) int32; out (B,H,hd).  Split s of NS attends slot tiles
// [s*tps, (s+1)*tps), of 64 slots in bf16 (NS <= 8, the cluster; scratch
// unused) and of 32 in fp32 (scratch holds B*Kv*NS*G*(hd+2) floats).
// softcap <= 0 means none.  Returns the launches' cudaError_t.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* pos, void* out, void* scratch,
    int B, int Kv, int G, int hd, int ps, int nmax, int NS, int tps,
    float scale, float softcap, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, pos, out,
                                 scratch, B, Kv, G, hd, ps, nmax, NS, tps,
                                 scale, softcap, s);
  }
  return launch<float>(q, k_pages, v_pages, block_tables, pos, out, scratch,
                       B, Kv, G, hd, ps, nmax, NS, tps, scale, softcap, s);
}
