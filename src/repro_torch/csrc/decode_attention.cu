// Single-query GQA decode attention against a contiguous KV cache,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// ::decode_attention (_dec_kernel; its pallas_call is at :91): the dense
// engine's decode step on a global-attention layer, where every sequence
// of the batch sits at the same position ``pos``.
//
// What bounds it on the card: bytes.  A step reads the K/V slots
// 0..pos of every sequence once, with G multiply-adds per element read,
// far below the H100's ~295 FLOP/byte ridge, so the floor is
// (q + K + V bytes of slots 0..pos + out) / 3.35 TB/s.
//
// What the design does about it: it is the paged kernel's body
// (decode_attention.cuh) with an identity block table: slot t of sequence
// b is row b*T + t of the (B,T,Kv,hd) cache.  In bf16 the G query heads
// of a kv head run as the rows of tensor-core tiles against every K/V row
// staged, the slots are split over a cluster of up to 8 CTAs that stream
// them through a 3-stage ring of bulk copies, and the cluster merges its
// partials in distributed shared memory: one launch, no scratch.  Only
// slots <= pos are read.  ``pos`` arrives by value (the engine holds it on
// the host), so the split count is sized from the live slots and nothing
// is read back.

#include "decode_attention.cuh"

namespace {

struct DenseLayout {
  int T;
  int pos;
  __device__ int last(int) const { return min(pos, T - 1); }
  __device__ size_t row(int b, int slot) const {
    return static_cast<size_t>(b) * T + slot;
  }
  __device__ bool owned(int, int) const { return true; }
};

}  // namespace

// q (B,H,hd); k/v (B,T,Kv,hd); out (B,H,hd); slots 0..pos are valid.
// Split s of NS attends slot tiles [s*tps, (s+1)*tps), of 64 slots in bf16
// (NS <= 8, the cluster; scratch unused) and of 32 in fp32 (scratch holds
// B*Kv*NS*G*(hd+2) floats).  softcap <= 0 means none.  Returns the
// launches' cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out,
                                       void* scratch, int B, int T, int Kv,
                                       int G, int hd, int pos, int NS,
                                       int tps, float scale, float softcap,
                                       int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DenseLayout layout{T, pos};
  const repro::decode::Partials normalized{nullptr, nullptr, nullptr};
  if (is_bf16) {
    return repro::decode::launch<__nv_bfloat16>(q, k, v, layout, out,
                                                normalized, scratch, B, Kv, G,
                                                hd, NS, tps, scale, softcap,
                                                s);
  }
  return repro::decode::launch<float>(q, k, v, layout, out, normalized,
                                      scratch, B, Kv, G, hd, NS, tps, scale,
                                      softcap, s);
}
