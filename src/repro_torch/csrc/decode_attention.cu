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
// What the design does about it: it is the paged kernel's design
// (decode_attention.cuh, see paged_decode_attention.cu) with an identity
// block table: slot t of sequence b is row b*T + t of the (B,T,Kv,hd)
// cache.  The G query heads of a kv head share every K/V row staged; each
// (sequence, kv head) pair's slots are split over NS CTAs, each
// double-buffering its tiles with cp.async; only slots <= pos are read; a
// second kernel merges the NS online-softmax partials.  ``pos`` arrives
// by value (the engine holds it on the host), so nothing is read back.

#include "decode_attention.cuh"

namespace {

struct DenseLayout {
  int T;
  int pos;
  __device__ int last(int) const { return min(pos, T - 1); }
  __device__ size_t row(int b, int slot) const {
    return static_cast<size_t>(b) * T + slot;
  }
};

}  // namespace

// q (B,H,hd); k/v (B,T,Kv,hd); out (B,H,hd); slots 0..pos are valid;
// scratch holds B*Kv*NS*G*(hd+2) floats.  Split s of NS attends slot tiles
// [s*tps, (s+1)*tps) of TS = 32 slots.  softcap <= 0 means none.  Returns
// the launches' cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out,
                                       void* scratch, int B, int T, int Kv,
                                       int G, int hd, int pos, int NS,
                                       int tps, float scale, float softcap,
                                       int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DenseLayout layout{T, pos};
  if (is_bf16) {
    return repro::decode::launch<__nv_bfloat16>(q, k, v, layout, out, scratch,
                                                B, Kv, G, hd, NS, tps, scale,
                                                softcap, s);
  }
  return repro::decode::launch<float>(q, k, v, layout, out, scratch, B, Kv, G,
                                      hd, NS, tps, scale, softcap, s);
}
