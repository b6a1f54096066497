// The shape checks and head-dim dispatch that every training attention
// kernel shares (flash_attention.cu: forward, dK/dV, dQ; ring_attention.cu:
// the ring forward); their main loops are attn_fwd_sm90.cuh and
// attn_bwd_sm90.cuh.

#pragma once

#include <type_traits>

namespace attn {

// Head dims 64 and 128; GQA groups 1, 2, 4 and 8.
inline bool shape_ok(int B, int Sq, int Skv, int Hq, int Hkv, int D) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return false;
  const int G = Hq / Hkv;
  return (D == 64 || D == 128) && (G == 1 || G == 2 || G == 4 || G == 8);
}

// Calls f with std::integral_constant<int, D> for D = 128 or 64, so each
// entry point names its kernel and shared memory once for both head dims.
template <typename F>
int with_head_dim(int D, F f) {
  return D == 128 ? f(std::integral_constant<int, 128>{})
                  : f(std::integral_constant<int, 64>{});
}

}  // namespace attn
