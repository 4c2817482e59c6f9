// Tensor maps of the weight operands of the wgmma loop (wgmma_conv.cuh).
// The wrappers of kernels A, B, E and F encode them once per parameter and
// tile width and keep them beside the K-major bf16 operand they describe
// (ops/kernels/_lib.py: operands).
#include "wgmma_conv.cuh"

// w: [parities * Cout, pieces * K] bf16, K-major, K = taps * Cin + Cs;
// writes the main map and the 1x1 term's (a copy of the main one when
// Cs = 0) side by side, 256 bytes, to ``maps`` (wgmma_conv.cuh:
// weight_maps, read_weight_maps).
extern "C" int vt_weight_map(const void* w, int cin, int taps, int cs, int pieces, int cout,
                             int parities, int bn, void* maps) {
  CUtensorMap m[2];
  const int e = vt::wg::weight_maps(&m[0], &m[1], w, cin, taps, cs, pieces, cout, parities, bn);
  if (e == 0) {
    if (cs == 0) m[1] = m[0];
    memcpy(maps, m, sizeof(m));
  }
  return e;
}
