// Tensor maps of the weight operands of the wgmma loop (wgmma_conv.cuh).
// The wrappers of kernels A and F encode one per parameter and tile width
// and keep it beside the K-major bf16 operand it describes
// (ops/kernels/_lib.py: operands).
#include "wgmma_conv.cuh"

// w: [Cout, K] bf16, K-major; writes the 128-byte CUtensorMap to ``map``.
extern "C" int vt_weight_map(const void* w, int K, int Cout, int bn, void* map) {
  CUtensorMap m;
  const int e = vt::wg::weight_map(&m, w, K, Cout, bn);
  if (e == 0) memcpy(map, &m, sizeof(CUtensorMap));
  return e;
}
