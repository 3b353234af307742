// K-attn-bwd's launches at head widths 72..128 (see csrc/attention_bwd.cu):
// the same device code (csrc/attention_bwd_sm90.cuh), instantiated in a
// source of its own so that the build compiles the two halves of the
// instantiations in parallel.
#include "attention_bwd_sm90.cuh"

namespace ovt {
namespace attn_bwd90 {

int run_wide(int width, const Geo& g, const int64_t* T, cudaStream_t stream) {
  switch (width) {
    case 72: return run<72>(g, T, stream);
    case 80: return run<80>(g, T, stream);
    case 88: return run<88>(g, T, stream);
    case 96: return run<96>(g, T, stream);
    case 104: return run<104>(g, T, stream);
    case 112: return run<112>(g, T, stream);
    case 120: return run<120>(g, T, stream);
    case 128: return run<128>(g, T, stream);
    default: return ERR_PLAN;
  }
}

}  // namespace attn_bwd90
}  // namespace ovt
