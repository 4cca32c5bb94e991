// The CUDA library's cuTensorMapEncodeTiled, found once through the
// runtime, so that no source links against libcuda. Shared by the
// sources that stage tiles by TMA: interaction.cu (the W tile) and
// lstm.cu (the wgmma gate GEMM's operands and xproj).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The encoder, or null where CUDA has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      (void)cudaGetLastError();
      return (EncodeTiled) nullptr;
    }
    return (EncodeTiled)p;
  }();
  return fn;
}

}  // namespace
