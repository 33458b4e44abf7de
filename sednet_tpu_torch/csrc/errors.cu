// Error text for the codes the kernel entry points return: a cudaError_t,
// or 20000 plus the CUresult of a failed cuTensorMapEncodeTiled
// (mean_shift_bf16.cu).
#include <cuda_runtime.h>
#include <stdio.h>

extern "C" const char* sednet_error_string(int err) {
  if (err >= 20000 && err < 21000) {
    static thread_local char text[64];
    snprintf(text, sizeof(text), "cuTensorMapEncodeTiled failed: CUresult %d",
             err - 20000);
    return text;
  }
  return cudaGetErrorString((cudaError_t)err);
}
