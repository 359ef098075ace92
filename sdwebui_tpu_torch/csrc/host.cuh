// Host-side helpers shared by the kernel sources of this directory: the TMA
// tensor maps of flash_attention.cu and conv3x3.cu (cuTensorMapEncodeTiled
// reached through the runtime, TMA's alignment rule, the swizzle of a span
// in bytes), the dynamic shared-memory opt-in and the SM count.
#pragma once

#include <cuda.h>   // CUtensorMap and the encoder's types (libcuda is not linked)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its address,
// so the libraries link the runtime only
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a bf16 tensor of `rank` dims (dims[0] innermost and contiguous, strides in
// bytes for dims 1..rank-1), read in boxes of `box`; elements outside the
// tensor, at negative coordinates too, load as zeros
bool encode_bf16(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank), const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct View {   // one operand: base pointer and element strides (last dim contiguous)
  const void* ptr;
  int64_t sb, sh, ss;
};

// TMA's rules: a 16-byte aligned base, and every stride but the innermost a
// multiple of 16 bytes (sizes of 1 have their stride ignored)
bool tma_ok(const View& v, int batch, int heads, int rows) {
  if (reinterpret_cast<uintptr_t>(v.ptr) % 16) return false;
  const int64_t st[3] = {v.ss, v.sh, v.sb};
  const int n[3] = {rows, heads, batch};
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (st[i] <= 0 || (st[i] * 2) % 16)) return false;
  return true;
}

CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

}  // namespace
