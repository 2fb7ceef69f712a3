// The f32-to-bf16 cast that ends a backward whose gradient was summed in an
// f32 atomicAdd scratch (msda_bwd.cu, and dcn_bwd.cuh through dcn_fwd.cu).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 __nv_bfloat16* __restrict__ dst, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}
