// DLRM pairwise-dot interaction (batched Gram matrices) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/dot_interaction.py, dot_interaction (kernel
// body _dot_kernel), the TPU kernel that runs z_blk @ z_blk^T on the MXU
// for a block of samples with f32 accumulation.
//
// Computes: out[b, i, j] = sum_d z[b, i, d] * z[b, j, d] in f32, for
// z (B, T, D) f32 or bf16 -> out (B, T, T) f32. The strict upper triangle is
// sliced outside the kernel (repro_torch/kernels/ops.py), as in the reference.
//
// What bounds it on this card: bytes. At the dlrm-rm2 serving shape
// (B=64, T=27, D=64, f32) it reads 442 KB and writes 187 KB, about 0.19 us
// at 3.35 TB/s, against 6 MFLOP (0.09 us at the 67 TFLOP/s of f32 outside
// the tensor cores). At batch 64 the launch itself sets the time.
//
// Design: one block per sample. The sample's (T, D) stack is staged in
// shared memory as f32 (bf16 widened with __bfloat162float), each row padded
// to D + 1 words so that the threads of a warp, which read different rows at
// the same column, hit different banks. Each thread computes (i, j) outputs
// strided by the block size, as an f32 FMA chain over D in order. Loops are
// bounded by T and D themselves, so no shape has to be a multiple of a tile
// (the reference's test shape (8, 3, 18) has D = 18). The tensor cores are
// not used: T <= 33 and D <= 128 are below one wgmma tile, and the kernel is
// bound by bytes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void gram_kernel(const T* __restrict__ z, float* __restrict__ out,
                            int t, int d) {
  extern __shared__ float zs[];  // t rows of d + 1 floats
  const int ld = d + 1;
  const int64_t b = blockIdx.x;
  const T* zb = z + b * t * d;
  for (int k = threadIdx.x; k < t * d; k += blockDim.x) {
    zs[(k / d) * ld + k % d] = widen(zb[k]);
  }
  __syncthreads();
  float* ob = out + b * t * t;
  for (int o = threadIdx.x; o < t * t; o += blockDim.x) {
    const float* zi = zs + (o / t) * ld;
    const float* zj = zs + (o % t) * ld;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(zi[k], zj[k], acc);
    ob[o] = acc;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int dot_interaction_launch(const void* z, void* out, int batch,
                                      int t, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(t) * (d + 1) * sizeof(float);
  if (dtype == 0) {
    gram_kernel<float><<<batch, kThreads, smem, s>>>(
        static_cast<const float*>(z), static_cast<float*>(out), t, d);
  } else if (dtype == 1) {
    gram_kernel<__nv_bfloat16><<<batch, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<float*>(out), t, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
