// DLRM pairwise-dot interaction for Hopper, sm_90a: batched Gram matrices,
// and the same fused into the top-MLP input.
//
// Replaces: src/repro/kernels/dot_interaction.py, dot_interaction (kernel
// body _dot_kernel), the TPU kernel that runs z_blk @ z_blk^T on the MXU
// for a block of samples with f32 accumulation; in the fused mode also the
// concat, triangle gather and second concat of the reference's
// dlrm.interact (src/repro/models/dlrm.py:96-106).
//
// Computes, for z = [first; rest] of T rows of D per sample, row 0 from
// `first` (B, D) and rows 1..T-1 from `rest` (B, T-1, D), f32 or bf16:
// - full mode:  out (B, T, T) f32, out[b, i, j] = sum_d z[b,i,d] z[b,j,d];
// - fused mode: out (B, D + T(T-1)/2) in the inputs' dtype, columns [0, D)
//   hold z[b, 0] (the bottom MLP's output) and the rest the strict upper
//   triangle of the Gram in numpy.triu_indices(T, k=1) order: exactly what
//   dlrm.interact returns, in one launch instead of a cat, a Gram, a
//   triangle gather and a second cat. Every dot is accumulated in f32; a
//   bf16 output is rounded from it once, to nearest even, when it is
//   stored (the reference's bf16 einsum also returns bf16).
//
// What bounds it on this card: bytes. At the dlrm-rm2 serving shape
// (B=64, T=27, D=64, f32) the fused mode reads 442 KB and writes 106 KB,
// about 0.16 us at 3.35 TB/s, against 2.9 MFLOP of the i<j dots (0.04 us at
// the 67 TFLOP/s of f32 outside the tensor cores). At batch 64 latency sets
// the time: one load of the sample, one barrier, a chain of D/4 shared-
// memory steps, one store. The first design ran one serial FMA chain per
// output with two scalar shared-memory loads per step, over the full T x T.
//
// Design:
// - One block per sample, its work split across the block's warps: a
//   sample is one (T, D) tile, a few KB, and splitting it over blocks
//   would only repeat its load. At B=64 that leaves SMs idle, but each
//   block's critical path (load, barrier, D/4 steps, store) is the same
//   either way.
// - The sample is staged in shared memory as f32, rows padded to D + 4
//   floats (16-byte aligned rows, shifted 4 banks apart). f32 rows whose
//   pointers and strides allow it arrive by 16-byte cp.async copies; bf16
//   rows and the others are loaded and widened with __bfloat162float.
// - Rows are taken in tiles of 2 (a zero row pads an odd T). Each thread
//   owns one 2 x 2 output tile (ti, tj) with ti <= tj, so only the upper
//   triangle and its diagonal tiles are computed. Per step it reads four
//   16-byte vectors and runs 16 FMAs on four independent chains. D is a
//   template parameter for the configs' widths (16, 32, 64, 128), so the
//   loop unrolls fully; other widths (the reference's test D=18) take a
//   generic path with scalar steps and rows padded to D + 1.
// - f32 stays on the CUDA cores: TF32 mma keeps 10 mantissa bits, about
//   5e-4 relative error per product, and would break the 1e-5 tolerance
//   against the f32 reference. bf16 is widened exactly and also runs on the
//   CUDA cores (products of widened bf16 are exact in f32, as in mma.sync
//   m16n8k16 with f32 accumulation); at T <= 33 the kernel is latency-bound
//   and an mma tile would be mostly padding.
// - Each output is an f32 FMA chain over d in order. fmaf(x, y, acc) ==
//   fmaf(y, x, acc), so the (i, j) and (j, i) entries of the full mode are
//   one value, written twice.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 48 * 1024;  // static launch limit, no attribute

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One value stored in the output's dtype (bf16: round to nearest even).
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Shared-memory row pitch in floats.
__host__ __device__ constexpr int pitch(int d, bool vec) {
  return vec ? d + 4 : d + 1;
}

// kD > 0: D known at compile time (a multiple of 4); kD == 0: d at run time.
// aligned: f32 rows may be copied 16 bytes at a time. Out: T in the fused
// mode, f32 in the full mode.
template <typename T, int kD, bool kFused,
          typename Out = std::conditional_t<kFused, T, float>>
__global__ void __launch_bounds__(kMaxThreads)
    interaction_kernel(const T* __restrict__ first, long long s0,
                       const T* __restrict__ rest, long long s1,
                       Out* __restrict__ out, int t, int d_rt,
                       bool aligned) {
  extern __shared__ __align__(16) float zs[];
  constexpr bool kVec = kD > 0;
  const int d = kVec ? kD : d_rt;
  const int ld = pitch(d, kVec);
  const long long b = blockIdx.x;
  const int nt = (t + 1) / 2;           // row tiles
  const T* z0 = first + b * s0;
  const T* zr = rest + b * s1;
  // stage the sample (and a zero row after an odd T)
  if (t % 2) {
    for (int k = threadIdx.x; k < d; k += blockDim.x) zs[t * ld + k] = 0.0f;
  }
  if constexpr (kVec && sizeof(T) == 4) {
    if (aligned) {
      constexpr int kQ = kD / 4;
      for (int q = threadIdx.x; q < t * kQ; q += blockDim.x) {
        const int r = q / kQ, c = q % kQ;
        const T* src = r == 0 ? z0 : zr + static_cast<long long>(r - 1) * kD;
        cp_async16(zs + r * ld + 4 * c, src + 4 * c);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                       : "memory");
    }
  }
  if (!(kVec && sizeof(T) == 4 && aligned)) {
    for (int q = threadIdx.x; q < t * d; q += blockDim.x) {
      const int r = q / d, c = q % d;
      const T* src = r == 0 ? z0 : zr + static_cast<long long>(r - 1) * d;
      zs[r * ld + c] = widen(src[c]);
    }
  }
  __syncthreads();
  const int n_tri = t * (t - 1) / 2;
  Out* ob = out + b * (kFused ? d + n_tri : static_cast<long long>(t) * t);
  if (kFused) {
    // zs holds the widened input, so a bf16 value goes back exactly
    for (int k = threadIdx.x; k < d; k += blockDim.x) store(&ob[k], zs[k]);
  }
  const int n_pairs = nt * (nt + 1) / 2;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    int ti = 0, q = p;                  // p -> row tiles (ti, tj), ti <= tj
    while (q >= nt - ti) {
      q -= nt - ti;
      ++ti;
    }
    const int i0 = 2 * ti, j0 = 2 * (ti + q);
    float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f;
    if constexpr (kVec) {
      const float4* a0 = reinterpret_cast<const float4*>(zs + i0 * ld);
      const float4* a1 = reinterpret_cast<const float4*>(zs + (i0 + 1) * ld);
      const float4* b0 = reinterpret_cast<const float4*>(zs + j0 * ld);
      const float4* b1 = reinterpret_cast<const float4*>(zs + (j0 + 1) * ld);
#pragma unroll
      for (int k = 0; k < kD / 4; ++k) {
        const float4 x0 = a0[k], x1 = a1[k], y0 = b0[k], y1 = b1[k];
        c00 = fmaf(x0.x, y0.x, c00); c01 = fmaf(x0.x, y1.x, c01);
        c10 = fmaf(x1.x, y0.x, c10); c11 = fmaf(x1.x, y1.x, c11);
        c00 = fmaf(x0.y, y0.y, c00); c01 = fmaf(x0.y, y1.y, c01);
        c10 = fmaf(x1.y, y0.y, c10); c11 = fmaf(x1.y, y1.y, c11);
        c00 = fmaf(x0.z, y0.z, c00); c01 = fmaf(x0.z, y1.z, c01);
        c10 = fmaf(x1.z, y0.z, c10); c11 = fmaf(x1.z, y1.z, c11);
        c00 = fmaf(x0.w, y0.w, c00); c01 = fmaf(x0.w, y1.w, c01);
        c10 = fmaf(x1.w, y0.w, c10); c11 = fmaf(x1.w, y1.w, c11);
      }
    } else {
      const float* a0 = zs + i0 * ld;
      const float* b0 = zs + j0 * ld;
      for (int k = 0; k < d; ++k) {
        const float x0 = a0[k], x1 = a0[k + ld], y0 = b0[k], y1 = b0[k + ld];
        c00 = fmaf(x0, y0, c00); c01 = fmaf(x0, y1, c01);
        c10 = fmaf(x1, y0, c10); c11 = fmaf(x1, y1, c11);
      }
    }
    const float c[2][2] = {{c00, c01}, {c10, c11}};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = i0 + u, j = j0 + v;
        if (i >= t || j >= t) continue;
        if (kFused) {
          // the index in int first, then one address computation
          if (i < j) store(&ob[d + i * t - i * (i + 1) / 2 + (j - i - 1)], c[u][v]);
        } else {
          store(&ob[i * t + j], c[u][v]);
          store(&ob[j * t + i], c[u][v]);
        }
      }
    }
  }
}

template <typename T, int kD, bool kFused>
int launch(const void* first, long long s0, const void* rest, long long s1,
           void* out, int batch, int t, int d, bool aligned,
           cudaStream_t stream) {
  const int rows = 2 * ((t + 1) / 2);
  const size_t smem = static_cast<size_t>(rows) * pitch(d, kD > 0) * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int nt = (t + 1) / 2;
  const int n_pairs = nt * (nt + 1) / 2;
  int threads = (n_pairs + 31) / 32 * 32;
  threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads : threads);
  using Out = std::conditional_t<kFused, T, float>;
  interaction_kernel<T, kD, kFused><<<batch, threads, smem, stream>>>(
      static_cast<const T*>(first), s0, static_cast<const T*>(rest), s1,
      static_cast<Out*>(out), t, d, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kFused>
int by_width(const void* first, long long s0, const void* rest, long long s1,
             void* out, int batch, int t, int d, bool aligned,
             cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<T, 16, kFused>(first, s0, rest, s1, out, batch, t, d,
                                   aligned, s);
    case 32:
      return launch<T, 32, kFused>(first, s0, rest, s1, out, batch, t, d,
                                   aligned, s);
    case 64:
      return launch<T, 64, kFused>(first, s0, rest, s1, out, batch, t, d,
                                   aligned, s);
    case 128:
      return launch<T, 128, kFused>(first, s0, rest, s1, out, batch, t, d,
                                    aligned, s);
    default:
      return launch<T, 0, kFused>(first, s0, rest, s1, out, batch, t, d,
                                  aligned, s);
  }
}

template <typename T>
int by_mode(const void* first, long long s0, const void* rest, long long s1,
            void* out, int batch, int t, int d, int fused, bool aligned,
            cudaStream_t s) {
  return fused ? by_width<T, true>(first, s0, rest, s1, out, batch, t, d,
                                   aligned, s)
               : by_width<T, false>(first, s0, rest, s1, out, batch, t, d,
                                    aligned, s);
}

}  // namespace

// Row 0 of each sample at first + b * s0, rows 1..t-1 at rest + b * s1 +
// (r - 1) * d (element strides); out (batch, t, t) f32 (fused = 0) or
// (batch, d + t(t-1)/2) in the inputs' dtype (fused = 1), contiguous.
// dtype: 0 = float32, 1 = bfloat16. aligned: 1 if both pointers are 16-byte
// aligned and both strides a multiple of 16 bytes. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernel does not
// take.
extern "C" int dot_interaction_launch(const void* first, long long s0,
                                      const void* rest, long long s1,
                                      void* out, int batch, int t, int d,
                                      int dtype, int fused, int aligned,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return by_mode<float>(first, s0, rest, s1, out, batch, t, d, fused,
                          aligned != 0, s);
  }
  if (dtype == 1) {
    return by_mode<__nv_bfloat16>(first, s0, rest, s1, out, batch, t, d,
                                  fused, aligned != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
