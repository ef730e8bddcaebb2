// Two-tier SLS bag sum (RecFlash) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/recflash_sls.py, recflash_sls (kernel body
// _sls_kernel), the TPU kernel that keeps the hot prefix of the rank-ordered
// table resident in VMEM and fetches each cold row with a double-buffered
// row DMA.
//
// Computes: out[b, :] = sum_l row(indices[b, l]) in f32, where a rank r below
// hot_rows reads hot[r] and any other rank reads cold[r - hot_rows].
//
// What bounds it on this card: bytes. A bag reads L rows of D elements and
// does L*D adds, far below the card's operations-per-byte line. At the
// dlrm-rm2 serving shape (B=64, L=80, D=64, f32) one launch reads at most
// 1.31 MB of rows, about 0.4 us at 3.35 TB/s, so at batch 64 the launch
// itself, not the memory, sets the time.
//
// Design:
// - A group of G threads (a power of two, at most 32) serves one bag; each
//   thread owns 16-byte vectors of the row (4 f32 or 8 bf16 values), or
//   single elements where D or the pointers do not allow 16-byte loads.
//   A block serves block_b bags, the batch tile of the TPU kernel's grid.
// - Each thread keeps an f32 accumulator in registers and adds the bag's
//   rows in lookup order, as the TPU kernel's fori_loop does, so the sum
//   is bit-equal to a sequential f32 sum. It issues the loads of kAhead
//   lookups before it adds any of them, so that many row reads are in
//   flight at once; this takes the place of the TPU kernel's DMA double
//   buffer.
// - bf16 rows are widened with __bfloat162float.
// - The hot tier is not staged in shared memory. A dlrm-rm2 prefix
//   (2000 x 64 x 4 B = 500 KB) exceeds the 227 KB a block can have, while
//   the 26 prefixes together (12.7 MB) fit in the 50 MB L2, which serves
//   the hot rows after their first touch. This deviates from the VMEM-
//   resident hot tier of DESIGN.md §2.2. Staging the prefix, cp.async or
//   TMA cold fetches and one launch for all tables are later work.
// - A rank outside [0, rows) is clamped into it, as XLA's gather clamps,
//   so that a bad index cannot read outside the table.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kAhead = 16;  // lookups whose rows are loaded before adding

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Adds the elements held in one 32-bit word of a row to acc.
__device__ __forceinline__ void add_word(uint32_t w, float* acc, float) {
  acc[0] += __uint_as_float(w);
}
__device__ __forceinline__ void add_word(uint32_t w, float* acc,
                                         __nv_bfloat16) {
  // little-endian: the low half is the lower-indexed element
  acc[0] += widen(__ushort_as_bfloat16(static_cast<unsigned short>(w)));
  acc[1] += widen(__ushort_as_bfloat16(static_cast<unsigned short>(w >> 16)));
}

// The unit one thread loads per lookup: one element, or one 16-byte vector.
template <typename T, bool kVec>
struct Unit;

template <typename T>
struct Unit<T, false> {
  static constexpr int kElems = 1;
  T x;
  __device__ __forceinline__ void load(const T* p) { x = *p; }
  __device__ __forceinline__ void add_to(float* acc) const {
    acc[0] += widen(x);
  }
};

template <typename T>
struct Unit<T, true> {
  static constexpr int kElems = 16 / sizeof(T);
  static constexpr int kPerWord = 4 / sizeof(T);
  uint4 x;
  __device__ __forceinline__ void load(const T* p) {
    x = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void add_to(float* acc) const {
    add_word(x.x, acc + 0 * kPerWord, T());
    add_word(x.y, acc + 1 * kPerWord, T());
    add_word(x.z, acc + 2 * kPerWord, T());
    add_word(x.w, acc + 3 * kPerWord, T());
  }
};

template <typename T, bool kVec>
__global__ void sls_kernel(const T* __restrict__ hot,
                           const T* __restrict__ cold,
                           const int32_t* __restrict__ indices,
                           float* __restrict__ out, int64_t hot_rows,
                           int64_t rows, int dim, int batch, int lookups,
                           int group) {
  using U = Unit<T, kVec>;
  constexpr int kE = U::kElems;
  const int bags_per_block = blockDim.x / group;
  const int bag = blockIdx.x * bags_per_block + threadIdx.x / group;
  const int lane = threadIdx.x % group;
  if (bag >= batch) return;
  const int32_t* idx = indices + static_cast<int64_t>(bag) * lookups;
  const int units = dim / kE;
  for (int c = lane; c < units; c += group) {
    const int64_t col = static_cast<int64_t>(c) * kE;
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.0f;
    for (int l0 = 0; l0 < lookups; l0 += kAhead) {
      U r[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (l0 + u < lookups) {
          int64_t row = idx[l0 + u];
          row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);
          const T* src = row < hot_rows ? hot + row * dim
                                        : cold + (row - hot_rows) * dim;
          r[u].load(src + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (l0 + u < lookups) r[u].add_to(acc);
      }
    }
    float* dst = out + static_cast<int64_t>(bag) * dim + col;
#pragma unroll
    for (int e = 0; e < kE; ++e) dst[e] = acc[e];
  }
}

template <typename T>
void launch(const void* hot, const void* cold, const void* indices, void* out,
            int64_t hot_rows, int64_t rows, int dim, int batch, int lookups,
            int block_b, int vec, int group, cudaStream_t stream) {
  const dim3 grid((batch + block_b - 1) / block_b);
  const dim3 block(block_b * group);
  const T* h = static_cast<const T*>(hot);
  const T* c = static_cast<const T*>(cold);
  const int32_t* i = static_cast<const int32_t*>(indices);
  float* o = static_cast<float*>(out);
  if (vec) {
    sls_kernel<T, true><<<grid, block, 0, stream>>>(
        h, c, i, o, hot_rows, rows, dim, batch, lookups, group);
  } else {
    sls_kernel<T, false><<<grid, block, 0, stream>>>(
        h, c, i, o, hot_rows, rows, dim, batch, lookups, group);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: 1 if dim and both table pointers
// allow 16-byte loads. group: threads per bag. Returns cudaGetLastError().
extern "C" int recflash_sls_launch(const void* hot, const void* cold,
                                   const void* indices, void* out,
                                   long long hot_rows, long long rows,
                                   int dim, int batch, int lookups,
                                   int block_b, int dtype, int vec, int group,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(hot, cold, indices, out, hot_rows, rows, dim, batch,
                  lookups, block_b, vec, group, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(hot, cold, indices, out, hot_rows, rows, dim, batch,
                          lookups, block_b, vec, group, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
