// Two-tier SLS bag sum (RecFlash) for Hopper, sm_90a: every table of a
// batch in one launch, with the logical-id -> rank translation fused.
//
// Replaces: src/repro/kernels/recflash_sls.py, recflash_sls (kernel body
// _sls_kernel), the TPU kernel that keeps the hot prefix of the rank-ordered
// table resident in VMEM and fetches each cold row with a double-buffered
// row DMA; and the jnp.take(rank_of) before it in the reference forward
// (src/repro/models/dlrm.py:124), the paper's hash-table lookup.
//
// Computes, for every bag (b, t) of a batch:
//   out[b, t, :] = sum_l row_t(rank_t(indices[b, t, l])),
// or, in a ragged launch (one bag length a table),
//   out[b, t, :] = sum_{l < L_t} row_t(rank_t(indices[b, col_t + l])),
// added in f32 in lookup order and stored in the tables' dtype (f32 or
// bf16, rounded to nearest even once, in the epilogue), where rank_t(id) =
// rank_of_t[id], or id itself for a table given ranks, and a rank r below
// hot_rows_t reads hot_t[r], any other cold_t[r - hot_rows_t]. One table
// without rank_of is the per-table entry (the TPU kernel's own contract).
//
// What bounds it on this card: bytes. A bag reads L rows of D elements and
// does L*D adds, far below the card's operations-per-byte line. At the
// dlrm-rm2 serving shape (B=64, 26 tables, L=80, D=64, f32) a batch touches
// about 5 MB of unique rows, indices, rank_of entries and output, under 2 us
// at 3.35 TB/s. What held the first design back was latency: 8 blocks of
// one table per launch, and ten dependent round trips per thread (index,
// then row, in 5 rounds of 16 lookups), times 26 launches per batch.
//
// Design:
// - One launch for all tables. A table's pointers, hot size, row count and
//   rank_of live in a small device array of TableDesc, built once when the
//   tables are described (kernels/recflash_sls.py::describe, called by
//   dlrm.add_remap); indices (B, n_tables, L) are read with their strides.
// - Ragged bags (DLRM-DCNv2: bags of 1 to 100 ids, a length a table):
//   indices (B, sum_t L_t), table t's ids in columns [col_t, col_t + L_t).
//   Each table's L_t and col_t ride in the launch's arguments (a Ragged
//   struct passed by value, so a CUDA graph captures them and no copy to
//   the card is needed), read by the instance whose layout is Ragged. A
//   uniform launch runs the instance whose layout is the empty Uniform.
//   Shared memory is sized by the longest bag; a block's bags are one
//   table's, so they are all L_t long (below).
// - Table-major blocks: the grid is (ceil(B / per_block), n_tables), so a
//   block's bags are per_block consecutive samples of one table, and share
//   its descriptor, its bag length and its head. Blocks start in index
//   order, x first, so the SMs work through the tables one at a time: at
//   rmc2's shape (B=4096, 8 bags a block) a table is 512 blocks, about 4
//   on each SM, before the next table starts. A ragged table's blocks hold
//   bags of one length, so no block waits for a longer bag of another
//   table. A group of G threads (a power of two, at most 32; 16 for D=64
//   f32 and for D=128 bf16) serves one bag, 128/G bags a block.
// - Three dependent round trips per bag: the group reads the bag's L ids
//   (8 per thread per round, all issued before any is used), then their
//   rank_of entries, and writes the clamped ranks to shared memory (a
//   bag's ranks padded to a multiple of 4, so that they are read back 4 at
//   a time as one 16-byte vector); after one barrier every row address is
//   known. Shared memory holds nothing else: 3.8 KB a block at rmc2's
//   shape (8 bags of 120 lookups).
// - Rows travel by 16-byte loads straight into registers, pipelined in
//   registers: a thread keeps the next kDepth lookups' vectors in flight as
//   uint4 registers, adds the oldest when it has landed and then issues the
//   load kDepth lookups on into its registers. A row vector read from L1
//   crosses the SM's L1/shared-memory array once; a cp.async ring in
//   shared memory crossed it three times (L1 read, shared store, shared
//   load) and took ~0.48 ms a step at rmc2's shape whatever level served
//   the rows.
//   kDepth is 8 (128 bytes in flight a thread, as the ring held), or 12
//   where a launch's bags average at least 24 lookups: a register load
//   that misses L1 needs more bytes in flight than a cp.async did to keep
//   HBM as busy (rmc2's K=2 traffic, mostly cold, is ~2% slower at 8 than
//   the ring, ~2% faster at 12), while short bags want the blocks an SM
//   holds at 8 (64 registers a thread against 80 to 96 at 12; one-id bags
//   ~23% slower at 12). tools/sls_probe.py measures both (PERF.md
//   §6).
// - A lookup's row address is one select of the tier's base and one wide
//   multiply-add (Rows, below): with a branch and two 64-bit multiplies a
//   lookup the loop took over 20 instructions a lookup, and the issue
//   slots, not the memory, bounded it.
// - Each thread owns 16-byte vectors of the row (4 f32 or 8 bf16 values)
//   and adds the bag's rows in lookup order into f32 registers, as the TPU
//   kernel's fori_loop does, so the sum is bit-equal to a sequential f32
//   sum. bf16 rows are widened with __bfloat162float.
// - Where D or a table pointer does not allow 16-byte loads (D=18, say),
//   each thread loads single elements straight into registers, 16 lookups
//   at a time, from the ranks already in shared memory.
// - The hot tier is served from each SM's L1 where it can be: a row load
//   whose rank is below the table's hot size is ld.global.ca, which
//   allocates the row in L1; a cold load is ld.global.cg (L2 only), so
//   that cold rows do not evict the head. The choice is made per lookup,
//   from the rank, with no setting. Since the SMs serve one table at a
//   time, the most frequent ranks of that table are read again from L1
//   (with Zipf 1.23 over 1M ids, a table's first 64 ranks, 16 KB at D=64
//   f32, take ~69% of its lookups); hot rows that L1 does not hold come
//   from L2, which holds every table's prefix (32 x 2000 x 256 B = 16 MB
//   for rmc2) after its first touch. The launcher sets the vector path's
//   shared-memory carveout to what the blocks its registers allow an SM
//   need (32 KB at rmc2's shape: 6 blocks of 3.8 KB), so the rest of the
//   SM's 256 KB, up to 224 KB, is L1 (a 64, 100 or 132 KB carveout read
//   1%, 3% and 14% slower at rmc2's K=0 traffic).
//   This is DESIGN.md §2.2's VMEM-resident hot tier as a cache: the
//   hardware keeps the rows read most, in place of a prefix pinned for the
//   grid (the prefix, 500 KB a table, exceeds the 227 KB a block can
//   have), and a cold row never displaces a hot one from L1.
// - An id outside [0, n_ids) is clamped into that range before the rank_of
//   translation, and a rank outside [0, rows) into that one, so that a bad
//   index cannot read outside a table: -1 reads the first row, an id at or
//   past the end the last. The plain versions clamp the same way
//   (embedding/layout.py::lookup), so a CPU tensor and a CUDA tensor give
//   one result. The reference's jnp.take fills instead (its default mode):
//   -1 reads row V-1 there, and an id at or past V gives NaN.
// - A bf16 bag is rounded from its f32 sum once, when it is stored: 8
//   values are packed into one 16-byte store on the vector path.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// One table of a group; the layout of one row of the (n_tables, 6) int64
// descriptor tensor of kernels/recflash_sls.py::describe.
struct TableDesc {
  const void* hot;
  const void* cold;
  const int32_t* rank_of;  // nullptr: the indices are ranks
  long long hot_rows;
  long long rows;
  long long n_ids;         // entries of rank_of
};
static_assert(sizeof(TableDesc) == 48, "TableDesc must be six 8-byte words");

namespace {

constexpr int kThreads = 128;        // threads per block
// Row loads a thread keeps in flight on the vector path (multiples of 4):
// kDepthShort, or kDepthLong where a launch's bags average at least
// 2 * kDepthLong lookups.
constexpr int kDepthShort = 8;
constexpr int kDepthLong = 12;
constexpr int kSmemPerSm = 233472;   // 228 KB: an SM's most shared memory
constexpr int kSmemCap = 135168;     // 132 KB: the most the kernel asks for
constexpr int kSmemReserved = 1024;  // shared memory the system takes a block
constexpr int kBlocksPerSm = 16;     // blocks an SM's 2048 threads hold
constexpr int kRegsPerSm = 65536;    // 32-bit registers an SM has
constexpr int kAhead = 16;           // lookups per register batch (scalar)
constexpr int kIdx = 8;              // lookups a thread translates per round
constexpr int kMaxSmem = 232448;     // 227 KB, the most a block can have
constexpr int kMaxRagged = 128;      // tables a ragged launch takes

// The bag layouts a launch reads: every bag `lookups` long at table stride
// s_t (Uniform), or bag t L_t long at column col_t (Ragged: 1 KB of kernel
// arguments).
struct Uniform {
  static constexpr bool kRagged = false;
};
struct Ragged {
  static constexpr bool kRagged = true;
  int lookups[kMaxRagged];
  int col[kMaxRagged];
};

__device__ __forceinline__ long long clamp_to(long long x, long long n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One sum stored in the output's dtype (bf16: round to nearest even).
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Two sums as the 32-bit word of two bf16 values (the lower-indexed element
// in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
             << 16;
}

// The 16 / sizeof(T) sums of one 16-byte vector, stored as one vector.
__device__ __forceinline__ void store_vec(float* dst, const float* acc) {
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float* acc) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16x2(acc[0], acc[1]), pack_bf16x2(acc[2], acc[3]),
                 pack_bf16x2(acc[4], acc[5]), pack_bf16x2(acc[6], acc[7]));
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

// Adds one 16-byte vector of a row (16 / sizeof(T) elements) to acc.
template <typename T>
__device__ __forceinline__ void add_vec(const uint4& v, float* acc) {
  constexpr int kPerWord = 4 / sizeof(T);
  add_word(v.x, acc + 0 * kPerWord, T());
  add_word(v.y, acc + 1 * kPerWord, T());
  add_word(v.z, acc + 2 * kPerWord, T());
  add_word(v.w, acc + 3 * kPerWord, T());
}

// A 16-byte load straight into registers that allocates in L1 (.ca) where
// `keep` is set, else in L2 only (.cg); predicated, so a warp whose two bags
// differ does not branch.
__device__ __forceinline__ uint4 ld16(const void* gmem, bool keep) {
  uint4 v;
  asm("{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %5, 0;\n"
      "@p ld.global.ca.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      "@!p ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      "}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(gmem), "r"(static_cast<int>(keep)));
  return v;
}

// A table's rows as the row loops address them, at one thread's column: the
// row of rank r starts at hot + r * row_bytes where r is below split, else
// at cold + r * row_bytes (cold is the cold tier's row 0 less split rows).
// One select and one wide multiply-add a lookup, and no branch.
struct Rows {
  const char* hot;
  const char* cold;
  uint32_t row_bytes;
  uint32_t split;  // the hot size (a rank is a non-negative int32)
};

template <typename T>
__device__ __forceinline__ Rows rows_of(const TableDesc& d, int dim,
                                        int col) {
  const uint32_t split = d.hot_rows < 0xffffffffll
                             ? static_cast<uint32_t>(d.hot_rows)
                             : 0xffffffffu;
  const uint32_t row_bytes = static_cast<uint32_t>(dim * sizeof(T));
  const uintptr_t at = static_cast<uintptr_t>(col) * sizeof(T);
  return {reinterpret_cast<const char*>(
              reinterpret_cast<uintptr_t>(d.hot) + at),
          reinterpret_cast<const char*>(
              reinterpret_cast<uintptr_t>(d.cold) + at -
              static_cast<uintptr_t>(split) * row_bytes),
          row_bytes, split};
}

__device__ __forceinline__ bool is_hot(const Rows& a, int32_t rank) {
  return static_cast<uint32_t>(rank) < a.split;
}

__device__ __forceinline__ const char* row_at(const Rows& a, int32_t rank) {
  return (is_hot(a, rank) ? a.hot : a.cold) +
         static_cast<unsigned long long>(static_cast<uint32_t>(rank)) *
             a.row_bytes;
}

// One window of the vector path's register pipeline: adds lookups l0 ..
// l0 + kDepth - 1 in order (v[s] holds lookup l0 + s), and loads lookup
// l0 + kDepth + s into v[s] as it frees. kWhole: all 2 * kDepth lookups
// exist, so no bound is tested; else those at or past `lookups` are
// skipped.
template <typename T, int kDepth, bool kWhole>
__device__ __forceinline__ void window(uint4 (&v)[kDepth], float* acc,
                                       const int4* ranks4, const Rows& a,
                                       int l0, int lookups) {
#pragma unroll
  for (int q = 0; q < kDepth / 4; ++q) {
    const int l = l0 + 4 * q;
    const int n = l + kDepth;
    int4 r4 = make_int4(0, 0, 0, 0);
    if (kWhole || n < lookups) r4 = ranks4[n / 4];
    const int32_t r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kWhole || l + k < lookups) {
        add_vec<T>(v[4 * q + k], acc);
        if (kWhole || n + k < lookups) {
          v[4 * q + k] = ld16(row_at(a, r[k]), is_hot(a, r[k]));
        }
      }
    }
  }
}

// descs: the group's descriptors, or nullptr for the one table `one`.
// lookups: every bag's length, or in a ragged launch the longest bag's.
// Block (x, t) serves samples [x * per_block, (x + 1) * per_block) of table
// t; bag (b, t) writes out row b * n_tables + t.
// Shared memory: the ranks of the block's bags, bag g's at int32 number
// g * ranks_per_bag (max_lookups rounded up to a multiple of 4).
// Registers: a short-bag launch waits on few loads a thread, so it is
// bound by the bags an SM has in flight, and its instances ask for 8
// blocks an SM (64 registers a thread; dlrm-mlperf's one-id bf16 bags took
// 7% longer than with the cp.async ring at 72, 3% at 64). The long-bag
// instances keep the registers their 12 loads in flight need.
template <typename T, bool kVec, int kDepth, typename Layout>
__global__ void __launch_bounds__(kThreads, kDepth == kDepthShort ? 8 : 0)
    sls_kernel(const TableDesc* __restrict__ descs, TableDesc one,
               const int32_t* __restrict__ indices, long long s_b,
               long long s_t, long long s_l, T* __restrict__ out, int batch,
               int n_tables, int max_lookups, int dim, int group,
               __grid_constant__ const Layout layout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int per_block = blockDim.x / group;
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x % group;
  const int t = blockIdx.y;
  const int b = blockIdx.x * per_block + g;
  const bool live = b < batch;
  const int ranks_per_bag = (max_lookups + 3) / 4 * 4;
  int32_t* ranks = reinterpret_cast<int32_t*>(smem) + g * ranks_per_bag;
  TableDesc d = one;
  int lookups = max_lookups;
  if (live) {
    if (descs != nullptr) d = descs[t];
    const int32_t* ids = indices + b * s_b + t * s_t;
    if constexpr (Layout::kRagged) {
      lookups = layout.lookups[t];
      ids = indices + b * s_b + layout.col[t] * s_l;
    }
    for (int l0 = lane; l0 < lookups; l0 += kIdx * group) {
      long long r[kIdx];
#pragma unroll
      for (int u = 0; u < kIdx; ++u) {
        const int l = l0 + u * group;
        r[u] = l < lookups ? ids[l * s_l] : 0;
      }
      if (d.rank_of != nullptr) {
#pragma unroll
        for (int u = 0; u < kIdx; ++u) {
          if (l0 + u * group < lookups) {
            r[u] = d.rank_of[clamp_to(r[u], d.n_ids)];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kIdx; ++u) {
        const int l = l0 + u * group;
        if (l < lookups) ranks[l] = static_cast<int32_t>(clamp_to(r[u], d.rows));
      }
    }
  }
  __syncthreads();
  if (!live) return;
  T* dst = out + (static_cast<long long>(b) * n_tables + t) * dim;
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);
    static_assert(kDepth % 4 == 0, "ranks are read 4 at a time");
    const int4* ranks4 = reinterpret_cast<const int4*>(ranks);
    for (int c = lane; c < dim / kE; c += group) {
      const int col = c * kE;
      const Rows a = rows_of<T>(d, dim, col);
      float acc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.0f;
      // the first kDepth lookups' loads go out before any add
      uint4 v[kDepth];
#pragma unroll
      for (int q = 0; q < kDepth / 4; ++q) {
        if (4 * q < lookups) {
          const int4 r4 = ranks4[q];
          const int32_t r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (4 * q + k < lookups) {
              v[4 * q + k] = ld16(row_at(a, r[k]), is_hot(a, r[k]));
            }
          }
        }
      }
      int l0 = 0;
      for (; l0 + 2 * kDepth <= lookups; l0 += kDepth) {
        window<T, kDepth, true>(v, acc, ranks4, a, l0, lookups);
      }
      for (; l0 < lookups; l0 += kDepth) {   // the last 1 to 2 * kDepth - 1
        window<T, kDepth, false>(v, acc, ranks4, a, l0, lookups);
      }
      store_vec(dst + col, acc);
    }
  } else {
    for (int c = lane; c < dim; c += group) {
      const Rows a = rows_of<T>(d, dim, c);
      float acc = 0.0f;
      for (int l0 = 0; l0 < lookups; l0 += kAhead) {
        T r[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (l0 + u < lookups) {
            r[u] = *reinterpret_cast<const T*>(row_at(a, ranks[l0 + u]));
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (l0 + u < lookups) acc += widen(r[u]);
        }
      }
      store(dst + c, acc);
    }
  }
}

template <typename T, bool kVec, int kDepth, typename Layout>
int launch(const TableDesc* descs, const TableDesc& one,
           const int32_t* indices, long long s_b, long long s_t,
           long long s_l, T* out, int batch, int n_tables, int lookups,
           int dim, const Layout& layout, cudaStream_t stream) {
  const int units = kVec ? dim / static_cast<int>(16 / sizeof(T)) : dim;
  int group = 1;
  while (group < units && group < 32) group <<= 1;
  const int per_block = kThreads / group;
  const long long smem =
      static_cast<long long>(per_block) * ((lookups + 3) / 4 * 4) * 4;
  if (smem > kMaxSmem || n_tables > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_tables == 0) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  // Above 48 KB a kernel needs this attribute, set once per device; and
  // the blocks an SM's registers hold, read once per device.
  static unsigned long long attr_set = 0;
  static int blocks_per_sm[64] = {};
  if (!(attr_set >> dev & 1ull)) {
    cudaError_t e = cudaFuncSetAttribute(
        sls_kernel<T, kVec, kDepth, Layout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, sls_kernel<T, kVec, kDepth, Layout>);
    if (e != cudaSuccess) return static_cast<int>(e);
    // registers are given a warp in units of 256
    const int per_warp = (fa.numRegs * 32 + 255) / 256 * 256;
    const int fit = kRegsPerSm / (per_warp * (kThreads / 32));
    blocks_per_sm[dev] = fit < kBlocksPerSm ? fit : kBlocksPerSm;
    attr_set |= 1ull << dev;
  }
  // Hot rows stay in L1: the vector path asks for the shared memory of
  // the blocks an SM's registers hold, at most kSmemCap, and the rest of
  // the SM's 256 KB is L1. Set when it changes.
  if constexpr (kVec) {
    static int carveout[64] = {};   // percent + 1; 0: never set
    const long long fill =
        static_cast<long long>(blocks_per_sm[dev]) * (smem + kSmemReserved);
    const long long want = fill < kSmemCap ? fill : kSmemCap;
    const int pct = static_cast<int>(
        (want * 100 + kSmemPerSm - 1) / kSmemPerSm);
    if (carveout[dev] != pct + 1) {
      cudaError_t e = cudaFuncSetAttribute(
          sls_kernel<T, kVec, kDepth, Layout>,
          cudaFuncAttributePreferredSharedMemoryCarveout, pct);
      if (e != cudaSuccess) return static_cast<int>(e);
      carveout[dev] = pct + 1;
    }
  }
  const dim3 grid((batch + per_block - 1) / per_block, n_tables);
  sls_kernel<T, kVec, kDepth, Layout>
      <<<grid, per_block * group, smem, stream>>>(
          descs, one, indices, s_b, s_t, s_l, out, batch, n_tables, lookups,
          dim, group, layout);
  return static_cast<int>(cudaGetLastError());
}

// The instance for a launch: the scalar path, or the vector path with the
// pipeline its bags want. `lookups_sum` is the launch's lookups a sample.
template <typename T, typename Layout>
int launch_vec(int vec, const TableDesc* descs, const TableDesc& one,
               const int32_t* indices, long long s_b, long long s_t,
               long long s_l, T* out, int batch, int n_tables, int lookups,
               long long lookups_sum, int dim, const Layout& layout,
               cudaStream_t stream) {
  if (!vec) {
    return launch<T, false, kDepthShort>(descs, one, indices, s_b, s_t, s_l,
                                         out, batch, n_tables, lookups, dim,
                                         layout, stream);
  }
  if (lookups_sum >= 2LL * kDepthLong * n_tables) {
    return launch<T, true, kDepthLong>(descs, one, indices, s_b, s_t, s_l,
                                       out, batch, n_tables, lookups, dim,
                                       layout, stream);
  }
  return launch<T, true, kDepthShort>(descs, one, indices, s_b, s_t, s_l, out,
                                      batch, n_tables, lookups, dim, layout,
                                      stream);
}

template <typename T>
int launch_layout(const int* ragged, int vec, const TableDesc* descs,
                  const TableDesc& one, const int32_t* indices, long long s_b,
                  long long s_t, long long s_l, void* out, int batch,
                  int n_tables, int lookups, int dim, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  if (ragged == nullptr) {
    return launch_vec<T>(vec, descs, one, indices, s_b, s_t, s_l, o, batch,
                         n_tables, lookups,
                         static_cast<long long>(lookups) * n_tables, dim,
                         Uniform{}, stream);
  }
  if (n_tables > kMaxRagged || descs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ragged layout{};
  long long sum = 0;
  for (int t = 0; t < n_tables; ++t) {
    layout.lookups[t] = ragged[t];
    layout.col[t] = ragged[n_tables + t];
    if (ragged[t] < 1 || ragged[t] > lookups) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sum += ragged[t];
  }
  return launch_vec<T>(vec, descs, one, indices, s_b, s_t, s_l, o, batch,
                       n_tables, lookups, sum, dim, layout, stream);
}

}  // namespace

// descs: n_tables TableDesc on the card, or nullptr for one table given by
// hot, cold, hot_rows and rows, whose indices are ranks. indices (batch,
// n_tables, lookups) int32 with element strides s_b, s_t, s_l; out (batch,
// n_tables, dim) in the tables' dtype, contiguous (16-byte aligned where vec
// is 1). dtype: 0 = float32, 1 = bfloat16, of the tables and out. vec: 1
// if dim and every table pointer allow 16-byte copies. ragged: nullptr, or
// for a ragged launch 2 * n_tables host ints, each table's bag length (1 to
// lookups, the longest) then its first column: indices are then (batch,
// sum of the lengths), read with strides s_b and s_l (s_t unused), and
// descs must be given. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernel does not take (a bad dtype,
// more than 227 KB of shared memory, a bad ragged layout, more than 128
// tables in a ragged launch or more than 65535 in any).
extern "C" int recflash_sls_launch(const void* descs, const void* hot,
                                   const void* cold, long long hot_rows,
                                   long long rows, const void* indices,
                                   long long s_b, long long s_t,
                                   long long s_l, void* out, int batch,
                                   int n_tables, int lookups, int dim,
                                   int dtype, int vec, const int* ragged,
                                   void* stream) {
  const TableDesc* ds = static_cast<const TableDesc*>(descs);
  const TableDesc one{hot, cold, nullptr, hot_rows, rows, rows};
  const int32_t* idx = static_cast<const int32_t*>(indices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_layout<float>(ragged, vec, ds, one, idx, s_b, s_t, s_l,
                                out, batch, n_tables, lookups, dim, s);
  }
  if (dtype == 1) {
    return launch_layout<__nv_bfloat16>(ragged, vec, ds, one, idx, s_b, s_t,
                                        s_l, out, batch, n_tables, lookups,
                                        dim, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
