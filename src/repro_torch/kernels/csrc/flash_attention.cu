// Flash attention for Hopper, sm_90a: the forward and the FlashAttention-2
// backward (Dao, arXiv:2307.08691), with GQA, MLA's qk/v head dims and an
// explicit causal offset q_start.
//
// Replaces: src/repro/models/attention.py:120, _flash_attention and its
// custom_vjp (_flash_fwd, _flash_bwd). The reference is plain jnp, not a
// Pallas kernel: XLA fuses its chunk loops under jit on the TPU. The port's
// plain version (kernels/ref.py, flash_attention_fwd_ref / _bwd_ref) runs
// the same loops eagerly, about eight elementwise passes per score block.
//
// Semantics, as the reference's (held exactly where the reference is):
// - scores s = (q . k) * scale in f32; causal masking in global positions,
//   grouped row r (query head kv_head * n_rep + r % n_rep at position
//   t = r / n_rep) at q_start + t sees key j <= q_start + t; a masked score
//   is NEG_INF = -1e30, finite, so a row that sees no key (q_start < 0) has
//   p = exp(0) = 1 on every key: its output is the mean of v, and its
//   saved lse = -1e30 + log(S) rounds to -1e30, so its backward p is 1;
// - a key tile wholly past a query tile is skipped only when every row of
//   the tile sees key 0 (the reference's kv_chunks rule); the rows' running
//   max is then finite and a masked key adds exp(-1e30 - m) = 0 exactly;
// - out = acc / max(l, 1e-37) in q's dtype; lse = m + log(l_safe) in f32;
//   p is rounded to q's dtype before the PV product;
// - backward: delta = rowsum(dO * O) in f32; p = exp(s - lse) recomputed;
//   ds = p * (dp - delta) * scale rounded to q's dtype; dq, dk, dv added in
//   f32 and cast to the inputs' dtype at the end; a GQA kv head's dk/dv sum
//   the n_rep query heads of its group (they are rows of one product).
// The scores and dp stay in f32 (the reference rounds q.k and dO.v to bf16
// first), and each product accumulates in f32 across tiles (the reference
// rounds each chunk pair's product to bf16): both more exact.
//
// What bounds it on this card: operations. At qwen3-1.7b's prefill shape
// (B 8, T = S = 4096, 16 query heads over 8 kv heads, d 128, causal, bf16)
// the forward does 5.5e11 FLOP, 0.555 ms at 989 TFLOP/s, against 0.40 GB
// of q, k, v and out, 0.12 ms at 3.35 TB/s; the backward 2.5x the forward.
//
// Two routes; the wrapper picks one from the dtype alone
// (kernels/flash_attention.py, route) and passes its code; a launch on a
// route that has no instance for the bucket fails, never falls back.
//
// 1. wgmma (bf16): the Hopper design below.
// 2. cuda_cores (float32): the register-blocked design in namespace cc, on
//    the CUDA cores in exact f32 (fmaf and expf): TF32 would keep 10
//    mantissa bits and break the f32 tolerances.
// Both build the instances 64/64, 128/128 and 192/128 (every LM config's
// head dims); the test-only buckets 32/32 and 48/32 run on 64/64,
// zero-padded (by TMA, and by cp.async's zero fill), and both make two
// backward launches.
//
// The cuda_cores route (FlashAttention-2's loops, as SIMT SGEMM tiles):
// - What bounds it: the CUDA cores' 67 TFLOP/s. Each product is a
//   register-blocked tile (prod_nt, prod_nn): lanes 4 rows x 8 columns,
//   each thread 4 x 2 to 4 x 24 outputs, operands read 16 bytes at a time
//   from rows padded by 16 bytes, so no load has a bank conflict, and a
//   warp issues MT + NT loads per four k for 4 MT NT FMAs.
//   tools/flash_f32_probe.py times these loops alone, and the loads they
//   issue, on the card (PERF.md, the findings of the float32 route); the
//   softmax, the copies and the barriers take the kernels to about 50%.
// - One 256-thread block an SM (eight warps; up to 221 KB of shared memory,
//   up to 255 registers a thread), K/V (forward, dq) or Q/dO/lse/delta
//   (dk/dv) double-buffered by 16-byte cp.async copies that also zero the
//   columns past d and the rows past T or S, so no tile is ever cleared.
// - A warp owns its rows (forward, dq) or keys (dk/dv) in every product
//   of a step, so P and dS pass through shared memory between its two
//   products with a __syncwarp only.
// - Forward: a block takes 128 positions of one query head, longest
//   first, 64 keys a step (48 at 192/128): S = Q K^T, the online softmax,
//   P into K's place (one barrier), O += P V.
// - Backward, two launches, as the wgmma route's: dq (128 positions of one
//   head, 32 keys a step, 16 at 192/128) first sums delta = rowsum(dO O)
//   for its rows and writes it out, then S and dP in one loop and dQ +=
//   dS K; dk/dv (128 keys of one kv head) walks every query head of the
//   group and every query tile that sees its keys, 32 rows a step (16 at
//   192/128): S^T and dP^T, dV += P^T dO, dK += dS^T Q. No atomics.
//
// The wgmma route (FlashAttention-3's shape, Shah et al., arXiv:2407.08608):
// - Every block is three warpgroups: two consumers of 64 rows each and one
//   producer. setmaxnreg gives the consumers 240 registers a thread and
//   leaves the producer 24: 64,512 in all, the block's 168 x 384 at launch
//   (setmaxnreg moves registers inside the block; asking for more waits
//   forever). One producer thread keeps a ring of stages in flight by TMA
//   (cp.async.bulk.tensor, 4-D maps over the tensors' own (d, heads, L, B)
//   strides, 64-column boxes under the 128-byte swizzle; a row of 128 or
//   192 columns is two or three boxes), with full and empty mbarriers a
//   stage. TMA zero-fills past T and S; keys past S still read -inf in
//   the scores (only the last tile checks).
// - Products are wgmma.m64nNk16 with f32 accumulators. Q stays resident in
//   shared memory as the A operand of S = Q K^T; p and ds go from the
//   accumulators to bf16 A fragments in registers; a transposed operand
//   (V in P V, K in dS K, Q and dO in the dk/dv sums) is read MN-major
//   through its descriptor, never copied.
// - A block takes 128 positions of one query head (forward, dq): a GQA
//   group's 6 or 7 heads do not tile a 128-row box, so the grouped order
//   lives only in lse's and delta's index. Causal blocks run longest first;
//   the causal mask and the ragged-S test run only on the tiles that cross
//   the diagonal or the end, and the key-tile skip rule is key_tiles'.
// - Forward, 128 x 128 tiles, three K/V stages (225 KB of shared memory
//   at d 128; two at 192/128, 209 KB): each consumer issues S_{j+1} and
//   P_j V_j back to back, frees K_{j+1}'s stage as soon as S_{j+1} is in,
//   and runs its softmax while P_j V_j is still in the tensor core; O is
//   rescaled, and P_{j+1}'s bf16 fragments made, only after P_j V_j lands.
//   A register a wgmma in flight reads must not be written meanwhile, or
//   ptxas serializes the products (its C7513 note) and the overlap is
//   gone. The two consumers are not made to take turns (FA-3's ping-pong
//   ran 18% slower here on an NVIDIA H100 80GB HBM3 at 700 W).
// - Backward, two launches: the dq kernel (128 rows, 64 keys a step) first
//   sums delta = rowsum(dO O) for its rows and writes it out, then walks
//   the key tiles (S, dP, dQ += dS K); the dk/dv kernel (128 keys a block,
//   64 a consumer) walks every query head of the group and every query
//   tile that sees its keys, 64 rows a step (32 at 192/128, where dk's 96
//   and dv's 64 accumulator registers a thread leave no room for 64), with
//   lse and delta staged by the producer warp. No atomics: every dq, dk
//   and dv element is one block's f32 sum in a fixed order.
// - What bounds it: the tensor cores' 989 TFLOP/s, and before them the
//   softmax's exp (16 a clock an SM, half the products' time at d 128)
//   and its other ALU work, which this design overlaps with the other
//   warpgroup and, in the forward only, with the P V product; the
//   backward's steps are serial inside a warpgroup.

#include <cmath>
#include <cstdint>

#include <cuda.h>  // CUtensorMap, cuTensorMapEncodeTiled (-lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: finite

// A (B, L, heads, d) tensor read through its element strides; d contiguous.
struct View {
  const void* p;
  long long sb, sl, sh;
};

struct Args {
  View q, k, v, dout;
  const void* out;  // (B, T, H, dv), contiguous
  float* lse;       // (B, KV, T * n_rep)
  float* delta;     // (B, KV, T * n_rep)
  void* o;          // forward output (B, T, H, dv)
  void* dq;         // (B, T, H, dqk)
  void* dk;         // (B, S, KV, dqk)
  void* dv;         // (B, S, KV, dv)
  int B, T, S, H, KV, n_rep, dqk, dvd, q_start, causal;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* row_of(const View& v, long long b,
                                           long long l, long long h) {
  return static_cast<const T*>(v.p) + b * v.sb + l * v.sl + h * v.sh;
}

// two neighbouring elements of a row, rounded to bf16
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The key tiles [0, end) a query tile of rows [r0, r1) reads, `bn` keys a
// tile: all of them unless causal and every row sees key 0.
__device__ __forceinline__ int key_tiles(const Args& a, int r0, int r1,
                                         int bn) {
  const int n_tiles = (a.S + bn - 1) / bn;
  const int q_lo = a.q_start + r0 / a.n_rep;
  const int q_hi = a.q_start + (r1 - 1) / a.n_rep;
  if (!a.causal || q_lo < 0) return n_tiles;
  return min(n_tiles, q_hi / bn + 1);
}

// ======================================== the CUDA-core route (float32) ==
namespace cc {

constexpr int kThreads = 256;  // eight warps, one block an SM

// ---------------------------------------------------------------- copies --
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, n) of a tile D floats wide into shared rows of `ld` floats: the
// first d floats of row i from row(i), zeros past d and where row(i) is
// null; every column a product reads is written, so no tile is ever
// cleared (P and dS reuse other tiles' space).
template <int D, typename RowFn>
__device__ __forceinline__ void load_rows(float* s, int ld, int n, int d,
                                          const void* base, RowFn row) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  constexpr int DR = kThreads / C, DC = kThreads % C;
  int r = threadIdx.x / C, c = threadIdx.x % C;  // chunk (r, c), then on
  while (r < n) {                                 // by kThreads chunks
    const float* src = row(r);
    const bool ok = src != nullptr && 4 * c < d;
    cp16(s + r * ld + 4 * c, ok ? static_cast<const void*>(src + 4 * c) : base,
         ok);
    r += DR;
    c += DC;
    if (DC && c >= C) {
      c -= C;
      ++r;
    }
  }
}

// ------------------------------------------------------------- products --
// Register-blocked SIMT products. A warp's lanes are 4 rows by 8 columns:
// lane (la, lb) = (lane / 8, lane % 8) holds rows la + 4 i (i < MT) of its
// warp's tile. Every operand is read from shared memory 16 bytes at a time,
// four k of a row of A, then four k (nt) or four columns (nn) of B, and
// each k runs from registers as MT x NT FMAs: per four k a warp issues MT +
// NT loads, each of 4 or 8 distinct 16-byte chunks, at most 128 bytes (on
// rows padded by 16 bytes, so a quarter-warp's eight rows fall on distinct
// banks), for 4 MT NT FMAs. Each output sums its k in order, so reruns
// are bit-equal.
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c[i][j] += sum_k a[4 i LA + k] b[8 j LB + k], k < K: a at the thread's
// first row of A, b at its first row of B^T (columns lb + 8 j)
template <int MT, int NT, int K, int LA, int LB>
__device__ __forceinline__ void prod_nt(float (&c)[MT][NT], const float* a,
                                        const float* b) {
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 x[MT], y[NT];
#pragma unroll
    for (int i = 0; i < MT; ++i) x[i] = lds4(a + 4 * i * LA + k);
#pragma unroll
    for (int j = 0; j < NT; ++j) y[j] = lds4(b + 8 * j * LB + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          c[i][j] = fmaf(at(x[i], e), at(y[j], e), c[i][j]);
  }
}

// Two nt products of one tile shape in one loop (S and dP in the backward):
// c += A B^T over k < KA and d += E F^T over k < KE, each summing its k in
// order as prod_nt does; the k both share run together, which doubles the
// independent sums a thread has in flight
template <int MT, int NT, int KA, int KE, int LA, int LE>
__device__ __forceinline__ void prod_nt2(float (&c)[MT][NT], const float* a,
                                         const float* b, float (&d)[MT][NT],
                                         const float* e, const float* f) {
  constexpr int K = KA < KE ? KA : KE;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 x[MT], y[NT], u[MT], w[NT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      x[i] = lds4(a + 4 * i * LA + k);
      u[i] = lds4(e + 4 * i * LE + k);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      y[j] = lds4(b + 8 * j * LA + k);
      w[j] = lds4(f + 8 * j * LE + k);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          c[i][j] = fmaf(at(x[i], q), at(y[j], q), c[i][j]);
          d[i][j] = fmaf(at(u[i], q), at(w[j], q), d[i][j]);
        }
  }
  if constexpr (KA > K) prod_nt<MT, NT, KA - K, LA, LA>(c, a + K, b + K);
  if constexpr (KE > K) prod_nt<MT, NT, KE - K, LE, LE>(d, e + K, f + K);
}

// c[i][4 g + e] += sum_k a[4 i LA + k] b[k LB + 32 g + e], k < K: a at the
// thread's first row of A, b at row 0 of B, column 4 lb (columns 4 lb + 32
// g + e of the warp's tile)
template <int MT, int NT, int K, int LA, int LB>
__device__ __forceinline__ void prod_nn(float (&c)[MT][NT], const float* a,
                                        const float* b) {
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 x[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) x[i] = lds4(a + 4 * i * LA + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 y[NT / 4];
#pragma unroll
      for (int g = 0; g < NT / 4; ++g) y[g] = lds4(b + (k + e) * LB + 32 * g);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          c[i][n] = fmaf(at(x[i], e), at(y[n / 4], n % 4), c[i][n]);
    }
  }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&x)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) x[i][j] = 0.f;
}

// the sum (or max) over the 8 lanes that share a row
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o *= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the columns [4 lb + 32 g, + 4) of a thread's row that are below `d`
template <int N>
__device__ __forceinline__ void store_row(float* row, const float (&c)[N],
                                          int lb, int d, float div = 1.f) {
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    const int col = 4 * lb + 32 * g;
    if (col < d)
      *reinterpret_cast<float4*>(row + col) =
          make_float4(c[4 * g] / div, c[4 * g + 1] / div, c[4 * g + 2] / div,
                      c[4 * g + 3] / div);
  }
}

// Tile shapes and shared memory (in floats) of one instance. Every row is
// padded by 4 floats. A warp owns BM / 8 query rows (forward, dq) or BK / 8
// keys (dk/dv) in every product of a step, so P and dS pass through shared
// memory between a warp's own two products with no block barrier.
template <int D, int DV>
struct Fwd {
  static constexpr int BM = 128, BN = D > 128 ? 48 : 64;
  static constexpr int LQ = D + 4, LV = DV + 4, LP = BN + 4;
  // a stage: K (BN x LQ), which P (BM x LP) overwrites once S is in, then V
  static constexpr int k_size = BN * LQ > BM * LP ? BN * LQ : BM * LP;
  static constexpr int stage = k_size + BN * LV;
  static constexpr int smem = (BM * LQ + 2 * stage) * 4;
};

template <int D, int DV>
struct Dq {
  static constexpr int BM = 128, BN = D > 128 ? 16 : 32;
  static constexpr int LQ = D + 4, LV = DV + 4, LS = BN + 4;
  static constexpr int o_off = BM * LQ, k_off = o_off + BM * LV,
                       stage = BN * (LQ + LV), s_off = k_off + 2 * stage,
                       l_off = s_off + BM * LS;
  static constexpr int smem = (l_off + 2 * BM) * 4;
};

template <int D, int DV>
struct Dkdv {
  static constexpr int BK = 128, BM = D > 128 ? 16 : 32;
  static constexpr int LQ = D + 4, LV = DV + 4, LP = BM + 4;
  // a stage: Q (BM x LQ), dO (BM x LV), lse (BM), delta (BM)
  static constexpr int v_off = BK * LQ, q_off = v_off + BK * LV,
                       stage = BM * (LQ + LV + 2),
                       p_off = q_off + 2 * stage;
  static constexpr int smem = (p_off + BK * LP) * 4;
};

// ---------------------------------------------------------------- forward --
// One block a (batch, query head, 128 positions), longest first; warp w
// takes rows [16 w, 16 w + 16). Each step: S = Q K^T (4 x BN / 8 a thread),
// the online softmax, P into K's place, O += P V (4 x DV / 8 a thread).
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(const Args a) {
  using C = Fwd<D, DV>;
  constexpr int BM = C::BM, BN = C::BN, LQ = C::LQ, LV = C::LV, LP = C::LP;
  constexpr int MT = BM / 32, NS = BN / 8, NO = DV / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* stages = smem + BM * LQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.n_rep;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int la = lane / 8, lb = lane % 8, wr = warp * (BM / 8);
  const int end = key_tiles(a, t0 * a.n_rep, min(t0 + BM, a.T) * a.n_rep, BN);

  load_rows<D>(sQ, LQ, BM, a.dqk, a.q.p, [&](int i) -> const float* {
    return t0 + i < a.T ? row_of<float>(a.q, b, t0 + i, h) : nullptr;
  });
  auto load_kv = [&](int j) {
    float* st = stages + (j & 1) * C::stage;
    const int k0 = j * BN;
    load_rows<D>(st, LQ, BN, a.dqk, a.k.p, [&](int i) -> const float* {
      return k0 + i < a.S ? row_of<float>(a.k, b, k0 + i, kvh) : nullptr;
    });
    load_rows<DV>(st + C::k_size, LV, BN, a.dvd, a.v.p,
                  [&](int i) -> const float* {
                    return k0 + i < a.S ? row_of<float>(a.v, b, k0 + i, kvh)
                                        : nullptr;
                  });
  };
  load_kv(0);
  cp_commit();

  int pos[MT];
  float m[MT], l[MT], o[MT][NO];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    pos[i] = a.q_start + t0 + wr + la + 4 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero(o);

  for (int j = 0; j < end; ++j) {
    cp_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if (j + 1 < end) {
      load_kv(j + 1);
      cp_commit();
    }
    float* sK = stages + (j & 1) * C::stage;
    const float* sV = sK + C::k_size;
    float s[MT][NS];
    zero(s);
    prod_nt<MT, NS, D, LQ, LQ>(s, sQ + (wr + la) * LQ, sK + lb * LQ);
    const bool edge = (a.causal && j * BN + BN - 1 > a.q_start + t0 + wr) ||
                      (j + 1) * BN > a.S;
    float alpha[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float x = s[i][n] * a.scale;
        if (edge) {
          const int key = j * BN + lb + 8 * n;
          if (key >= a.S) x = -INFINITY;  // past the end: not a key at all
          else if (a.causal && key > pos[i]) x = kNegInf;
        }
        s[i][n] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      alpha[i] = expf(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha[i];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[i][n] = expf(s[i][n] - mx);
        l[i] += s[i][n];
      }
    }
    __syncthreads();  // every warp is done with K: P takes its place
    float* sP = sK;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        sP[(wr + la + 4 * i) * LP + lb + 8 * n] = s[i][n];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NO; ++n) o[i][n] *= alpha[i];
    prod_nn<MT, NO, BN, LP, LV>(o, sP + (wr + la) * LP, sV + 4 * lb);
  }

  const int R = a.T * a.n_rep;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int t = t0 + wr + la + 4 * i;
    const float l_safe = fmaxf(row_sum(l[i]), 1e-37f);
    if (t >= a.T) continue;
    float* orow = static_cast<float*>(a.o) +
                  ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.dvd;
    store_row(orow, o[i], lb, a.dvd, l_safe);
    if (lb == 0)
      a.lse[(static_cast<long long>(b) * a.KV + kvh) * R +
            static_cast<long long>(t) * a.n_rep + h % a.n_rep] =
          m[i] + logf(l_safe);
  }
}

// --------------------------------------------------------------------- dq --
// One block a (batch, query head, 128 positions), longest first; warp w
// takes rows [16 w, 16 w + 16). First delta = rowsum(dO O) of the block's
// rows, written out for the dk/dv kernel; then each step of BN keys: S =
// Q K^T and dP = dO V^T (4 x BN / 8 a thread each), dS into shared
// memory, dQ += dS K (4 x D / 8 a thread).
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const Args a) {
  using C = Dq<D, DV>;
  constexpr int BM = C::BM, BN = C::BN, LQ = C::LQ, LV = C::LV, LS = C::LS;
  constexpr int MT = BM / 32, NS = BN / 8, NQ = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = smem + C::o_off;  // dO
  float* sS = smem + C::s_off;  // dS
  float* sL = smem + C::l_off;  // lse
  float* sD = sL + BM;          // delta
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.n_rep;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int la = lane / 8, lb = lane % 8, wr = warp * (BM / 8);
  const int R = a.T * a.n_rep;
  const long long lrow = (static_cast<long long>(b) * a.KV + kvh) * R;
  const int end = key_tiles(a, t0 * a.n_rep, min(t0 + BM, a.T) * a.n_rep, BN);

  load_rows<D>(sQ, LQ, BM, a.dqk, a.q.p, [&](int i) -> const float* {
    return t0 + i < a.T ? row_of<float>(a.q, b, t0 + i, h) : nullptr;
  });
  load_rows<DV>(sO, LV, BM, a.dvd, a.dout.p, [&](int i) -> const float* {
    return t0 + i < a.T ? row_of<float>(a.dout, b, t0 + i, h) : nullptr;
  });
  auto load_kv = [&](int j) {
    float* st = smem + C::k_off + (j & 1) * C::stage;
    const int k0 = j * BN;
    load_rows<D>(st, LQ, BN, a.dqk, a.k.p, [&](int i) -> const float* {
      return k0 + i < a.S ? row_of<float>(a.k, b, k0 + i, kvh) : nullptr;
    });
    load_rows<DV>(st + BN * LQ, LV, BN, a.dvd, a.v.p,
                  [&](int i) -> const float* {
                    return k0 + i < a.S ? row_of<float>(a.v, b, k0 + i, kvh)
                                        : nullptr;
                  });
  };
  load_kv(0);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // delta of the block's rows, kThreads / BM threads a row, from dO in
  // shared memory and O in global memory; lse beside it (p = 0 past T)
  {
    constexpr int TPR = kThreads / BM;
    const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, t = t0 + r;
    float sum = 0.f;
    if (t < a.T) {
      const float* orow =
          static_cast<const float*>(a.out) +
          ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.dvd;
      for (int c = 4 * part; c < a.dvd; c += 4 * TPR) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = lds4(sO + r * LV + c);
        sum = fmaf(y.x, x.x, sum);
        sum = fmaf(y.y, x.y, sum);
        sum = fmaf(y.z, x.z, sum);
        sum = fmaf(y.w, x.w, sum);
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0) {
      const long long i = lrow + static_cast<long long>(t) * a.n_rep +
                          h % a.n_rep;
      sD[r] = sum;
      sL[r] = t < a.T ? a.lse[i] : INFINITY;
      if (t < a.T) a.delta[i] = sum;
    }
  }
  __syncthreads();

  int pos[MT];
  float lse[MT], delta[MT], dq[MT][NQ];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = wr + la + 4 * i;
    pos[i] = a.q_start + t0 + r;
    lse[i] = sL[r];
    delta[i] = sD[r];
  }
  zero(dq);

  for (int j = 0; j < end; ++j) {
    if (j > 0) {
      cp_wait_all();
      __syncthreads();  // tile j is in; every warp is done with tile j - 1
    }
    if (j + 1 < end) {
      load_kv(j + 1);
      cp_commit();
    }
    const float* sK = smem + C::k_off + (j & 1) * C::stage;
    const float* sV = sK + BN * LQ;
    float s[MT][NS], dp[MT][NS];
    zero(s);
    zero(dp);
    prod_nt2<MT, NS, D, DV, LQ, LV>(s, sQ + (wr + la) * LQ, sK + lb * LQ, dp,
                                    sO + (wr + la) * LV, sV + lb * LV);
    const bool edge = (a.causal && j * BN + BN - 1 > a.q_start + t0 + wr) ||
                      (j + 1) * BN > a.S;
    __syncwarp();  // the warp is done reading the last step's dS
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float x = s[i][n] * a.scale;
        bool gone = false;
        if (edge) {
          const int key = j * BN + lb + 8 * n;
          gone = key >= a.S;
          if (a.causal && key > pos[i]) x = kNegInf;
        }
        const float p = gone ? 0.f : expf(x - lse[i]);
        sS[(wr + la + 4 * i) * LS + lb + 8 * n] =
            p * (dp[i][n] - delta[i]) * a.scale;
      }
    __syncwarp();
    prod_nn<MT, NQ, BN, LS, LQ>(dq, sS + (wr + la) * LS, sK + 4 * lb);
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int t = t0 + wr + la + 4 * i;
    if (t >= a.T) continue;
    store_row(static_cast<float*>(a.dq) +
                  ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.dqk,
              dq[i], lb, a.dqk);
  }
}

// ------------------------------------------------------------------ dk/dv --
// One block a (batch, kv head, 128 keys), the first keys first (they see
// the most rows); warp w takes keys [16 w, 16 w + 16). It walks every
// (query tile, query head of the group) that sees its keys, BM rows a step,
// with Q, dO, lse and delta double-buffered: S^T = K Q^T and dP^T = V dO^T
// (4 x BM / 8 a thread each), P^T into shared memory, dV += P^T dO, then
// dS^T in P^T's place, dK += dS^T Q (4 x DV / 8 and 4 x D / 8 a thread).
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(const Args a) {
  using C = Dkdv<D, DV>;
  constexpr int BK = C::BK, BM = C::BM, LQ = C::LQ, LV = C::LV, LP = C::LP;
  constexpr int MT = BK / 32, NS = BM / 8, NK = D / 8, NV = DV / 8;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + C::v_off;
  float* sP = smem + C::p_off;  // P^T, then dS^T
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int la = lane / 8, lb = lane % 8, wk = warp * (BK / 8);
  const int R = a.T * a.n_rep;
  const long long lrow = (static_cast<long long>(b) * a.KV + kvh) * R;
  // the query tiles that see these keys: positions t >= k0 - q_start when
  // causal and every row sees key 0; a row that sees no key (q_start < 0)
  // has p = 1 on every key, so then all of them
  const int n_t = (a.T + BM - 1) / BM;
  int start = 0;
  if (a.causal && a.q_start >= 0 && k0 - a.q_start > 0)
    start = min((k0 - a.q_start) / BM, n_t);
  const int steps = (n_t - start) * a.n_rep;

  load_rows<D>(sK, LQ, BK, a.dqk, a.k.p, [&](int i) -> const float* {
    return k0 + i < a.S ? row_of<float>(a.k, b, k0 + i, kvh) : nullptr;
  });
  load_rows<DV>(sV, LV, BK, a.dvd, a.v.p, [&](int i) -> const float* {
    return k0 + i < a.S ? row_of<float>(a.v, b, k0 + i, kvh) : nullptr;
  });
  // step u: query head kvh * n_rep + u % n_rep, positions from tq0(u); a
  // row past T reads zeros everywhere (lse and delta too), so it adds
  // exactly 0 to dK and dV
  auto tq0 = [&](int u) { return (start + u / a.n_rep) * BM; };
  auto load_q = [&](int u) {
    float* st = smem + C::q_off + (u & 1) * C::stage;
    const int r = u % a.n_rep, hq = kvh * a.n_rep + r, t = tq0(u);
    load_rows<D>(st, LQ, BM, a.dqk, a.q.p, [&](int i) -> const float* {
      return t + i < a.T ? row_of<float>(a.q, b, t + i, hq) : nullptr;
    });
    float* so = st + BM * LQ;
    load_rows<DV>(so, LV, BM, a.dvd, a.dout.p, [&](int i) -> const float* {
      return t + i < a.T ? row_of<float>(a.dout, b, t + i, hq) : nullptr;
    });
    float* sl = so + BM * LV;
    for (int x = threadIdx.x; x < BM; x += kThreads) {
      const bool ok = t + x < a.T;
      const long long i = lrow + static_cast<long long>(t + x) * a.n_rep + r;
      cp4(sl + x, ok ? a.lse + i : a.lse, ok);
      cp4(sl + BM + x, ok ? a.delta + i : a.delta, ok);
    }
  };
  if (steps > 0) load_q(0);
  cp_commit();

  // this thread's keys k0 + wk + la + 4 i; key kr is masked for the row at
  // position p when kr > p. A key past S is computed and never stored.
  float dk[MT][NK], dv[MT][NV];
  zero(dk);
  zero(dv);
  const int key_hi = k0 + wk + BK / 8 - 1;  // the warp's last key
  for (int u = 0; u < steps; ++u) {
    cp_wait_all();
    __syncthreads();  // step u is in; every warp is done with step u - 1
    if (u + 1 < steps) {
      load_q(u + 1);
      cp_commit();
    }
    const float* sQ = smem + C::q_off + (u & 1) * C::stage;
    const float* sO = sQ + BM * LQ;
    const float* sL = sO + BM * LV;
    const float* sD = sL + BM;
    const int p0 = a.q_start + tq0(u);  // the first row's position
    float st[MT][NS], dpt[MT][NS];
    zero(st);
    zero(dpt);
    prod_nt2<MT, NS, D, DV, LQ, LV>(st, sK + (wk + la) * LQ, sQ + lb * LQ,
                                    dpt, sV + (wk + la) * LV, sO + lb * LV);
    const bool edge = a.causal && key_hi > p0;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = lb + 8 * n;
        float x = st[i][n] * a.scale;
        if (edge && k0 + wk + la + 4 * i > p0 + c) x = kNegInf;
        const float p = expf(x - sL[c]);
        st[i][n] = p;
        dpt[i][n] = p * (dpt[i][n] - sD[c]) * a.scale;  // dS^T
        sP[(wk + la + 4 * i) * LP + c] = p;
      }
    __syncwarp();
    prod_nn<MT, NV, BM, LP, LV>(dv, sP + (wk + la) * LP, sO + 4 * lb);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        sP[(wk + la + 4 * i) * LP + lb + 8 * n] = dpt[i][n];
    __syncwarp();
    prod_nn<MT, NK, BM, LP, LQ>(dk, sP + (wk + la) * LP, sQ + 4 * lb);
  }
  cp_wait_all();  // no step: the first copy is still in flight

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int key = k0 + wk + la + 4 * i;
    if (key >= a.S) continue;
    const long long base = (static_cast<long long>(b) * a.S + key) * a.KV + kvh;
    store_row(static_cast<float*>(a.dk) + base * a.dqk, dk[i], lb, a.dqk);
    store_row(static_cast<float*>(a.dv) + base * a.dvd, dv[i], lb, a.dvd);
  }
}

// ---------------------------------------------------------------- launch --
template <typename K>
cudaError_t run(K kernel, const Args& a, dim3 grid, int smem,
                cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_fwd(const Args& a, cudaStream_t st) {
  using C = Fwd<D, DV>;
  return run(fwd_kernel<D, DV>, a, dim3((a.T + C::BM - 1) / C::BM, a.H, a.B),
             C::smem, st);
}

// two launches: dq (which writes delta), then dk/dv (which reads it)
template <int D, int DV>
cudaError_t launch_bwd(const Args& a, cudaStream_t st) {
  using Q = Dq<D, DV>;
  using K = Dkdv<D, DV>;
  cudaError_t e = run(dq_kernel<D, DV>, a,
                      dim3((a.T + Q::BM - 1) / Q::BM, a.H, a.B), Q::smem, st);
  if (e != cudaSuccess) return e;
  return run(dkdv_kernel<D, DV>, a, dim3((a.S + K::BK - 1) / K::BK, a.KV, a.B),
             K::smem, st);
}

}  // namespace cc


// ============================================= the wgmma route (bf16) ==
namespace wg {

constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = 384;    // and one producer warpgroup

// The TMA maps of one launch and its arguments, a __grid_constant__
// parameter (a map must live in parameter, constant or global memory).
struct Params {
  CUtensorMap q, k, v, dout;
  Args a;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p: a swizzle atom's alignment
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------ mbarriers --
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the barrier's phase of parity `parity` has completed; a wait of
// more than about ten seconds (a copy that never lands) traps, so a fault
// ends the launch with an error instead of holding the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// a 64-column box of a 4-D map at (column, head, position, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------- wgmma --
// A shared memory operand in the 128-byte swizzle TMA writes: rows of 128
// bytes (64 bf16), 8-row groups 1024 bytes apart (SBO); `lbo` is the byte
// distance between 64-column boxes, read for an MN-major operand wider
// than one box (a K-major one passes 16, unused).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// k-step k (16 columns) of a K-major tile whose boxes are `box` bytes apart
__device__ __forceinline__ const unsigned char* kstep(const unsigned char* t,
                                                      int k, int box) {
  return t + (k / 4) * box + (k % 4) * 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers a wgmma in flight reads or writes: this orders every later
// use after the wait that precedes it, and keeps an A fragment alive
// until then.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// "+f" operands d[i] .. d[i + n - 1]
#define FA_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D16(i) FA_D8(i), FA_D8(i + 8)
#define FA_D32(i) FA_D16(i), FA_D16(i + 16)
#define FA_D64(i) FA_D32(i), FA_D32(i + 32)
#define FA_D96(i) FA_D64(i), FA_D32(i + 64)

// d (64 x N, f32) = (acc ? d : 0) + A . B^T, both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);

// d (64 x N) += A . B: A bf16 fragments in registers (16 columns of k), B
// (16 x N) MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : FA_D16(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D64(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : FA_D96(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_D8
#undef FA_D16
#undef FA_D32
#undef FA_D64
#undef FA_D96

// The bf16 A fragments of a 64 x N accumulator (N / 16 steps of k), each
// value rounded to nearest even: the C layout of two n8 tiles is the A
// layout of one k16 step.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&c)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    a[k][0] = pack_bf16(c[8 * k], c[8 * k + 1]);
    a[k][1] = pack_bf16(c[8 * k + 2], c[8 * k + 3]);
    a[k][2] = pack_bf16(c[8 * k + 4], c[8 * k + 5]);
    a[k][3] = pack_bf16(c[8 * k + 6], c[8 * k + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Shared memory of one (kernel, qk dim, v dim): byte offsets of its tiles,
// each a whole number of 1024-byte swizzle atoms, then the mbarriers.
template <int D, int DV>
struct Fwd {
  static constexpr int BM = 128, BN = 128;        // rows, keys
  static constexpr int NS = D + DV > 256 ? 2 : 3;  // stages: 225 KB at d 128
  static constexpr int QB = D / 64, VB = DV / 64;  // 64-column boxes
  static constexpr int q_bytes = BM * D * 2, k_bytes = BN * D * 2,
                       v_bytes = BN * DV * 2;
  static constexpr int k_off = q_bytes, v_off = k_off + NS * k_bytes,
                       bar_off = v_off + NS * v_bytes;
  static constexpr int smem = bar_off + 128 + 1024;
};

template <int D, int DV>
struct Dq {
  static constexpr int BM = 128, BN = 64, NS = 2;
  static constexpr int QB = D / 64, VB = DV / 64;
  static constexpr int q_bytes = BM * D * 2, o_bytes = BM * DV * 2,
                       k_bytes = BN * D * 2, v_bytes = BN * DV * 2;
  static constexpr int o_off = q_bytes, k_off = o_off + o_bytes,
                       v_off = k_off + NS * k_bytes,
                       bar_off = v_off + NS * v_bytes;
  static constexpr int smem = bar_off + 64 + 1024;
};

template <int D, int DV>
struct Dkdv {
  static constexpr int BK = 128;                     // keys a block
  static constexpr int BM = D + DV > 256 ? 32 : 64;  // query rows a step
  static constexpr int NS = 2;
  static constexpr int QB = D / 64, VB = DV / 64;
  static constexpr int k_bytes = BK * D * 2, v_bytes = BK * DV * 2,
                       q_bytes = BM * D * 2, o_bytes = BM * DV * 2;
  static constexpr int v_off = k_bytes, q_off = v_off + v_bytes,
                       o_off = q_off + NS * q_bytes,
                       l_off = o_off + NS * o_bytes,  // lse, delta: f32
                       bar_off = l_off + NS * BM * 8;
  static constexpr int smem = bar_off + 64 + 1024;
};

// ---------------------------------------------------------------- forward --
// One block a (batch, query head, 128 positions); consumer warpgroup w
// takes positions [64 w, 64 w + 64) of them.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ Params p) {
  using C = Fwd<D, DV>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::NS;
  const Args& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + C::bar_off);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + NS;
  uint64_t* empty_k = full_v + NS;  // K is free once S is in, V after P V
  uint64_t* empty_v = empty_k + NS;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.n_rep;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest first
  const int end = key_tiles(a, t0 * a.n_rep, min(t0 + BM, a.T) * a.n_rep, BN);
  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      bar_init(full_k + s, 1);
      bar_init(full_v + s, 1);
      bar_init(empty_k + s, 8);  // a consumer warp each
      bar_init(empty_v + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer
    regs_dec<24>();
    if (threadIdx.x == kConsumers) {
      bar_expect(bar_q, C::q_bytes);
      for (int i = 0; i < C::QB; ++i)
        tma_load(sm + i * BM * 128, &p.q, bar_q, i * 64, h, t0, b);
      for (int j = 0; j < end; ++j) {
        const int s = j % NS;
        if (j >= NS) bar_wait(empty_k + s, (j / NS - 1) & 1);
        bar_expect(full_k + s, C::k_bytes);
        for (int i = 0; i < C::QB; ++i)
          tma_load(sm + C::k_off + s * C::k_bytes + i * BN * 128, &p.k,
                   full_k + s, i * 64, kvh, j * BN, b);
        if (j >= NS) bar_wait(empty_v + s, (j / NS - 1) & 1);
        bar_expect(full_v + s, C::v_bytes);
        for (int i = 0; i < C::VB; ++i)
          tma_load(sm + C::v_off + s * C::v_bytes + i * BN * 128, &p.v,
                   full_v + s, i * 64, kvh, j * BN, b);
      }
    }
    return;
  }

  regs_inc<240>();
  const int w = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row0 = t0 + 64 * w;             // this warpgroup's first row
  const int tr = row0 + 16 * warp + g;      // this thread's rows tr, tr + 8
  const int pos[2] = {a.q_start + tr, a.q_start + tr + 8};
  const unsigned char* sQ = sm + w * 64 * 128;
  float o[DV / 2], sc[BN / 2];
  uint32_t pa[BN / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  zero(o);

  auto qk = [&](int j) {  // S = Q K_j^T
    const unsigned char* kt = sm + C::k_off + (j % NS) * C::k_bytes;
    wg_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss<BN>(sc, desc(kstep(sQ, k, BM * 128), 16),
                   desc(kstep(kt, k, BN * 128), 16), k > 0);
    wg_commit();
  };
  auto pv = [&](int j) {  // O += P_j V_j
    const unsigned char* vt = sm + C::v_off + (j % NS) * C::v_bytes;
    wg_fence();
#pragma unroll
    for (int k = 0; k < BN / 16; ++k)
      wgmma_rs<DV>(o, pa[k], desc(vt + k * 16 * 128, BN * 128));
    wg_commit();
  };
  // the online softmax of tile j's scores: new m and l, P (f32) in place
  // of S, and the factor O's sum must take
  auto softmax = [&](int j) {
    float mx[2] = {m[0], m[1]};
    const bool edge = (a.causal && j * BN + BN - 1 > a.q_start + row0) ||
                      (j + 1) * BN > a.S;
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * BN + i * 8 + 2 * tq + (e & 1);
          float x = sc[4 * i + e] * a.scale;
          if (key >= a.S) x = -INFINITY;  // past the end: not a key at all
          else if (a.causal && key > pos[e >> 1]) x = kNegInf;
          sc[4 * i + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] *= a.scale;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = __expf(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
  };

  bar_wait(bar_q, 0);
  bar_wait(full_k, 0);
  qk(0);
  wg_wait<0>();
  keep(sc);
  if (lane == 0) bar_arrive(empty_k);
  softmax(0);
  to_a<BN>(pa, sc);
  for (int j = 1; j < end; ++j) {
    bar_wait(full_k + j % NS, (j / NS) & 1);
    bar_wait(full_v + (j - 1) % NS, ((j - 1) / NS) & 1);
    keep(o);
    keep(pa);
    qk(j);
    pv(j - 1);
    wg_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
    keep(sc);
    if (lane == 0) bar_arrive(empty_k + j % NS);
    softmax(j);
    wg_wait<0>();
    keep(o);
    keep(pa);
    if (lane == 0) bar_arrive(empty_v + (j - 1) % NS);
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P's bf16 fragments only now: defined while P_{j-1} V_{j-1} still ran,
    // they could take the registers it reads, and ptxas would serialize
    // the products (no overlap of the softmax with P V)
    to_a<BN>(pa, sc);
  }
  bar_wait(full_v + (end - 1) % NS, ((end - 1) / NS) & 1);
  keep(o);
  keep(pa);
  pv(end - 1);
  wg_wait<0>();
  keep(o);
  keep(pa);

  const int R = a.T * a.n_rep;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tr + 8 * r;
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-37f);
    if (t >= a.T) continue;
    bf16* orow = static_cast<bf16*>(a.o) +
                 ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.dvd;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = i * 8 + 2 * tq;
      if (col < a.dvd)
        store2(orow + col, o[4 * i + 2 * r] / l_safe,
               o[4 * i + 2 * r + 1] / l_safe);
    }
    if (tq == 0)
      a.lse[(static_cast<long long>(b) * a.KV + kvh) * R +
            static_cast<long long>(t) * a.n_rep + h % a.n_rep] =
          m[r] + logf(l_safe);
  }
}

// --------------------------------------------------------------------- dq --
// One block a (batch, query head, 128 positions): delta of its rows, then
// the key tiles, 64 keys a step; dq in registers.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ Params p) {
  using C = Dq<D, DV>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::NS;
  const Args& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + C::bar_off);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + NS;
  uint64_t* empty = full_v + NS;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.n_rep;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest first
  const int end = key_tiles(a, t0 * a.n_rep, min(t0 + BM, a.T) * a.n_rep, BN);
  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      bar_init(full_k + s, 1);
      bar_init(full_v + s, 1);
      bar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    regs_dec<24>();
    if (threadIdx.x == kConsumers) {
      bar_expect(bar_q, C::q_bytes + C::o_bytes);
      for (int i = 0; i < C::QB; ++i)
        tma_load(sm + i * BM * 128, &p.q, bar_q, i * 64, h, t0, b);
      for (int i = 0; i < C::VB; ++i)
        tma_load(sm + C::o_off + i * BM * 128, &p.dout, bar_q, i * 64, h, t0,
                 b);
      for (int j = 0; j < end; ++j) {
        const int s = j % NS;
        if (j >= NS) bar_wait(empty + s, (j / NS - 1) & 1);
        bar_expect(full_k + s, C::k_bytes);
        for (int i = 0; i < C::QB; ++i)
          tma_load(sm + C::k_off + s * C::k_bytes + i * BN * 128, &p.k,
                   full_k + s, i * 64, kvh, j * BN, b);
        bar_expect(full_v + s, C::v_bytes);
        for (int i = 0; i < C::VB; ++i)
          tma_load(sm + C::v_off + s * C::v_bytes + i * BN * 128, &p.v,
                   full_v + s, i * 64, kvh, j * BN, b);
      }
    }
    return;
  }

  regs_inc<240>();
  const int w = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row0 = t0 + 64 * w;
  const int tr = row0 + 16 * warp + g;
  const int pos[2] = {a.q_start + tr, a.q_start + tr + 8};
  const int R = a.T * a.n_rep;
  const long long lrow = (static_cast<long long>(b) * a.KV + kvh) * R;

  // delta = rowsum(dO * O) of this warpgroup's 64 rows, two threads a row
  // (row 16 warp + lane / 2), 16 bytes a load; written out for the dk/dv
  // kernel, and read back by shuffle for the rows this thread holds
  float delta[2], lse[2];
  {
    const int t = row0 + 16 * warp + lane / 2;
    float sum = 0.f;
    if (t < a.T) {
      const bf16* orow = static_cast<const bf16*>(a.out) +
                         ((static_cast<long long>(b) * a.T + t) * a.H + h) *
                             a.dvd;
      const bf16* drow = row_of<bf16>(a.dout, b, t, h);
      for (int c = (lane % 2) * 8; c < a.dvd; c += 16) {
        const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
        const bf16* xo = reinterpret_cast<const bf16*>(&x);
        const bf16* yd = reinterpret_cast<const bf16*>(&y);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum += __bfloat162float(yd[e]) * __bfloat162float(xo[e]);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (lane % 2 == 0 && t < a.T)
      a.delta[lrow + static_cast<long long>(t) * a.n_rep + h % a.n_rep] = sum;
    delta[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    delta[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tt = tr + 8 * r;  // p = 0 off the end
      lse[r] = tt < a.T ? a.lse[lrow + static_cast<long long>(tt) * a.n_rep +
                                h % a.n_rep]
                        : INFINITY;
    }
  }

  const unsigned char* sQ = sm + w * 64 * 128;
  const unsigned char* sO = sm + C::o_off + w * 64 * 128;
  float dq[D / 2], sc[BN / 2], dp[BN / 2];
  uint32_t da[BN / 16][4];
  zero(dq);
  bar_wait(bar_q, 0);
  for (int j = 0; j < end; ++j) {
    const int s = j % NS, par = (j / NS) & 1;
    const unsigned char* kt = sm + C::k_off + s * C::k_bytes;
    const unsigned char* vt = sm + C::v_off + s * C::v_bytes;
    bar_wait(full_k + s, par);
    wg_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)  // S = Q K^T
      wgmma_ss<BN>(sc, desc(kstep(sQ, k, BM * 128), 16),
                   desc(kstep(kt, k, BN * 128), 16), k > 0);
    wg_commit();
    bar_wait(full_v + s, par);
    wg_fence();
#pragma unroll
    for (int k = 0; k < DV / 16; ++k)  // dP = dO V^T
      wgmma_ss<BN>(dp, desc(kstep(sO, k, BM * 128), 16),
                   desc(kstep(vt, k, BN * 128), 16), k > 0);
    wg_commit();
    wg_wait<0>();
    keep(sc);
    keep(dp);
    const bool edge = (a.causal && j * BN + BN - 1 > a.q_start + row0) ||
                      (j + 1) * BN > a.S;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * a.scale;
        bool gone = false;
        if (edge) {
          const int key = j * BN + i * 8 + 2 * tq + (e & 1);
          gone = key >= a.S;
          if (a.causal && key > pos[e >> 1]) x = kNegInf;
        }
        const float pr = gone ? 0.f : __expf(x - lse[e >> 1]);
        sc[4 * i + e] = pr * (dp[4 * i + e] - delta[e >> 1]) * a.scale;
      }
    to_a<BN>(da, sc);
    wg_fence();
#pragma unroll
    for (int k = 0; k < BN / 16; ++k)  // dQ += dS K
      wgmma_rs<D>(dq, da[k], desc(kt + k * 16 * 128, BN * 128));
    wg_commit();
    wg_wait<0>();
    keep(dq);
    keep(da);
    if (lane == 0) bar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tr + 8 * r;
    if (t >= a.T) continue;
    bf16* row = static_cast<bf16*>(a.dq) +
                ((static_cast<long long>(b) * a.T + t) * a.H + h) * a.dqk;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + 2 * tq;
      if (col < a.dqk)
        store2(row + col, dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ dk/dv --
// One block a (batch, kv head, 128 keys), consumer warpgroup w taking keys
// [64 w, 64 w + 64); it walks every (query tile, query head of the group)
// that sees its keys, BM rows a step, with dk and dv in registers.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const __grid_constant__ Params p) {
  using C = Dkdv<D, DV>;
  constexpr int BK = C::BK, BM = C::BM, NS = C::NS;
  const Args& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  float* sL = reinterpret_cast<float*>(sm + C::l_off);  // lse: NS x BM
  float* sD = sL + NS * BM;                             // delta: NS x BM
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + C::bar_off);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + NS;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;  // the first keys see the most rows
  const int R = a.T * a.n_rep;
  const long long lrow = (static_cast<long long>(b) * a.KV + kvh) * R;
  // the query tiles that see these keys: positions t >= k0 - q_start when
  // causal and every row sees key 0; a row that sees no key (q_start < 0)
  // has p = 1 on every key, so then all of them
  const int n_t = (a.T + BM - 1) / BM;
  int start = 0;
  if (a.causal && a.q_start >= 0 && k0 - a.q_start > 0)
    start = min((k0 - a.q_start) / BM, n_t);
  const int steps = (n_t - start) * a.n_rep;
  if (threadIdx.x == 0) {
    bar_init(bar_kv, 1);
    for (int s = 0; s < NS; ++s) {
      bar_init(full + s, 32);  // the producer warp's lanes
      bar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    regs_dec<24>();
    if (threadIdx.x < kConsumers + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        bar_expect(bar_kv, C::k_bytes + C::v_bytes);
        for (int i = 0; i < C::QB; ++i)
          tma_load(sm + i * BK * 128, &p.k, bar_kv, i * 64, kvh, k0, b);
        for (int i = 0; i < C::VB; ++i)
          tma_load(sm + C::v_off + i * BK * 128, &p.v, bar_kv, i * 64, kvh,
                   k0, b);
      }
      for (int u = 0; u < steps; ++u) {
        const int s = u % NS, r = u % a.n_rep;
        const int tq0 = (start + u / a.n_rep) * BM, hq = kvh * a.n_rep + r;
        if (u >= NS) bar_wait(empty + s, (u / NS - 1) & 1);
        for (int x = lane; x < BM; x += 32) {
          const int t = tq0 + x;
          const long long i = lrow + static_cast<long long>(t) * a.n_rep + r;
          sL[s * BM + x] = t < a.T ? a.lse[i] : INFINITY;  // p = 0
          sD[s * BM + x] = t < a.T ? a.delta[i] : 0.f;
        }
        if (lane == 0) {
          bar_expect(full + s, C::q_bytes + C::o_bytes);
          unsigned char* qt = sm + C::q_off + s * C::q_bytes;
          unsigned char* ot = sm + C::o_off + s * C::o_bytes;
          for (int i = 0; i < C::QB; ++i)
            tma_load(qt + i * BM * 128, &p.q, full + s, i * 64, hq, tq0, b);
          for (int i = 0; i < C::VB; ++i)
            tma_load(ot + i * BM * 128, &p.dout, full + s, i * 64, hq, tq0,
                     b);
        } else {
          bar_arrive(full + s);
        }
      }
    }
    return;
  }

  regs_inc<240>();
  const int w = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int key0 = k0 + 64 * w;            // this warpgroup's first key
  const int kr = key0 + 16 * warp + g;     // this thread's keys kr, kr + 8
  const unsigned char* sK = sm + w * 64 * 128;
  const unsigned char* sV = sm + C::v_off + w * 64 * 128;
  float dk[D / 2], dv[DV / 2], st[BM / 2], dpt[BM / 2];
  uint32_t pa[BM / 16][4], da[BM / 16][4];
  zero(dk);
  zero(dv);
  bar_wait(bar_kv, 0);
  for (int u = 0; u < steps; ++u) {
    const int s = u % NS;
    const int tq0 = (start + u / a.n_rep) * BM;
    const unsigned char* qt = sm + C::q_off + s * C::q_bytes;
    const unsigned char* ot = sm + C::o_off + s * C::o_bytes;
    const float* lb = sL + s * BM;
    const float* db = sD + s * BM;
    bar_wait(full + s, (u / NS) & 1);
    wg_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)  // S^T = K Q^T
      wgmma_ss<BM>(st, desc(kstep(sK, k, BK * 128), 16),
                   desc(kstep(qt, k, BM * 128), 16), k > 0);
#pragma unroll
    for (int k = 0; k < DV / 16; ++k)  // dP^T = V dO^T
      wgmma_ss<BM>(dpt, desc(kstep(sV, k, BK * 128), 16),
                   desc(kstep(ot, k, BM * 128), 16), k > 0);
    wg_commit();
    wg_wait<0>();
    keep(st);
    keep(dpt);
    // row t of the tile sees key kr iff kr <= q_start + t
    const bool edge = a.causal && a.q_start + tq0 < key0 + 63;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = i * 8 + 2 * tq + (e & 1);
        float x = st[4 * i + e] * a.scale;
        if (edge && kr + 8 * (e >> 1) > a.q_start + tq0 + c) x = kNegInf;
        const float pr = __expf(x - lb[c]);
        st[4 * i + e] = pr;
        dpt[4 * i + e] = pr * (dpt[4 * i + e] - db[c]) * a.scale;  // dS^T
      }
    to_a<BM>(pa, st);
    to_a<BM>(da, dpt);
    wg_fence();
#pragma unroll
    for (int k = 0; k < BM / 16; ++k)  // dV += P^T dO
      wgmma_rs<DV>(dv, pa[k], desc(ot + k * 16 * 128, BM * 128));
#pragma unroll
    for (int k = 0; k < BM / 16; ++k)  // dK += dS^T Q
      wgmma_rs<D>(dk, da[k], desc(qt + k * 16 * 128, BM * 128));
    wg_commit();
    wg_wait<0>();
    keep(dv);
    keep(dk);
    keep(pa);
    keep(da);
    if (lane == 0) bar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr + 8 * r;
    if (key >= a.S) continue;
    const long long base = (static_cast<long long>(b) * a.S + key) * a.KV + kvh;
    bf16* krow = static_cast<bf16*>(a.dk) + base * a.dqk;
    bf16* vrow = static_cast<bf16*>(a.dv) + base * a.dvd;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + 2 * tq;
      if (col < a.dqk)
        store2(krow + col, dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
    }
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = i * 8 + 2 * tq;
      if (col < a.dvd)
        store2(vrow + col, dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch --
// A 4-D map over a (B, L, heads, d) bf16 tensor read through its element
// strides, as (d, heads, L, B): boxes of 64 columns by `rows` positions of
// one head, 128-byte swizzled, zeros past every edge. A dim of size 1 gets
// a stride that is a multiple of 16 bytes (it is never stepped).
bool make_map(CUtensorMap* map, const View& v, int d, int heads, int len,
              int batch, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const long long el[3] = {v.sh, v.sl, v.sb};
  cuuint64_t strides[3];
  cuuint64_t span = dims[0] * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? static_cast<cuuint64_t>(el[i]) * 2
                                 : (span + 15) / 16 * 16;
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(v.p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t run(K kernel, const Params& p, dim3 grid, int smem,
                cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_fwd(const Args& a, cudaStream_t st) {
  using C = Fwd<D, DV>;
  Params p;
  p.a = a;
  if (!make_map(&p.q, a.q, a.dqk, a.H, a.T, a.B, C::BM) ||
      !make_map(&p.k, a.k, a.dqk, a.KV, a.S, a.B, C::BN) ||
      !make_map(&p.v, a.v, a.dvd, a.KV, a.S, a.B, C::BN))
    return cudaErrorInvalidValue;
  return run(fwd_kernel<D, DV>, p, dim3((a.T + C::BM - 1) / C::BM, a.H, a.B),
             C::smem, st);
}

// two launches: dq (which writes delta), then dk/dv (which reads it)
template <int D, int DV>
cudaError_t launch_bwd(const Args& a, cudaStream_t st) {
  using Q = Dq<D, DV>;
  using K = Dkdv<D, DV>;
  Params p;
  p.a = a;
  if (!make_map(&p.q, a.q, a.dqk, a.H, a.T, a.B, Q::BM) ||
      !make_map(&p.dout, a.dout, a.dvd, a.H, a.T, a.B, Q::BM) ||
      !make_map(&p.k, a.k, a.dqk, a.KV, a.S, a.B, Q::BN) ||
      !make_map(&p.v, a.v, a.dvd, a.KV, a.S, a.B, Q::BN))
    return cudaErrorInvalidValue;
  cudaError_t e = run(dq_kernel<D, DV>, p,
                      dim3((a.T + Q::BM - 1) / Q::BM, a.H, a.B), Q::smem, st);
  if (e != cudaSuccess) return e;
  if (!make_map(&p.q, a.q, a.dqk, a.H, a.T, a.B, K::BM) ||
      !make_map(&p.dout, a.dout, a.dvd, a.H, a.T, a.B, K::BM) ||
      !make_map(&p.k, a.k, a.dqk, a.KV, a.S, a.B, K::BK) ||
      !make_map(&p.v, a.v, a.dvd, a.KV, a.S, a.B, K::BK))
    return cudaErrorInvalidValue;
  return run(dkdv_kernel<D, DV>, p,
             dim3((a.S + K::BK - 1) / K::BK, a.KV, a.B), K::smem, st);
}

}  // namespace wg

// ---------------------------------------------------------------- launch --
// the wrapper's route codes (kernels/flash_attention.py, ROUTE_CODES)
enum Route { kCudaCores = 0, kWgmma = 1 };

// the (qk, v) instances of both routes; kernels/flash_attention.py's
// INSTANCES names the same (a smaller bucket runs on 64/64, zero-padded:
// by TMA on wgmma, by cp.async's zero fill on the CUDA cores)
#define FA_INSTANCES(X) X(64, 64) X(128, 128) X(192, 128)

cudaError_t dispatch(const Args& a, Route route, int bd, int bdv, bool bwd,
                     cudaStream_t st) {
  // the grid is (tiles, heads, batch): a head's tiles run side by side and
  // share its K and V in L2 (ordering every head's longest tile first
  // instead reads the whole K and V from memory, 12% slower on wgmma)
  if (a.H > 65535) return cudaErrorInvalidValue;
#define FA_CASE(d, dv)                                                \
  if (bd == d && bdv == dv) {                                         \
    if (route == kWgmma)                                              \
      return bwd ? wg::launch_bwd<d, dv>(a, st)                       \
                 : wg::launch_fwd<d, dv>(a, st);                      \
    return bwd ? cc::launch_bwd<d, dv>(a, st)                         \
               : cc::launch_fwd<d, dv>(a, st);                        \
  }
  FA_INSTANCES(FA_CASE)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

// ints: B, T, S, H, KV, dqk, dv, q_start, causal, bucket qk, bucket v,
// then the element strides (batch, seq, head) of q, k, v and dout, then
// the route. ptrs: q, k, v, dout, out, lse, delta, o, dq, dk, dv (unused
// ones null).
int launch(void* const* ptrs, const long long* n, float scale, int dtype,
           bool bwd, void* stream) {
  Args a;
  const long long* s = n + 11;
  a.q = View{ptrs[0], s[0], s[1], s[2]};
  a.k = View{ptrs[1], s[3], s[4], s[5]};
  a.v = View{ptrs[2], s[6], s[7], s[8]};
  a.dout = View{ptrs[3], s[9], s[10], s[11]};
  a.out = ptrs[4];
  a.lse = static_cast<float*>(ptrs[5]);
  a.delta = static_cast<float*>(ptrs[6]);
  a.o = ptrs[7];
  a.dq = ptrs[8];
  a.dk = ptrs[9];
  a.dv = ptrs[10];
  a.B = static_cast<int>(n[0]);
  a.T = static_cast<int>(n[1]);
  a.S = static_cast<int>(n[2]);
  a.H = static_cast<int>(n[3]);
  a.KV = static_cast<int>(n[4]);
  a.dqk = static_cast<int>(n[5]);
  a.dvd = static_cast<int>(n[6]);
  a.q_start = static_cast<int>(n[7]);
  a.causal = static_cast<int>(n[8]);
  a.scale = scale;
  const int bd = static_cast<int>(n[9]), bdv = static_cast<int>(n[10]);
  if (a.B < 1 || a.T < 1 || a.S < 1 || a.KV < 1 || a.H % a.KV ||
      a.dqk > bd || a.dvd > bdv || a.KV > 65535 || a.B > 65535)
    return cudaErrorInvalidValue;
  a.n_rep = a.H / a.KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long route = n[23];
  if ((route == kCudaCores && dtype == 0) || (route == kWgmma && dtype == 1))
    return dispatch(a, static_cast<Route>(route), bd, bdv, bwd, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_fwd_launch(void* const* ptrs,
                                          const long long* n, float scale,
                                          int dtype, void* stream) {
  return launch(ptrs, n, scale, dtype, false, stream);
}

extern "C" int flash_attention_bwd_launch(void* const* ptrs,
                                          const long long* n, float scale,
                                          int dtype, void* stream) {
  return launch(ptrs, n, scale, dtype, true, stream);
}
