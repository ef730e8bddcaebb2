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
// 1. wgmma (bf16): the Hopper design below, instances 64/64, 128/128 and
//    192/128 (every LM config's head dims); the test-only buckets 32/32
//    and 48/32 run on 64/64, zero-padded by TMA.
// 2. cuda_cores (float32, every bucket): the first FlashAttention-2
//    kernels, unchanged (the kernels outside namespace wg), on the CUDA
//    cores in f32 with mma.sync's fragment layout: TF32 would keep 10
//    mantissa bits and break the f32 tolerances. Four warps a block over
//    64 grouped rows, 16 rows a warp; K/V double-buffered by 16-byte
//    cp.async copies into rows padded by 16 bytes; three backward
//    launches (delta, dk/dv, dq).
//    Bound by the CUDA cores' 67 TFLOP/s.
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
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows (forward, dq) or keys (dk/dv)

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

// grouped query row r of kv head kvh: head kvh * n_rep + r % n_rep at r / n_rep
template <typename T>
__device__ __forceinline__ const T* grouped_row(const View& v, int b, int kvh,
                                                int n_rep, int r) {
  return row_of<T>(v, b, r / n_rep, kvh * n_rep + r % n_rep);
}

__device__ __forceinline__ float to_f(float x) { return x; }

// two neighbouring elements of a row, rounded to the element type
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp: exact-rounded expf for f32 (its tolerance is the reference's own)
__device__ __forceinline__ float fexp(float x, float) { return expf(x); }

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

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of a tile into shared memory rows of `ld` elements: `d`
// elements of row i from row(i), or zeros where row(i) is null. The columns
// [d, ld) are never written (zeroed once at the kernel's start).
template <typename T, typename RowFn>
__device__ __forceinline__ void load_tile(T* s, int ld, int n, int d,
                                          const void* base, RowFn row) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = d / E;
  for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * E;
    const T* src = row(r);
    cp16(s + r * ld + c, src ? static_cast<const void*>(src + c) : base,
         src != nullptr);
  }
}

__device__ __forceinline__ void zero_smem(unsigned char* s, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    *reinterpret_cast<uint4*>(s + i) = make_uint4(0, 0, 0, 0);
}

// ------------------------------------------------------- warp products, f32
// A warp's 16 rows of the two products on the CUDA cores, each thread
// computing the elements an mma.sync C fragment would give it with f32
// FMAs: acc[n] holds columns [8n, 8n + 8), elements (g, 2tq), (g, 2tq + 1),
// (g + 8, 2tq), (g + 8, 2tq + 1), g = lane / 4, tq = lane % 4.
// mma_nt: acc (16 x N) += A (16 x D, rows at a, stride lda) . B^T, B (N x D,
// rows at b, stride ldb); mma_pn: acc (16 x N) += P (16 x K, C fragments in
// registers) . B (K x N, row-major at b, stride ldb).
template <int D, int N>
__device__ __forceinline__ void mma_nt(float (&acc)[N / 8][4], const float* a,
                                       int lda, const float* b, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const float* a0 = a + g * lda;
  const float* a1 = a0 + 8 * lda;
  const float* b0 = b + 2 * tq * ldb;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float y0 = b0[n * 8 * ldb + k], y1 = b0[(n * 8 + 1) * ldb + k];
      acc[n][0] = fmaf(x0, y0, acc[n][0]);
      acc[n][1] = fmaf(x0, y1, acc[n][1]);
      acc[n][2] = fmaf(x1, y0, acc[n][2]);
      acc[n][3] = fmaf(x1, y1, acc[n][3]);
    }
  }
}

template <int K, int N>
__device__ __forceinline__ void mma_pn(float (&acc)[N / 8][4],
                                       const float (&p)[K / 8][4],
                                       const float* b, int ldb) {
  const int lane = threadIdx.x % 32, tq = lane % 4;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // p[row][k] lives in the quad's thread (k % 8) / 2
    const int src = (lane & ~3) | ((k % 8) / 2);
    const float x0 = __shfl_sync(0xffffffffu, p[k / 8][k % 2], src);
    const float x1 = __shfl_sync(0xffffffffu, p[k / 8][2 + k % 2], src);
    const float* row = b + k * ldb + 2 * tq;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(row + n * 8);
      acc[n][0] = fmaf(x0, y.x, acc[n][0]);
      acc[n][1] = fmaf(x0, y.y, acc[n][1]);
      acc[n][2] = fmaf(x1, y.x, acc[n][2]);
      acc[n][3] = fmaf(x1, y.y, acc[n][3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Tile shapes and shared memory of one (element type, qk dim, v dim).
template <typename T, int D, int DV>
struct Shape {
  static constexpr int kPad = 16 / sizeof(T);  // 16 bytes a row
  static constexpr int LQ = D + kPad, LV = DV + kPad;
  static constexpr int BN = 64;  // keys a forward step
  // the backward's per-warp accumulators are (D + DV) / 2 f32 a thread;
  // at the wide dims its steps take 32 rows to leave registers for them
  static constexpr int BB = D + DV >= 256 ? 32 : 64;
  static constexpr int fwd_smem = (kRows * LQ + 2 * BN * (LQ + LV)) * sizeof(T);
  static constexpr int dkdv_smem =
      (kRows + 2 * BB) * (LQ + LV) * sizeof(T) + 4 * BB * sizeof(float);
  static constexpr int dq_smem = (kRows + 2 * BB) * (LQ + LV) * sizeof(T);
};

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

// ---------------------------------------------------------------- forward --
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Args a) {
  using C = Shape<T, D, DV>;
  constexpr int BN = C::BN, LQ = C::LQ, LV = C::LV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * LQ;
  T* sV = sK + 2 * BN * LQ;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int R = a.T * a.n_rep;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;

  zero_smem(smem, C::fwd_smem);
  __syncthreads();
  load_tile<T>(sQ, LQ, kRows, a.dqk, a.q.p, [&](int i) -> const T* {
    return r0 + i < R ? grouped_row<T>(a.q, b, kvh, a.n_rep, r0 + i)
                      : nullptr;
  });
  auto load_kv = [&](int j, int buf) {
    const int k0 = j * BN;
    load_tile<T>(sK + buf * BN * LQ, LQ, BN, a.dqk, a.k.p,
                 [&](int i) -> const T* {
                   return k0 + i < a.S ? row_of<T>(a.k, b, k0 + i, kvh)
                                       : nullptr;
                 });
    load_tile<T>(sV + buf * BN * LV, LV, BN, a.dvd, a.v.p,
                 [&](int i) -> const T* {
                   return k0 + i < a.S ? row_of<T>(a.v, b, k0 + i, kvh)
                                       : nullptr;
                 });
  };
  const int end = key_tiles(a, r0, min(r0 + kRows, R), BN);
  load_kv(0, 0);
  cp_commit();

  const int ra = r0 + warp * 16 + g;  // this thread's rows: ra and ra + 8
  const int pos[2] = {a.q_start + ra / a.n_rep, a.q_start + (ra + 8) / a.n_rep};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < end; ++j) {
    if (j + 1 < end) {
      load_kv(j + 1, (j + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kb = sK + (j & 1) * BN * LQ;
    const T* vb = sV + (j & 1) * BN * LV;
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_nt<D, BN>(s, sQ + warp * 16 * LQ, LQ, kb, LQ);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * BN + n * 8 + 2 * tq + (e & 1);
        float x = s[n][e] * a.scale;
        if (key >= a.S) x = -INFINITY;  // past the end: not a key at all
        else if (a.causal && key > pos[e >> 1]) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = fexp(m[i] - mx[i], T());
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fexp(s[n][e] - m[e >> 1], T());
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_pn<BN, DV>(acc, s, vb, LV);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    const float l_safe = fmaxf(quad_sum(l[i]), 1e-37f);
    if (r >= R) continue;
    const int t = r / a.n_rep, hd = kvh * a.n_rep + r % a.n_rep;
    T* orow = static_cast<T*>(a.o) +
              ((static_cast<long long>(b) * a.T + t) * a.H + hd) * a.dvd;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < a.dvd)
        store2(orow + col, acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
    }
    if (tq == 0)
      a.lse[(static_cast<long long>(b) * a.KV + kvh) * R + r] =
          m[i] + logf(l_safe);
  }
}

// ----------------------------------------------------------------- delta --
// delta[b, kvh, r] = sum_c dO[row][c] * O[row][c] in f32, one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Args a) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.B) * a.T * a.H) return;
  const int hd = static_cast<int>(row % a.H);
  const int t = static_cast<int>((row / a.H) % a.T);
  const int b = static_cast<int>(row / (static_cast<long long>(a.H) * a.T));
  const T* o = static_cast<const T*>(a.out) + row * a.dvd;
  const T* d = row_of<T>(a.dout, b, t, hd);
  float sum = 0.f;
  for (int c = lane; c < a.dvd; c += 32) sum += to_f(d[c]) * to_f(o[c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int R = a.T * a.n_rep;
    a.delta[(static_cast<long long>(b) * a.KV + hd / a.n_rep) * R +
            static_cast<long long>(t) * a.n_rep + hd % a.n_rep] = sum;
  }
}

// ------------------------------------------------------------------ dk/dv --
// One block a (batch, kv head, 64 keys); each warp's 16 keys' dk and dv in
// registers, over every grouped query row that sees them, BB rows a step.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  using C = Shape<T, D, DV>;
  constexpr int BB = C::BB, LQ = C::LQ, LV = C::LV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kRows * LQ;
  T* sQ = sV + kRows * LV;   // 2 x BB x LQ
  T* sO = sQ + 2 * BB * LQ;  // dO: 2 x BB x LV
  float* sL = reinterpret_cast<float*>(sO + 2 * BB * LV);  // lse: 2 x BB
  float* sD = sL + 2 * BB;                                 // delta: 2 x BB
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int R = a.T * a.n_rep;
  const int k0 = blockIdx.x * kRows;
  const long long lrow = (static_cast<long long>(b) * a.KV + kvh) * R;

  zero_smem(smem, C::dkdv_smem);
  __syncthreads();
  load_tile<T>(sK, LQ, kRows, a.dqk, a.k.p, [&](int i) -> const T* {
    return k0 + i < a.S ? row_of<T>(a.k, b, k0 + i, kvh) : nullptr;
  });
  load_tile<T>(sV, LV, kRows, a.dvd, a.v.p, [&](int i) -> const T* {
    return k0 + i < a.S ? row_of<T>(a.v, b, k0 + i, kvh) : nullptr;
  });
  auto load_q = [&](int i, int buf) {
    const int q0 = i * BB;
    load_tile<T>(sQ + buf * BB * LQ, LQ, BB, a.dqk, a.q.p,
                 [&](int x) -> const T* {
                   return q0 + x < R
                              ? grouped_row<T>(a.q, b, kvh, a.n_rep, q0 + x)
                              : nullptr;
                 });
    load_tile<T>(sO + buf * BB * LV, LV, BB, a.dvd, a.dout.p,
                 [&](int x) -> const T* {
                   return q0 + x < R
                              ? grouped_row<T>(a.dout, b, kvh, a.n_rep, q0 + x)
                              : nullptr;
                 });
    for (int x = threadIdx.x; x < BB; x += kThreads) {
      const bool ok = q0 + x < R;
      cp4(sL + buf * BB + x, ok ? a.lse + lrow + q0 + x : a.lse, ok);
      cp4(sD + buf * BB + x, ok ? a.delta + lrow + q0 + x : a.delta, ok);
    }
  };
  // the query tiles that see these keys: rows r >= (k0 - q_start) * n_rep
  // when causal and every row sees key 0; a row that sees no key (q_start
  // < 0) has p = 1 on every key, so then all of them
  const int n_q = (R + BB - 1) / BB;
  int start = 0;
  if (a.causal && a.q_start >= 0) {
    const long long first = static_cast<long long>(k0 - a.q_start) * a.n_rep;
    start = first > 0 ? static_cast<int>(min(first / BB,
                                             static_cast<long long>(n_q)))
                      : 0;
  }
  load_q(start, 0);
  cp_commit();

  // this thread's keys ka and ka + 8; row r sees key k iff r >= (k -
  // q_start) * n_rep (positions are q_start + r / n_rep, r >= 0)
  const int ka = k0 + warp * 16 + g;
  const bool key_ok[2] = {ka < a.S, ka + 8 < a.S};
  const long long first_row[2] = {
      static_cast<long long>(ka - a.q_start) * a.n_rep,
      static_cast<long long>(ka + 8 - a.q_start) * a.n_rep};
  float dk[D / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;

  for (int i = start; i < n_q; ++i) {
    const int buf = (i - start) & 1;
    if (i + 1 < n_q) {
      load_q(i + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* qb = sQ + buf * BB * LQ;
    const T* ob = sO + buf * BB * LV;
    const float* lb = sL + buf * BB;
    const float* db = sD + buf * BB;
    const int q0 = i * BB;
    // p^T (16 keys x BB rows) from s^T = K Q^T
    float st[BB / 8][4];
#pragma unroll
    for (int n = 0; n < BB / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
    mma_nt<D, BB>(st, sK + warp * 16 * LQ, LQ, qb, LQ);
#pragma unroll
    for (int n = 0; n < BB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        float p = 0.f;
        if (q0 + c < R && key_ok[e >> 1]) {
          float x = st[n][e] * a.scale;
          if (a.causal && q0 + c < first_row[e >> 1]) x = kNegInf;
          p = fexp(x - lb[c], T());
        }
        st[n][e] = p;
      }
    mma_pn<BB, DV>(dv, st, ob, LV);  // dV += P^T dO
    float dpt[BB / 8][4];
#pragma unroll
    for (int n = 0; n < BB / 8; ++n)
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    mma_nt<DV, BB>(dpt, sV + warp * 16 * LV, LV, ob, LV);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < BB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        st[n][e] = st[n][e] * (dpt[n][e] - db[c]) * a.scale;  // ds^T
      }
    mma_pn<BB, D>(dk, st, qb, LQ);  // dK += dS^T Q
    __syncthreads();
  }
  cp_wait<0>();  // no query tile sees these keys: the first load is idle

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = ka + 8 * i;
    if (!key_ok[i]) continue;
    const long long base = (static_cast<long long>(b) * a.S + key) * a.KV + kvh;
    T* krow = static_cast<T*>(a.dk) + base * a.dqk;
    T* vrow = static_cast<T*>(a.dv) + base * a.dvd;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < a.dqk) store2(krow + col, dk[n][2 * i], dk[n][2 * i + 1]);
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < a.dvd) store2(vrow + col, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// --------------------------------------------------------------------- dq --
// One block a (batch, kv head, 64 grouped query rows), walking the key
// tiles (BB keys a step) as the forward does; dq in registers.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using C = Shape<T, D, DV>;
  constexpr int BB = C::BB, LQ = C::LQ, LV = C::LV;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kRows * LQ;   // dO
  T* sK = sO + kRows * LV;   // 2 x BB x LQ
  T* sV = sK + 2 * BB * LQ;  // 2 x BB x LV
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int R = a.T * a.n_rep;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const long long lrow = (static_cast<long long>(b) * a.KV + kvh) * R;

  zero_smem(smem, C::dq_smem);
  __syncthreads();
  load_tile<T>(sQ, LQ, kRows, a.dqk, a.q.p, [&](int i) -> const T* {
    return r0 + i < R ? grouped_row<T>(a.q, b, kvh, a.n_rep, r0 + i)
                      : nullptr;
  });
  load_tile<T>(sO, LV, kRows, a.dvd, a.dout.p, [&](int i) -> const T* {
    return r0 + i < R ? grouped_row<T>(a.dout, b, kvh, a.n_rep, r0 + i)
                      : nullptr;
  });
  auto load_kv = [&](int j, int buf) {
    const int k0 = j * BB;
    load_tile<T>(sK + buf * BB * LQ, LQ, BB, a.dqk, a.k.p,
                 [&](int i) -> const T* {
                   return k0 + i < a.S ? row_of<T>(a.k, b, k0 + i, kvh)
                                       : nullptr;
                 });
    load_tile<T>(sV + buf * BB * LV, LV, BB, a.dvd, a.v.p,
                 [&](int i) -> const T* {
                   return k0 + i < a.S ? row_of<T>(a.v, b, k0 + i, kvh)
                                       : nullptr;
                 });
  };
  const int end = key_tiles(a, r0, min(r0 + kRows, R), BB);
  load_kv(0, 0);
  cp_commit();

  const int ra = r0 + warp * 16 + g;
  const int pos[2] = {a.q_start + ra / a.n_rep, a.q_start + (ra + 8) / a.n_rep};
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = ra + 8 * i < R;
    lse[i] = ok ? a.lse[lrow + ra + 8 * i] : INFINITY;  // p = 0 off the end
    delta[i] = ok ? a.delta[lrow + ra + 8 * i] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = 0; j < end; ++j) {
    if (j + 1 < end) {
      load_kv(j + 1, (j + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kb = sK + (j & 1) * BB * LQ;
    const T* vb = sV + (j & 1) * BB * LV;
    float s[BB / 8][4];
#pragma unroll
    for (int n = 0; n < BB / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_nt<D, BB>(s, sQ + warp * 16 * LQ, LQ, kb, LQ);
#pragma unroll
    for (int n = 0; n < BB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * BB + n * 8 + 2 * tq + (e & 1);
        float p = 0.f;
        if (key < a.S) {
          float x = s[n][e] * a.scale;
          if (a.causal && key > pos[e >> 1]) x = kNegInf;
          p = fexp(x - lse[e >> 1], T());
        }
        s[n][e] = p;
      }
    float dp[BB / 8][4];
#pragma unroll
    for (int n = 0; n < BB / 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    mma_nt<DV, BB>(dp, sO + warp * 16 * LV, LV, vb, LV);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < BB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = s[n][e] * (dp[n][e] - delta[e >> 1]) * a.scale;  // ds
    mma_pn<BB, D>(dq, s, kb, LQ);  // dQ += dS K
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (r >= R) continue;
    const int t = r / a.n_rep, hd = kvh * a.n_rep + r % a.n_rep;
    T* row = static_cast<T*>(a.dq) +
             ((static_cast<long long>(b) * a.T + t) * a.H + hd) * a.dqk;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < a.dqk) store2(row + col, dq[n][2 * i], dq[n][2 * i + 1]);
    }
  }
}

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

// the (qk, v) instances of this route; kernels/flash_attention.py's
// WGMMA_BUCKETS names the same (a smaller bucket runs on 64/64, zero-
// padded by TMA)
#define FA_WGMMA_BUCKETS(X) X(64, 64) X(128, 128) X(192, 128)

cudaError_t dispatch(const Args& a, int bd, int bdv, bool bwd,
                     cudaStream_t st) {
  // the grid is (tiles, heads, batch): a head's tiles run side by side and
  // share its K and V in L2 (ordering every head's longest tile first
  // instead reads the whole K and V from memory, 12% slower)
  if (a.H > 65535) return cudaErrorInvalidValue;
#define FA_CASE(d, dv)                                              \
  if (bd == d && bdv == dv)                                         \
    return bwd ? launch_bwd<d, dv>(a, st) : launch_fwd<d, dv>(a, st);
  FA_WGMMA_BUCKETS(FA_CASE)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace wg

// ---------------------------------------------------------------- launch --
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D, int DV>
cudaError_t launch_fwd(const Args& a, cudaStream_t st) {
  using C = Shape<T, D, DV>;
  cudaError_t e = allow_smem(fwd_kernel<T, D, DV>, C::fwd_smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T * a.n_rep + kRows - 1) / kRows, a.KV, a.B);
  fwd_kernel<T, D, DV><<<grid, kThreads, C::fwd_smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t launch_bwd(const Args& a, cudaStream_t st) {
  using C = Shape<T, D, DV>;
  const long long rows = static_cast<long long>(a.B) * a.T * a.H;
  delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                    kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(dkdv_kernel<T, D, DV>, C::dkdv_smem);
  if (e != cudaSuccess) return e;
  dkdv_kernel<T, D, DV><<<dim3((a.S + kRows - 1) / kRows, a.KV, a.B),
                          kThreads, C::dkdv_smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(dq_kernel<T, D, DV>, C::dq_smem);
  if (e != cudaSuccess) return e;
  dq_kernel<T, D, DV><<<dim3((a.T * a.n_rep + kRows - 1) / kRows, a.KV, a.B),
                        kThreads, C::dq_smem, st>>>(a);
  return cudaGetLastError();
}

// the (qk, v) buckets of the cuda_cores route (float32);
// kernels/flash_attention.py's BUCKETS names the same
#define FA_BUCKETS(X) X(32, 32) X(48, 32) X(64, 64) X(128, 128) X(192, 128)

template <typename T>
cudaError_t dispatch(const Args& a, int bd, int bdv, bool bwd,
                     cudaStream_t st) {
#define FA_CASE(d, dv)                                              \
  if (bd == d && bdv == dv)                                         \
    return bwd ? launch_bwd<T, d, dv>(a, st) : launch_fwd<T, d, dv>(a, st);
  FA_BUCKETS(FA_CASE)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

// the wrapper's route codes (kernels/flash_attention.py, ROUTE_CODES)
enum Route { kCudaCores = 0, kWgmma = 1 };

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
  if (route == kCudaCores && dtype == 0)
    return dispatch<float>(a, bd, bdv, bwd, st);
  if (route == kWgmma && dtype == 1) return wg::dispatch(a, bd, bdv, bwd, st);
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
