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
// Design (FlashAttention-2 on mma.sync; wgmma, TMA and warp specialisation
// are later work):
// - bf16 products run on the tensor cores, mma.sync.m16n8k16 with f32
//   accumulation, operands read from shared memory by ldmatrix (.trans for
//   a [k][n] operand). A score fragment turns into the next product's A
//   fragment in registers (the C layout of two n8 tiles is the A layout of
//   one k16 step), so p and ds never touch shared memory.
// - f32 multiplies on the CUDA cores, in f32, with the same fragment layout
//   (each thread owns the elements an mma C fragment would give it): TF32
//   would keep 10 mantissa bits and break the f32 tolerances.
// - Four warps a block, 16 rows a warp. The forward and the dq kernel take
//   64 grouped query rows a block and walk the key tiles; the dk/dv kernel
//   takes 64 keys a block and walks the query tiles (every head of the
//   group) that see them. Each warp's accumulators stay in registers; no
//   kernel communicates between warps or blocks, and no atomics: the
//   gradients are deterministic.
// - K/V (or Q/dO) tiles are double-buffered in shared memory by 16-byte
//   cp.async copies, one tile in flight while the other is used. Rows are
//   padded by 16 bytes, so ldmatrix's eight row addresses fall in eight
//   bank groups. Tensors are read in their (B, L, heads, d) layout through
//   their strides (no permuted copies; MLA's v is a split view).
// - Head dims are template buckets: qk {32, 48, 64, 128, 192} with v
//   {32, 32, 64, 128, 128}. A smaller dim is zero-padded in shared memory
//   (zero columns add nothing); the wrapper picks the bucket.
// - Causal query tiles run longest first (blockIdx.x reversed).

#include <cmath>
#include <cstdint>

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
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// two neighbouring elements of a row, rounded to the element type
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// exp: exact-rounded expf for f32 (its tolerance is the reference's own),
// the fast intrinsic for bf16
__device__ __forceinline__ float fexp(float x, float) { return expf(x); }
__device__ __forceinline__ float fexp(float x, bf16) { return __expf(x); }

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

// ------------------------------------------------------ warp products, bf16
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc (16 x N) += A (16 x D, rows at a, stride lda) . B^T, B (N x D, rows at
// b, stride ldb): the score-like product, both operands row-major over D.
// acc[n] is the C fragment of columns [8n, 8n + 8): elements (g, 2tq),
// (g, 2tq + 1), (g + 8, 2tq), (g + 8, 2tq + 1), g = lane / 4, tq = lane % 4.
template <int D, int N>
__device__ __forceinline__ void mma_nt(float (&acc)[N / 8][4], const bf16* a,
                                       int lda, const bf16* b, int ldb) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + k * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n * 16 + (mi / 2) * 8 + lane % 8) * ldb + k * 16 +
                      (mi % 2) * 8);
      mma16816(acc[2 * n], af, bf[0], bf[1]);
      mma16816(acc[2 * n + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += round(P) (16 x K, C fragments in registers) . B (K x N,
// row-major at b, stride ldb): P rounded to bf16 (to nearest even) as the
// reference rounds p and ds to q's dtype.
template <int K, int N>
__device__ __forceinline__ void mma_pn(float (&acc)[N / 8][4],
                                       const float (&p)[K / 8][4],
                                       const bf16* b, int ldb) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + (mi % 2) * 8 + lane % 8) * ldb + n * 16 +
                        (mi / 2) * 8);
      mma16816(acc[2 * n], af, bf[0], bf[1]);
      mma16816(acc[2 * n + 1], af, bf[2], bf[3]);
    }
  }
}

// ------------------------------------------------------- warp products, f32
// The same two products on the CUDA cores, each thread computing the
// elements of its C fragments with f32 FMAs.
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

// the (qk, v) buckets; kernels/flash_attention.py's BUCKETS names the same
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

// ints: B, T, S, H, KV, dqk, dv, q_start, causal, bucket qk, bucket v,
// then the element strides (batch, seq, head) of q, k, v and dout.
// ptrs: q, k, v, dout, out, lse, delta, o, dq, dk, dv (unused ones null).
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
  if (dtype == 0) return dispatch<float>(a, bd, bdv, bwd, st);
  if (dtype == 1) return dispatch<bf16>(a, bd, bdv, bwd, st);
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
