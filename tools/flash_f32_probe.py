"""What bounds the float32 flash attention route on the card: its product
loops alone, and the shared-memory loads they issue.

    python tools/flash_f32_probe.py

Builds, with ``nvcc``, a library that includes
``src/repro_torch/kernels/csrc/flash_attention.cu`` whole (as it is in the
checkout, with the flags of ``kernels/_build.py``) and adds bench kernels
that call its register-blocked products (``cc::prod_nt``, ``prod_nt2``,
``prod_nn``) over and over on shared-memory data, one 256-thread block an
SM as the route runs, at the micro-tiles and row strides of the 128/128
instance; a barrier between calls keeps the compiler from hoisting their
loads. It prints each product's FLOP/s against the CUDA cores' 67 TFLOP/s.

Then it times a warp's 16-byte shared-memory load in the access patterns
the products issue, beside a pattern with bank conflicts:
``ld.volatile.shared.v4.f32`` (every load issued, none hoisted), 32 warps
an SM so that latency is hidden, in SM cycles a warp instruction; it
checks in the SASS that these are 128-bit loads. Prints the card's name
and power limit last. Needs a CUDA card, ``nvcc`` and ``cuobjdump``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SRC = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
F32_FLOPS = 67e12
SMS = 132
# the 128/128 instance's products: (call, micro-tile rows, columns, k,
# FLOP a thread a call); nt2 runs two products of the tile
PRODUCTS = {
    "S = Q K^T, forward (4 x 8, k 128)":
        ("cc::prod_nt<4, 8, 128, 132, 132>(c8, a, b)", 4, 8, 128, 1),
    "O += P V, forward (4 x 16, k 64)":
        ("cc::prod_nn<4, 16, 64, 68, 132>(c, a, b)", 4, 16, 64, 1),
    "S and dP, backward (2 x 4 x 4, k 128)":
        ("cc::prod_nt2<4, 4, 128, 128, 132, 132>(c4, a, b, d4, e, f)",
         4, 4, 128, 2),
    "dQ, dK, dV, backward (4 x 16, k 32)":
        ("cc::prod_nn<4, 16, 32, 36, 132>(c, a, b)", 4, 16, 32, 1),
}
# (label, a lane's float offset in its warp's rows): rows padded to 132
PATTERNS = {
    "32 lanes, 32 distinct chunks (512 B)": "lane * 4",
    "B of nt: 8 rows, padded": "lb * 132",
    "A: 4 rows, each to 8 lanes": "la * 132",
    "B of nn: 8 chunks of one row": "lb * 4",
    "one address": "0",
    "8 rows unpadded (bank conflicts)": "lb * 128",
}
LDS_WARPS = 32
LDS_SMEM = 120_000  # bytes: one block an SM

BENCH = r"""
// ----------------------------------------------------------- the bench --
constexpr int kBlocks = SMS_VALUE;
constexpr int kFloats = 55000;  // A, B, E, F of 16,896 + 8,448 floats each

template <int P>
__global__ void __launch_bounds__(256, 1) product_bench(float* out,
                                                        int iters) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < kFloats; i += 256)
    smem[i] = (i % 97) * 1e-3f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int la = lane / 8, lb = lane % 8;
  float c[4][16], c8[4][8], c4[4][4], d4[4][4];
  cc::zero(c);
  cc::zero(c8);
  cc::zero(c4);
  cc::zero(d4);
  // a at the thread's first row (16 rows a warp); b at its first column
  const float* a = smem + (warp * 16 + la) * 132;
  const float* e = smem + 25400 + (warp * 16 + la) * 132;
  const float* b = smem + 17000 + (P == 1 || P == 3 ? 4 * lb : lb * 132);
  const float* f = smem + 42400 + lb * 132;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
PRODUCT_CASES
    __syncthreads();  // shared memory may change: reload every operand
  }
  float s = 0.f;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 16; ++j) s += c[i][j];
    for (int j = 0; j < 8; ++j) s += c8[i][j];
    for (int j = 0; j < 4; ++j) s += c4[i][j] + d4[i][j];
  }
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

template <int P>
int run_product(float* out, int iters) {
  cudaError_t e = cudaFuncSetAttribute(
      product_bench<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFloats * 4);
  if (e != cudaSuccess) return e;
  product_bench<P><<<kBlocks, 256, kFloats * 4>>>(out, iters);
  return cudaGetLastError();
}

extern "C" __global__ void __launch_bounds__(LDS_WARPS_VALUE * 32, 1)
    lds_bench(long long* cycles, float* out, int iters, int pattern) {
  extern __shared__ __align__(16) float s[];
  for (int i = threadIdx.x; i < 80 * 132; i += blockDim.x) s[i] = i * 1e-6f;
  __syncthreads();
  const int lane = threadIdx.x % 32, la = lane / 8, lb = lane % 8;
  int off = 0;
  switch (pattern) {
PATTERN_CASES
  }
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(
      s + off + (threadIdx.x / 32 % 8) * 8 * 132));
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float x, y, z, w;
      asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
                   : "r"(base + 16 * k)
                   : "memory");
      acc[k] += (x + y) + (z + w);
    }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  float t = 0.f;
  for (int k = 0; k < 8; ++k) t += acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

extern "C" int product(int which, float* out, int iters) {
  switch (which) {
RUN_CASES
  }
  return -1;
}

extern "C" int lds_pattern(long long* cycles, float* out, int iters,
                           int pattern) {
  cudaError_t e = cudaFuncSetAttribute(
      lds_bench, cudaFuncAttributeMaxDynamicSharedMemorySize, LDS_SMEM_VALUE);
  if (e != cudaSuccess) return e;
  lds_bench<<<kBlocks, LDS_WARPS_VALUE * 32, LDS_SMEM_VALUE>>>(
      cycles, out, iters, pattern);
  return cudaGetLastError();
}
"""


def source() -> str:
    """The probe's CUDA source: the route's source included whole, and the
    bench kernels after it (which reach its anonymous namespace, being in
    the same translation unit)."""
    cases = "\n".join(
        f"    if constexpr (P == {i}) {call};"
        for i, (call, *_rest) in enumerate(PRODUCTS.values()))
    runs = "\n".join(f"    case {i}: return run_product<{i}>(out, iters);"
                     for i in range(len(PRODUCTS)))
    pats = "\n".join(f"    case {i}: off = {expr}; break;"
                     for i, expr in enumerate(PATTERNS.values()))
    bench = (BENCH.replace("PRODUCT_CASES", cases)
             .replace("RUN_CASES", runs).replace("PATTERN_CASES", pats)
             .replace("SMS_VALUE", str(SMS))
             .replace("LDS_WARPS_VALUE", str(LDS_WARPS))
             .replace("LDS_SMEM_VALUE", str(LDS_SMEM)))
    return f'#include "{SRC}"\n' + bench


def lds_widths(so: Path) -> dict[str, int]:
    """{shared-load opcode: count} in the load bench's SASS."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           "-fun", "lds_bench", str(so)], check=True,
                          capture_output=True, text=True).stdout
    counts: dict[str, int] = {}
    for word in text.split():
        if word.startswith("LDS"):
            counts[word] = counts.get(word, 0) + 1
    return counts


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("flash_f32_probe: no CUDA card available")
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "probe.cu", Path(tmp) / "probe.so"
        cu.write_text(source())
        build = subprocess.run([_build.nvcc(),
                                *_build.flags("flash_attention"), "-o",
                                str(so), str(cu)], capture_output=True,
                               text=True, check=False)
        if build.returncode:
            raise RuntimeError("nvcc failed:\n" + build.stdout[-2000:]
                               + build.stderr[-4000:])
        widths = lds_widths(so)
        lib = ctypes.CDLL(str(so))
    print(f"load bench SASS: {widths}")
    if not widths or not all(".128" in op for op in widths):
        raise RuntimeError("the load bench's loads are not all 128-bit")
    lib.product.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.lds_pattern.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int]
    out = torch.zeros(SMS * LDS_WARPS * 32, device="cuda")
    for i, (label, (_, mt, nt, k, n)) in enumerate(PRODUCTS.items()):
        iters = 200 * 128 // k
        if lib.product(i, out.data_ptr(), 2):
            raise RuntimeError(f"the {label} bench did not launch")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lib.product(i, out.data_ptr(), iters)
        end.record()
        torch.cuda.synchronize()
        flops = 2.0 * SMS * 256 * mt * nt * k * n * iters
        rate = flops / (start.elapsed_time(end) * 1e-3)
        print(f"product {label}: {rate / 1e12:.1f} TFLOP/s, "
              f"{rate / F32_FLOPS:.1%} of 67")
    cycles = torch.zeros(SMS, dtype=torch.int64, device="cuda")
    iters = 2000
    for i, label in enumerate(PATTERNS):
        if lib.lds_pattern(cycles.data_ptr(), out.data_ptr(), iters, i):
            raise RuntimeError("the load bench did not launch")
        torch.cuda.synchronize()
        per = cycles.double().mean().item() / (8 * iters * LDS_WARPS)
        print(f"ld.volatile.shared.v4, {label}: {per:.3f} SM cycles a warp "
              f"instruction ({LDS_WARPS} warps an SM)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(card.splitlines()[0] if card else "power.limit not measured")
    return 0


if __name__ == "__main__":
    sys.exit(main())
