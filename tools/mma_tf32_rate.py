#!/usr/bin/env python3
"""The rate at which one CUDA card issues ``mma.sync.m16n8k8.tf32``, the
instruction of K3's split-TF32 f32 kernels (csrc/conv3x3_tf32.cuh).

    python3 tools/mma_tf32_rate.py

Builds a one-file CUDA program with the port's nvcc (sm_90a) in a
temporary directory and runs it: one block an SM, 4 to 18 warps, each
warp issuing independent m16n8k8 TF32 MMAs into 12 accumulators from
registers (no memory traffic), timed by CUDA events. Prints, for each
warp count, MMAs an SM a clock (at the card's reported clock) and the
dense TF32 TFLOP/s that makes; then the least time of K3-f f32 at
(8, 256, 256, 48) -> 48 and of K3-b f32 at (16, 256, 256, 48), three MMAs
for every product, at the best rate seen. Needs nvcc and one card.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from robust_object_detection_tpu_torch import kernels  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void mma_kernel(float* out, int iters) {
  float c[12][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 12; ++j) mma(c[j], a, b0, b1);
  }
  float s = 0.f;
  for (int j = 0; j < 12; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 1234.5f) out[threadIdx.x] = s;
}

int main() {
  float* out;
  cudaMalloc(&out, 4096 * 4);
  int sms, khz;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("sms %d clock_khz %d\n", sms, khz);
  const int iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int warps : {4, 8, 9, 16, 18}) {
    mma_kernel<<<sms, 32 * warps>>>(out, iters);
    cudaEventRecord(e0);
    mma_kernel<<<sms, 32 * warps>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    printf("warps %d ms %.6f mmas_per_sm %.0f\n", warps, ms,
           (double)warps * iters * 12);
  }
  return (int)cudaGetLastError();
}
"""

K3F_FLOPS = 2 * 9 * 48 * 48 * 8 * 256 * 256    # (8, 256, 256, 48) -> 48
K3B_FLOPS = 2 * 9 * 48 * 48 * 16 * 256 * 256   # (16, 256, 256, 48)
MMA_FLOPS = 2 * 16 * 8 * 8


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "mma_rate.cu", Path(tmp) / "mma_rate"
        src.write_text(SOURCE)
        subprocess.run([kernels.nvcc_path(), "-O3", "-std=c++17",
                        "-gencode", "arch=compute_90a,code=sm_90a",
                        "-o", str(exe), str(src)], check=True, timeout=300)
        res = subprocess.run([str(exe)], capture_output=True, text=True,
                             timeout=120)
    if res.returncode != 0:
        print(f"FAIL: {res.stdout}{res.stderr}", file=sys.stderr)
        return 1
    lines = res.stdout.split("\n")
    sms, khz = (int(v) for v in lines[0].split()[1::2])
    best = 0.0
    for line in lines[1:]:
        if not line:
            continue
        _, warps, _, ms, _, mmas = line.split()
        per_clk = float(mmas) / (float(ms) * 1e-3 * khz * 1e3)
        tflops = per_clk * sms * khz * 1e3 * MMA_FLOPS / 1e12
        best = max(best, tflops)
        print(f"[mma] m16n8k8 tf32, {warps} warps an SM: {ms} ms, "
              f"{per_clk} MMAs an SM a clock at {khz / 1e6} GHz, "
              f"{tflops} TFLOP/s on {sms} SMs")
    for name, flops in (("K3-f f32 (8,256,256,48)->48", K3F_FLOPS),
                        ("K3-b f32 (16,256,256,48)", K3B_FLOPS)):
        print(f"[mma] {name}: three MMAs a product at {best} TFLOP/s take "
              f"{3 * flops / (best * 1e12) * 1e3} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
