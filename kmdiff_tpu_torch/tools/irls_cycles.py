"""Where a K-IRLS fit's iteration goes, in cycles of the SM clock.

Run on a CUDA card from the root of a checkout:

    python3 -m kmdiff_tpu_torch.tools.irls_cycles

Copies kmdiff_tpu_torch under build/tools/irls_cycles/ and plants clock64()
reads in its irls.cu around the five sections of an iteration: the
weights and error with their stride sums (error), the normal equations
(normal), the elimination (elim), the back-substitution (backsub) and the
update of eta and mu (update); each fit's warp adds its section totals and
iterations to a device array. The copy builds under its own build/ and
runs in a subprocess on popstrat alt fits (irls_seeds.irls_inputs) of
1,024 items, one wave, at n = 20, F = 5 and n = 200, F = 12, once with the
default eps_conv and once with eps_conv = -1 (every fit runs to max_iters
= 33). It prints, as one JSON line, each run's mean cycles an iteration
in each section. The instrumented copy's outputs are not checked: the
clock reads move its arithmetic only in time. Section edges are
approximate: the compiler may move arithmetic across a clock read.

Then it builds, with this package's nvcc flags, a one-warp chain of 256
dependent steps of each of: f32 division, __frcp_rn, a shuffle, an add,
expf and logf, and prints the cycles a step (each step but the shuffle
adds one f32 add of its own to the chain).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.join(os.path.dirname(PKG), "build", "tools", "irls_cycles")
SECTIONS = ("error", "normal", "elim", "backsub", "update")

_MICRO = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void chains(float a, float* out, long long* cyc) {
  float x = a + threadIdx.x * 1e-3f;
  long long t[8];
  int k = 0;
  t[k++] = clock64();
  for (int i = 0; i < 256; ++i) x = (x + 2.0f) / (x + 1.0f);
  t[k++] = clock64();
  for (int i = 0; i < 256; ++i) x = __frcp_rn(x + 1.0f);
  t[k++] = clock64();
  for (int i = 0; i < 256; ++i) x = __shfl_sync(0xffffffffu, x, (threadIdx.x + 1) & 31) + 1.0f;
  t[k++] = clock64();
  for (int i = 0; i < 256; ++i) x = x + 0.5f;
  t[k++] = clock64();
  for (int i = 0; i < 256; ++i) x = expf(-x) + 0.5f;
  t[k++] = clock64();
  for (int i = 0; i < 256; ++i) x = logf(x + 1.0f);
  t[k++] = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) for (int j = 0; j + 1 < k; ++j) cyc[j] = t[j + 1] - t[j];
}
int main() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 128);
  cudaMalloc(&cyc, 64);
  for (int rep = 0; rep < 2; ++rep) chains<<<1, 32>>>(0.3f, out, cyc);
  long long h[6];
  cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  printf("{\"div\": %.1f, \"frcp_rn\": %.1f, \"shfl\": %.1f, \"add\": %.1f, \"expf\": %.1f, "
         "\"logf\": %.1f}\n", h[0] / 256.0, h[1] / 256.0, h[2] / 256.0, h[3] / 256.0,
         h[4] / 256.0, h[5] / 256.0);
  return cudaGetLastError() != cudaSuccess;
}
"""


def _instrumented_copy() -> str:
    """The package copied under ROOT with clock64 reads planted in irls.cu."""
    shutil.rmtree(ROOT, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(ROOT, "kmdiff_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(ROOT, "kmdiff_tpu_torch", "csrc", "irls.cu")
    with open(src) as f:
        text = f.read()
    edits = [
        ("namespace {\n", "namespace {\n__device__ unsigned long long g_cyc[8];\n"),
        ("bool solve_regs(const float* A, int lane, float* nw) {",
         "bool solve_regs(const float* A, int lane, float* nw, long long& mark) {"),
        ("  float x[kF];\n  bool bad = false;",
         "  mark = clock64();\n  float x[kF];\n  bool bad = false;"),
        ("  while (true) {\n    float se[kParts];",
         "  long long cy[5] = {0, 0, 0, 0, 0};\n  unsigned long long nit = 0;\n"
         "  while (true) {\n    const long long c0 = clock64();\n    float se[kParts];"),
        ("    err = error;\n", "    err = error;\n    const long long c1 = clock64();\n"),
        ("    __syncwarp();  // A\n",
         "    __syncwarp();  // A\n    const long long c2 = clock64();\n    long long cm = c2;\n"),
        ("frozen = solve_regs<kF>(A, lane, nw);", "frozen = solve_regs<kF>(A, lane, nw, cm);"),
        ("    __syncwarp();  // nw\n", "    __syncwarp();  // nw\n    const long long c3 = clock64();\n"),
        ("      mu[i] = 1.0f / (1.0f + expf(-e));\n    }\n  }\n",
         "      mu[i] = 1.0f / (1.0f + expf(-e));\n    }\n    const long long c4 = clock64();\n"
         "    cy[0] += c1 - c0;\n    cy[1] += c2 - c1;\n    cy[2] += cm - c2;\n"
         "    cy[3] += c3 - cm;\n    cy[4] += c4 - c3;\n    ++nit;\n  }\n"),
        ("  for (int j = lane; j < F; j += 32) w_out[b * F + j] = w[j];\n",
         "  for (int j = lane; j < F; j += 32) w_out[b * F + j] = w[j];\n"
         "  if (lane == 0) {\n    for (int k = 0; k < 5; ++k) atomicAdd(&g_cyc[k], "
         "static_cast<unsigned long long>(cy[k]));\n    atomicAdd(&g_cyc[7], nit);\n  }\n"),
    ]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"irls.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    text += ("\nKMD_API int kmd_cycles_reset() {\n  unsigned long long z[8] = {0};\n"
             "  return static_cast<int>(cudaMemcpyToSymbol(g_cyc, z, sizeof(z)));\n}\n"
             "KMD_API int kmd_cycles_read(unsigned long long* out) {\n"
             "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc)));\n}\n")
    with open(src, "w") as f:
        f.write(text)
    return ROOT


def measure() -> dict:
    """In the instrumented copy's process: cycles an iteration by section."""
    import ctypes

    import numpy as np
    import torch

    from kmdiff_tpu_torch import kernels
    from kmdiff_tpu_torch.ops import glm
    from kmdiff_tpu_torch.tools.irls_seeds import irls_inputs

    dev = torch.device("cuda", 0)
    lib = kernels.lib()  # the instrumented build: it alone has kmd_cycles_*
    buf = (ctypes.c_ulonglong * 8)()
    out = {}
    for n, F in ((20, 5), (200, 12)):
        args = irls_inputs(np.random.default_rng(n), n, F, 1024, dev)
        for eps in (1e-6, -1.0):
            glm.irls(*args, 33, eps)
            torch.cuda.synchronize()
            lib.kmd_cycles_reset()
            glm.irls(*args, 33, eps)
            torch.cuda.synchronize()
            lib.kmd_cycles_read(buf)
            its = max(buf[7], 1)
            out[f"n={n},F={F},eps={eps:g}"] = {
                "iterations": buf[7],
                **{name: round(buf[k] / its, 1) for k, name in enumerate(SECTIONS)}}
    return out


def chains() -> dict:
    """The dependent-chain microbenchmark, built with the package's flags."""
    from kmdiff_tpu_torch import kernels

    os.makedirs(ROOT, exist_ok=True)
    src, exe = os.path.join(ROOT, "chains.cu"), os.path.join(ROOT, "chains")
    with open(src, "w") as f:
        f.write(_MICRO)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([kernels._nvcc(), *flags, "-o", exe, src], check=True)
    return json.loads(subprocess.run([exe], capture_output=True, text=True,
                                     check=True).stdout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.measure:
        print(json.dumps(measure()))
        return 0
    root = _instrumented_copy()
    proc = subprocess.run([sys.executable, "-m", "kmdiff_tpu_torch.tools.irls_cycles",
                           "--measure"], cwd=root, env=dict(os.environ, PYTHONPATH=root),
                          stdout=subprocess.PIPE, text=True, check=True)
    print(json.dumps({"sections": json.loads(proc.stdout.strip().splitlines()[-1]),
                      "chains": chains()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
