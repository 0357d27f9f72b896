#!/usr/bin/env python3
"""Where the WKV6 kernel's (K6's) time goes on the card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 scripts/wkv6_probe.py [--only knockouts|scaling|mma]

- ``knockouts``: builds copies of ``kernels/rwkv6/csrc/wkv6.cu`` with
  phases of the tile loop removed (their results are then wrong; only their
  times are read) and times each at rwkv6-3b's shape (B=4, T=2048, H=40,
  K=V=64, f32: 160 CTAs, two on 28 of the 132 SMs) and at B=3, H=44 (132
  CTAs, one an SM);
- ``scaling``: the shipped kernel's time against its number of CTAs (B x H)
  at T=2048, K=V=64;
- ``mma``: the card's rate of ``mma.sync`` m16n8k8 TF32 and m16n8k16 bf16
  and of f32 FFMA at 1-16 warps an SM, and one dependent HMMA's latency.

Times: median of CUDA-event runs with L2 flushed.  Prints the card's name
and power limit first.  Builds go to the git-ignored ``build/wkv6_probe``.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'src'))
SRC = ROOT / 'src/repro_torch/kernels/rwkv6/csrc/wkv6.cu'
BUILD = ROOT / 'build' / 'wkv6_probe'
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3')

# the tile loop's phases, each by the first line of its statement (and
# which match of it); removing the chains also removes the pair-by-pair
# pass, which their garbage would otherwise send every channel to
PHASES = {
    'loads': [('mbar_wait(bar, it & 1);', 0),
              ('if (it + 1 < n_tiles)\n', 0),
              ('if (!any_unsafe && it + 1 < n_tiles && tid == 0)', 0)],
    'chains': [('if (tid < K) {', 0), ('if (any_unsafe) {', 0)],
    'bonus': [('for (int row0 = 8 * (warp - NW / 2);', 0)],
    'scores': [('for (int job = wr; job < NSUB * (NSUB + 1);', 0)],
    'y_inter': [('for (int kk = 0; kk < K / 8; ++kk) {', 0)],
    'y_intra': [('for (int ks = 0; ks < KT; ++ks) {', 0)],
    'state': [('for (int ks = 0; ks < KT; ++ks) {', 1)],
}
VARIANTS = {
    'shipped': [],
    'compute only': ['loads'],
    'no chains': ['chains'],
    'no bonus': ['bonus'],
    'no scores': ['scores'],
    'no y_inter': ['y_inter'],
    'no y_intra': ['y_intra'],
    'no state': ['state'],
    'loads only': ['chains', 'bonus', 'scores', 'y_inter', 'y_intra', 'state'],
    'nothing': list(PHASES),
}

MMA_SRC = r'''
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
template <int NACC>
__global__ void tf32_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  float d[NACC][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0;
  for (int j = 0; j < NACC; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void bf16_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void ffma_loop(float* out, int iters) {
  float x[8];
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * 0.001f + j;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = fmaf(x[j], 0.999f, 0.001f);
  float s = 0;
  for (int j = 0; j < 8; ++j) s += x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <typename F>
float time_ms(F launch) {
  cudaEvent_t a, z;
  cudaEventCreate(&a);
  cudaEventCreate(&z);
  launch();
  cudaEventRecord(a);
  launch();
  cudaEventRecord(z);
  cudaEventSynchronize(z);
  float ms;
  cudaEventElapsedTime(&ms, a, z);
  return ms;
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 512 * 4);
  const int iters = 4096;
  for (int warps : {1, 2, 4, 8, 16}) {
    const int th = 32 * warps;
    const double n = double(sms) * warps * iters;
    float ms = time_ms([&] { tf32_loop<8><<<sms, th>>>(out, iters); });
    printf("%2d warps/SM: tf32 m16n8k8 %.1f TFLOP/s", warps, n * 8 * 2048 / ms / 1e9);
    ms = time_ms([&] { bf16_loop<<<sms, th>>>(out, iters); });
    printf(", bf16 m16n8k16 %.1f TFLOP/s", n * 8 * 4096 / ms / 1e9);
    ms = time_ms([&] { ffma_loop<<<sms, th>>>(out, iters); });
    printf(", f32 FFMA %.1f TFLOP/s", n * 32 * 8 * 2 / ms / 1e9);
    ms = time_ms([&] { tf32_loop<1><<<sms, th>>>(out, iters); });
    printf(", dependent tf32 HMMA %.2f ns\n", ms * 1e6 / iters);
  }
  return 0;
}
'''


def card() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    return str(Path(CUDA_HOME) / 'bin' / 'nvcc')


def timer(fn, reps: int = 15) -> float:
    flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(b: int, h: int, t: int = 2048, k: int = 64):
    gen = torch.Generator(device='cuda').manual_seed(6)

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device='cuda') * scale

    logw = -2.5 + 2.495 * torch.rand((b, t, h, k), generator=gen,
                                     device='cuda')
    return [randn(b, t, h, k, scale=0.5), randn(b, t, h, k, scale=0.5),
            randn(b, t, h, k, scale=0.5), torch.exp(logw),
            randn(h, k, scale=0.3), randn(b, h, k, k, scale=0.1)]


def without(text: str, phases) -> str:
    """The kernel source with the statements of ``phases`` in ``#if 0``."""
    lines = text.split('\n')
    spans = []
    for phase in phases:
        for start, nth in PHASES[phase]:
            head = start.rstrip('\n')
            hits = [i for i, ln in enumerate(lines) if head in ln
                    and (not start.endswith('\n') or ln.rstrip().endswith(head))]
            i = j = hits[nth]
            depth = lines[i].count('{') - lines[i].count('}')
            if depth == 0:                 # a statement: up to its ';'
                while not lines[j].rstrip().endswith(';'):
                    j += 1
            else:                          # a block: up to its brace
                while depth > 0:
                    j += 1
                    depth += lines[j].count('{') - lines[j].count('}')
            if lines[i - 1].strip().startswith('#pragma'):
                i -= 1
            spans.append((i, j))
    for i, j in sorted(spans, reverse=True):
        lines.insert(j + 1, '#endif')
        lines.insert(i, '#if 0')
    return '\n'.join(lines)


def knockouts() -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    jobs = {}
    for i, (name, phases) in enumerate(VARIANTS.items()):
        src = BUILD / f'variant{i}.cu'
        src.write_text(without(text, phases))
        lib = BUILD / f'variant{i}.so'
        jobs[name] = (lib, subprocess.Popen(
            [nvcc(), *FLAGS, '-Xcompiler', '-fPIC', '-shared', '-I',
             str(SRC.parent), str(src), '-o', str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc failed\n{out}')
        fn = ctypes.CDLL(str(lib)).valve_wkv6
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fns[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    for b, h in ((4, 40), (3, 44)):
        xs = inputs(b, h)
        y, s = torch.empty_like(xs[2]), torch.empty_like(xs[5])
        ptrs = [x.data_ptr() for x in xs] + [y.data_ptr(), s.data_ptr()]
        for name, fn in fns.items():
            def call(fn=fn):
                assert fn(*ptrs, b, 2048, h, 64, 64, 0, stream) == 0
            print(f'knockouts, {b * h} CTAs, {name}: {timer(call):.4f} ms')


def scaling() -> None:
    from repro_torch.kernels.rwkv6.ops import wkv6
    for b, h in ((1, 33), (2, 33), (3, 44), (4, 40), (4, 50), (4, 66)):
        xs = inputs(b, h)
        print(f'scaling, {b * h} CTAs: {timer(lambda: wkv6(*xs)):.4f} ms')


def mma() -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    src, exe = BUILD / 'mma_rate.cu', BUILD / 'mma_rate'
    src.write_text(MMA_SRC)
    subprocess.run([nvcc(), *FLAGS, str(src), '-o', str(exe)], check=True)
    print(subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True).stdout, end='')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', choices=('knockouts', 'scaling', 'mma'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('wkv6_probe: no CUDA device', file=sys.stderr)
        return 1
    print(card())
    for name, run in (('knockouts', knockouts), ('scaling', scaling),
                      ('mma', mma)):
        if args.only in (None, name):
            run()
    return 0


if __name__ == '__main__':
    sys.exit(main())
