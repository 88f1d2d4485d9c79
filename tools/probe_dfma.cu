// FP64 FMA rate of one card, in two patterns: independent accumulators in
// registers (the DFMA units alone), and K8a's pattern (csrc/sinkhorn.cu),
// each K element read from shared memory at a row stride of 65 doubles and
// feeding two accumulators, two (u or v) values read from shared memory for
// each k.  Prints DFMA/s and DFMA a clock per SM at 132 SMs, at 16, 32 and
// 64 resident warps an SM.  It is the measurement behind K8a's design
// ceiling (about 28 DFMA a clock per SM from shared memory, PERF.md), and
// stays so that a redesign of K8a can be held against the same probe.
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -std=c++17 -o build/probe_dfma tools/probe_dfma.cu && build/probe_dfma
#include <cstdio>
#include <cuda_runtime.h>

template <int ACC>
__global__ void reg_fma(double* out, int iters, double a, double b) {
  double acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = threadIdx.x + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = fma(acc[i], a, b);
  }
  double s = 0;
#pragma unroll
  for (int i = 0; i < ACC; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int ACC>
__global__ void smem_fma(double* out, int iters) {
  __shared__ double K[64 * 65];
  for (int i = threadIdx.x; i < 64 * 65; i += blockDim.x) K[i] = 1.0 / (i + 1);
  __syncthreads();
  double acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  const int tx = threadIdx.x % 8;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int k = 0; k < 64; ++k) {
      const double w0 = K[(threadIdx.x / 8) % 64 + k * 65];
      const double w1 = K[(threadIdx.x / 8 + 1) % 64 + k * 65];
#pragma unroll
      for (int j = 0; j < ACC / 2; ++j) {
        const double m = K[(8 * j + tx) * 65 + k];
        acc[2 * j] = fma(w0, m, acc[2 * j]);
        acc[2 * j + 1] = fma(w1, m, acc[2 * j + 1]);
      }
    }
  }
  double s = 0;
#pragma unroll
  for (int i = 0; i < ACC; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename F>
void run(const char* name, F launch, double dfma) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  cudaEventRecord(a);
  launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  int clk;
  cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  printf("%-28s %8.3f ms  %.3e DFMA/s  %.1f DFMA/clk/SM at %d MHz  err %s\n", name, ms,
         dfma / (ms * 1e-3), dfma / (ms * 1e-3) / 132 / (clk * 1e3), clk / 1000,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  double* out;
  cudaMalloc(&out, 132 * 64 * 1024 * sizeof(double));
  const int iters = 20000;
  for (int blocksPerSM : {2, 4, 8}) {
    const int blocks = 132 * blocksPerSM, threads = 256;
    char name[64];
    snprintf(name, 64, "reg 16 acc, %d warps/SM", blocksPerSM * 8);
    run(name, [&] { reg_fma<16><<<blocks, threads>>>(out, iters, 0.999, 0.001); },
        double(blocks) * threads * iters * 16);
    snprintf(name, 64, "reg 4 acc, %d warps/SM", blocksPerSM * 8);
    run(name, [&] { reg_fma<4><<<blocks, threads>>>(out, iters, 0.999, 0.001); },
        double(blocks) * threads * iters * 4);
    snprintf(name, 64, "smem 16 acc, %d warps/SM", blocksPerSM * 8);
    run(name, [&] { smem_fma<16><<<blocks, threads>>>(out, iters / 64); },
        double(blocks) * threads * (iters / 64) * 64 * 16);
    snprintf(name, 64, "smem 4 acc, %d warps/SM", blocksPerSM * 8);
    run(name, [&] { smem_fma<4><<<blocks, threads>>>(out, iters / 64); },
        double(blocks) * threads * (iters / 64) * 64 * 4);
  }
  return 0;
}
