// The FP64 tensor cores' sum order and rate on one card.  K8a
// (annchor_tpu_torch/csrc/sinkhorn.cu) chains `mma.sync ... f64` over k in
// steps of 8 (m16n8k8) or 4 (m16n8k4) and is held bit for bit to a torch
// model of its sums
// (`exp_chunk_model` in annchor_tpu_torch/ops/sinkhorn_cuda.py), so the
// model has to repeat whatever order the hardware adds in.
//
// Part 1, the order.  Each warp chains S k-steps of one mma shape on
// float32 values held in float64 (every product exact, as in K8a), from an
// initial accumulator C, and the host compares each of the 64 (or 128)
// outputs with six candidate orders for one step d = c + a0 b0 + ... +
// a3 b3 (for k 8 and 16, the step's terms in groups of 4):
//   fma     fma(a3, b3, fma(a2, b2, fma(a1, b1, fma(a0, b0, c)))), k order
//   fma_rev the same chain from a3 b3 down to a0 b0
//   exact   c + the four products, exact, rounded once
//   grp+c   the four products summed exactly and rounded, then added to c
//   pair+c  (a0 b0 + a1 b1) + (a2 b2 + a3 b3), each rounded, then + c
//   seq+c   ((a0 b0 + a1 b1) + a2 b2) + a3 b3, each rounded, then + c
// Exact sums are taken on the host in 128-bit fixed point (the inputs are
// drawn so that every value is a multiple of 2^-108 below 2^7).  The
// input families: uniform in [-1, 1); positive (K8a's case); cancelling
// terms; terms 2^-30 to 2^-60 below a leading one; and an accumulator not
// in float32 with terms near half its ulp.  Prints the share of outputs
// each candidate matches bit for bit, per family and shape, and the first
// mismatches of the "fma" order.
//
// Part 2, the rate: independent mma chains in registers per warp, as FMA
// a clock per SM at 132 SMs and the card's reported clock, for m8n8k4,
// m16n8k4, m16n8k8 and m16n8k16, against the 128 FMA a clock per SM of
// the FP64 tensor cores' peak.
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -std=c++17 -o build/probe_dmma tools/probe_dmma.cu && build/probe_dmma
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#include <cuda_runtime.h>

// ------------------------------------------------------------- the mma ----

__device__ __forceinline__ void mma884(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

__device__ __forceinline__ void mma1684(double (&d)[4], const double (&a)[2], double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

__device__ __forceinline__ void mma1688(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void mma16816(double (&d)[4], const double (&a)[8],
                                         const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// One case a warp: A (M, KT) row-major, B (KT, 8) row-major, C and D (M, 8);
// KT = S k.  The fragments as the PTX ISA lays them out for .f64:
// g = lane / 4, t = lane % 4; A element (g + 8 i, t + 4 j), B (t + 4 j, g),
// C (g + 8 (i / 2), 2 t + i % 2).
template <int M, int K>
__global__ void chain(const double* A, const double* B, const double* C, double* D, int S) {
  const int cs = blockIdx.x;
  const int lane = threadIdx.x;
  const int g = lane / 4, t = lane % 4;
  const int KT = S * K;
  const double* a = A + static_cast<size_t>(cs) * M * KT;
  const double* b = B + static_cast<size_t>(cs) * KT * 8;
  const double* c = C + static_cast<size_t>(cs) * M * 8;
  double* d = D + static_cast<size_t>(cs) * M * 8;
  if (M == 8) {
    double d0 = c[g * 8 + 2 * t], d1 = c[g * 8 + 2 * t + 1];
    for (int s = 0; s < S; ++s) mma884(d0, d1, a[g * KT + 4 * s + t], b[(4 * s + t) * 8 + g]);
    d[g * 8 + 2 * t] = d0;
    d[g * 8 + 2 * t + 1] = d1;
    return;
  }
  double acc[4];
  for (int i = 0; i < 4; ++i) acc[i] = c[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2];
  for (int s = 0; s < S; ++s) {
    const int k0 = K * s;
    if (K == 4) {
      const double af[2] = {a[g * KT + k0 + t], a[(g + 8) * KT + k0 + t]};
      mma1684(acc, af, b[(k0 + t) * 8 + g]);
    } else if (K == 8) {
      double af[4], bf[2];
      for (int i = 0; i < 4; ++i) af[i] = a[(g + 8 * (i % 2)) * KT + k0 + t + 4 * (i / 2)];
      for (int j = 0; j < 2; ++j) bf[j] = b[(k0 + t + 4 * j) * 8 + g];
      mma1688(acc, af, bf);
    } else {
      double af[8], bf[4];
      for (int i = 0; i < 8; ++i) af[i] = a[(g + 8 * (i % 2)) * KT + k0 + t + 4 * (i / 2)];
      for (int j = 0; j < 4; ++j) bf[j] = b[(k0 + t + 4 * j) * 8 + g];
      mma16816(acc, af, bf);
    }
  }
  for (int i = 0; i < 4; ++i) d[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = acc[i];
}

// ----------------------------------------------------- exact host sums ----

using i128 = __int128;
constexpr int kLsb = 108;  // every value is a multiple of 2^-108

i128 fix(double x) { return static_cast<i128>(std::ldexp(x, kLsb)); }

// round a fixed-point value to the nearest double, ties to even
double rn(i128 v) {
  if (v == 0) return 0.0;
  const bool neg = v < 0;
  unsigned __int128 m = neg ? -static_cast<unsigned __int128>(v) : v;
  int nb = 0;
  for (unsigned __int128 x = m; x; x >>= 1) ++nb;
  int shift = nb > 53 ? nb - 53 : 0;
  unsigned __int128 q = m >> shift;
  if (shift) {
    const unsigned __int128 rem = m & ((static_cast<unsigned __int128>(1) << shift) - 1);
    const unsigned __int128 half = static_cast<unsigned __int128>(1) << (shift - 1);
    if (rem > half || (rem == half && (q & 1))) ++q;
  }
  const double r = std::ldexp(static_cast<double>(static_cast<uint64_t>(q)), shift - kLsb);
  return neg ? -r : r;
}

double add(double x, double y) { return rn(fix(x) + fix(y)); }

const char* kOrders[] = {"fma", "fma_rev", "exact", "grp+c", "pair+c", "seq+c"};
constexpr int kNOrders = 6;

// one step of 4 terms under each order
double step(int order, double c, const double* a, const double* b) {
  double p[4];
  for (int i = 0; i < 4; ++i) p[i] = a[i] * b[i];  // exact: float32 x float32
  switch (order) {
    case 0: {
      double d = c;
      for (int i = 0; i < 4; ++i) d = std::fma(a[i], b[i], d);
      return d;
    }
    case 1: {
      double d = c;
      for (int i = 3; i >= 0; --i) d = std::fma(a[i], b[i], d);
      return d;
    }
    case 2:
      return rn(fix(c) + fix(p[0]) + fix(p[1]) + fix(p[2]) + fix(p[3]));
    case 3:
      return add(c, rn(fix(p[0]) + fix(p[1]) + fix(p[2]) + fix(p[3])));
    case 4:
      return add(add(add(p[0], p[1]), add(p[2], p[3])), c);
    default:
      return add(add(add(add(p[0], p[1]), p[2]), p[3]), c);
  }
}

// ----------------------------------------------------------- the inputs ----

struct Gen {
  std::mt19937_64 rng{20261017};
  double uni() { return std::uniform_real_distribution<double>(0.0, 1.0)(rng); }
  // a float32 value of magnitude in [2^lo, 2^hi), random sign unless pos
  double f32(int lo, int hi, bool pos) {
    const double e = lo + (hi - lo) * uni();
    const float v = static_cast<float>(std::exp2(e));
    return (pos || uni() < 0.5) ? v : -v;
  }
};

// family: 0 uniform, 1 positive, 2 cancelling, 3 tiny terms, 4 odd
// accumulator with half-ulp terms
void make_case(Gen& gen, int fam, int M, int KT, double* A, double* B, double* C) {
  for (int r = 0; r < M; ++r)
    for (int k = 0; k < KT; ++k) {
      double a;
      switch (fam) {
        case 0: a = static_cast<float>(2.0 * gen.uni() - 1.0); break;
        case 1: a = gen.f32(-12, 0, true); break;
        case 2: a = gen.f32(-3, 0, false); break;
        case 3: a = k % 4 == 0 && k / 4 == r % (KT / 4) ? gen.f32(-1, 0, false)
                                                        : gen.f32(-30, -15, false);
                break;
        default: a = gen.f32(-27, -26, false); break;
      }
      A[r * KT + k] = a;
    }
  for (int k = 0; k < KT; ++k)
    for (int c = 0; c < 8; ++c) {
      double b;
      switch (fam) {
        case 0: b = static_cast<float>(2.0 * gen.uni() - 1.0); break;
        case 1: b = gen.f32(-20, 0, true); break;
        case 2: b = gen.f32(-3, 0, false); break;
        case 3: b = k % 4 == 0 ? gen.f32(-1, 0, false) : gen.f32(-30, -15, false); break;
        default: b = gen.f32(-27, -26, false); break;
      }
      B[k * 8 + c] = b;
    }
  if (fam == 2) {
    // a1 b1 = -a0 b0 exactly in half the rows' first groups: the group's
    // sum cancels its leading terms
    for (int r = 0; r < M; r += 2)
      for (int s = 0; s < KT; s += 4) A[r * KT + s + 1] = -A[r * KT + s] * (s % 8 == 0);
    for (int s = 0; s < KT; s += 4)
      for (int c = 0; c < 8; ++c) B[(s + 1) * 8 + c] = B[s * 8 + c];
  }
  for (int i = 0; i < M * 8; ++i) {
    if (fam == 4) {
      // a double with all 53 bits, magnitude in [1, 2): each term is near
      // 2^-53 of it, about half its ulp
      C[i] = 1.0 + std::ldexp(std::floor(gen.uni() * 4503599627370496.0), -52);
    } else {
      C[i] = fam == 3 ? 0.0 : (i % 3 == 0 ? 0.0 : static_cast<float>(gen.uni()));
    }
  }
}

template <int M, int K>
void order_test(const char* shape, int S) {
  const int KT = S * K, ncase = 256;
  const char* fams[] = {"uniform", "positive", "cancel", "tiny", "half-ulp"};
  std::vector<double> A(ncase * M * KT), B(ncase * KT * 8), C(ncase * M * 8), D(ncase * M * 8);
  double *dA, *dB, *dC, *dD;
  cudaMalloc(&dA, A.size() * 8);
  cudaMalloc(&dB, B.size() * 8);
  cudaMalloc(&dC, C.size() * 8);
  cudaMalloc(&dD, D.size() * 8);
  Gen gen;
  for (int fam = 0; fam < 5; ++fam) {
    for (int cs = 0; cs < ncase; ++cs)
      make_case(gen, fam, M, KT, &A[cs * M * KT], &B[cs * KT * 8], &C[cs * M * 8]);
    cudaMemcpy(dA, A.data(), A.size() * 8, cudaMemcpyHostToDevice);
    cudaMemcpy(dB, B.data(), B.size() * 8, cudaMemcpyHostToDevice);
    cudaMemcpy(dC, C.data(), C.size() * 8, cudaMemcpyHostToDevice);
    chain<M, K><<<ncase, 32>>>(dA, dB, dC, dD, S);
    const cudaError_t err = cudaDeviceSynchronize();
    cudaMemcpy(D.data(), dD, D.size() * 8, cudaMemcpyDeviceToHost);
    long long hit[kNOrders] = {0}, total = 0, shown = 0;
    for (int cs = 0; cs < ncase; ++cs)
      for (int r = 0; r < M; ++r)
        for (int c = 0; c < 8; ++c) {
          const double got = D[(cs * M + r) * 8 + c];
          ++total;
          for (int o = 0; o < kNOrders; ++o) {
            double acc = C[(cs * M + r) * 8 + c];
            for (int k0 = 0; k0 < KT; k0 += 4) {
              double a[4], b[4];
              for (int i = 0; i < 4; ++i) {
                a[i] = A[(cs * M + r) * KT + k0 + i];
                b[i] = B[(cs * KT + k0 + i) * 8 + c];
              }
              acc = step(o, acc, a, b);
            }
            if (std::memcmp(&acc, &got, 8) == 0) {
              ++hit[o];
            } else if (o == 0 && shown < 3) {
              ++shown;
              printf("  %s %s case %d (%d, %d): mma %.17g, fma order %.17g\n", shape, fams[fam],
                     cs, r, c, got, acc);
            }
          }
        }
    printf("%-9s S %d %-9s %s:", shape, S, fams[fam], cudaGetErrorString(err));
    for (int o = 0; o < kNOrders; ++o) printf("  %s %.4f", kOrders[o], double(hit[o]) / total);
    printf("\n");
  }
  cudaFree(dA);
  cudaFree(dB);
  cudaFree(dC);
  cudaFree(dD);
}

// ------------------------------------------------------------- the rate ----

template <int SHAPE, int NACC>
__global__ void rate(double* out, int iters) {
  const double x = 1.0 + threadIdx.x * 1e-9;
  double acc[NACC][4];
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0;
  double a[8], b[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = x + i;
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = x - i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if (SHAPE == 0) {
        mma884(acc[j][0], acc[j][1], a[j % 8], b[j % 4]);
      } else if (SHAPE == 1) {
        const double af[2] = {a[0], a[1]};
        mma1684(acc[j], af, b[0]);
      } else if (SHAPE == 2) {
        const double af[4] = {a[0], a[1], a[2], a[3]};
        const double bf[2] = {b[0], b[1]};
        mma1688(acc[j], af, bf);
      } else {
        mma16816(acc[j], a, b);
      }
    }
  }
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s += acc[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int SHAPE, int NACC>
void rate_test(const char* name, int fma_per_mma, int warps_per_sm) {
  double* out;
  const int threads = 128, blocks = 132 * warps_per_sm / 4, iters = 4000;
  cudaMalloc(&out, static_cast<size_t>(blocks) * threads * 8);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rate<SHAPE, NACC><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e0);
  rate<SHAPE, NACC><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  int clk;
  cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  const double fma = double(blocks) * (threads / 32) * iters * NACC * fma_per_mma;
  printf("%-9s %d chains, %2d warps/SM: %8.3f ms  %.3e FMA/s  %.1f FMA/clk/SM at %d MHz  %s\n",
         name, NACC, warps_per_sm, ms, fma / (ms * 1e-3), fma / (ms * 1e-3) / 132 / (clk * 1e3),
         clk / 1000, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  order_test<8, 4>("m8n8k4", 1);
  order_test<8, 4>("m8n8k4", 16);
  order_test<16, 4>("m16n8k4", 16);
  order_test<16, 8>("m16n8k8", 8);
  order_test<16, 16>("m16n8k16", 4);
  for (int w : {4, 8, 16, 32}) {
    rate_test<0, 4>("m8n8k4", 256, w);
    rate_test<0, 8>("m8n8k4", 256, w);
    rate_test<1, 4>("m16n8k4", 512, w);
    rate_test<2, 4>("m16n8k8", 1024, w);
    rate_test<3, 4>("m16n8k16", 2048, w);
  }
  return 0;
}
