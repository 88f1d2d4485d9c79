// K8: the Sinkhorn loop of the Wasserstein metrics, one launch per chunk of
// pairs, in two entry points.
//
// K8a (annchor_k8a_exp), the exp-domain loop: the scout of the
// scout/certify hybrid and its max-min anchors.  For each pair q, with
// A = Xn[I[q]], B = Zn[J[q]] and v = 1: n_iter times
// u = A / max(v K^T, TINY), v = B / max(u K, TINY); then u once more; and
// out[q] = sum_i u_i (v KC^T)_i.  It replaces the XLA program
// `_sinkhorn_exp_chunk` of annchor_tpu/ops/wasserstein.py (also run inside
// `_sinkhorn_maxmin`), not a Pallas kernel.  Its plain PyTorch version is
// `sinkhorn_exp_chunk_plain` in annchor_tpu_torch/ops/wasserstein.py, which
// launches 8 kernels an iteration (2,400 a chunk at n_iter 300); the
// wrapper is ops/sinkhorn_cuda.py.
//
// K8b (annchor_k8b_log), the log-domain loop of the `wasserstein_sinkhorn`
// metric: n_iter times f = eps (log A - LSE_j(-C/eps + g/eps)),
// g = eps (log B - LSE_i(-C/eps + f/eps)); out = sum_ij
// exp(-C/eps + f/eps + g/eps) C_ij.  It replaces `_sinkhorn_batch`; its
// plain version `sinkhorn_batch_plain` builds (B, n, n) temporaries for
// each LSE.
//
// The numbers.  K8a keeps the plain version's contract: float32 operands;
// each product term exact in float64 (a 24-bit by 24-bit product), so an
// FMA is the plain version's multiply and add; the sum over k = 0..n-1 in
// float64, in that order, rounded once to float32 (__double2float_rn);
// clamped below at TINY as torch's clamp does (a NaN passes); one IEEE
// float32 division.  The cost's v KC^T, its product with u and the sums in
// float64, rounded once.  `exp_chunk_model` in ops/sinkhorn_cuda.py repeats
// these operations in this order with torch, bit for bit.  cuBLAS sums in
// another order, so a rare entry rounds to the other float32 neighbour:
// the kernel is held to its plain version to rtol 2e-6.  K8b repeats the
// plain version's float32 formula as PyTorch runs it on a card: x / eps is
// x * (1 / eps) (PyTorch's division of a tensor by a Python scalar on a
// card), each LSE a row max (taken as 0 where it is infinite), the sum of
// expf(x - max) over the row in order, logf, the max added back, with the
// accurate expf and logf and no contraction (the __f*_rn intrinsics); the
// closing sum of exp(logP) C in float64.  Only the order of its float32
// sums differs from the plain version's.  No fast math, no flush to zero.
//
// What bounds it on the H100.  K8a: (2 n_iter + 2) n^2 FP64 FMA a pair.
// The card's FP64 peak is its tensor cores' 128 FMA a clock per SM, 132 x
// 128 x 1.98e9 = 3.35e13 a second: 0.60 ms for an 8,192-pair chunk of the
// digits (n 64, n_iter 300); at the DFMA units' 64 lanes, which this kernel
// uses, 1.21 ms.  The bytes (two histogram rows and a cost a pair) are
// negligible.  K8b: (2 n_iter + 1) n^2 expf a pair, one MUFU.EX2 each at 16
// a clock per SM, 4.18e12 a second: 1.61 ms for a 4,096-pair chunk at
// n_iter 200.
//
// The design.  One block runs P pairs through every iteration; only the
// costs leave the chip.  K8a stages K (and KC for the closing product) in
// shared memory once, as float64: K and K^T, (npad, npad + 2) each, so that
// both products (v K^T reads K by rows of the output index, u K by
// columns) read an output row along k, two k in one 16-byte load.  u and
// v live in shared memory as float64 [k][pair] rows; each thread owns a
// register tile of 2 pairs x RC output columns c = c0 + TX j + tx, so a K
// pair loaded from shared memory feeds 4 FMA and a (u or v) pair RC
// columns: RC = 2 or 4, the launch plan choosing by batch size, and 8 where
// a pair's columns would need more threads than a block has.  Above 2,048
// bins a thread takes its columns in passes of TX RC (c0 = 0, TX RC, ...).
// Shared-memory loads, not the FP64 units, bound this design
// (tools/probe_dfma.cu).  Above 112 bins K is read from global memory
// through L1 and L2 in the same kernel; above 7,136 bins, where u and v
// of two pairs no longer fit shared memory, they live in a global
// workspace of the block's own (L2).  K8b stages -C/eps in an
// (n, n + 1 | 1) float32 layout for the same reason; G threads (a
// multiple of 32) share a pair, each owning outputs o = t, t + G, ...;
// f/eps and g/eps stay in shared memory, or above 14,400 bins in a global
// workspace of the block's own.  The launch plan is
// ops/sinkhorn_cuda.exp_plan / log_plan.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block can have

// ---------------------------------------------------------------- K8a ----

// float64 slots of the resident K: two (npad, npad + 2) copies, K and K^T
__host__ __device__ inline size_t exp_k_doubles(int npad, bool resident) {
  return resident ? 2 * static_cast<size_t>(npad) * (npad + 2) : 0;
}

// float64 slots of u and v of a block's P pairs, (npad, P) each
__host__ __device__ inline size_t exp_uv_doubles(int npad, int P) {
  return 2 * static_cast<size_t>(npad) * P;
}

// shared memory of a block: K (resident), u and v (unless global), the
// cost's partial sums (P, TX)
inline size_t exp_smem(int npad, int TX, int P, bool resident, bool global_uv) {
  return sizeof(double) * (exp_k_doubles(npad, resident) +
                           (global_uv ? 0 : exp_uv_doubles(npad, P)) +
                           static_cast<size_t>(P) * TX);
}

// Stage an (n, n) float64 matrix M, zero beyond n, as Ks[c][k] = M[c][k]
// and, with kBoth, Ks[npad + c][k] = M[k][c]: each product then reads its
// output row c along k, two k at a time.  The even row stride npad + 2
// (npad a multiple of 8) puts the 16-byte pairs of 8 consecutive rows in
// 8 distinct bank groups.
template <bool kBoth>
__device__ inline void stage_k(double* Ks, const double* __restrict__ M, int n, int npad) {
  const int ldk = npad + 2;
  for (int idx = threadIdx.x; idx < npad * npad; idx += blockDim.x) {
    const int r = idx / npad;
    const int c = idx - r * npad;
    const double v = (r < n && c < n) ? __ldg(M + static_cast<size_t>(r) * n + c) : 0.0;
    Ks[r * ldk + c] = v;
    if (kBoth) Ks[(npad + c) * ldk + r] = v;
  }
}

// acc[pp][j] = sum over k = 0..n-1, in order, of w[k][2 ty + pp] * M(c, k),
// c = c0 + TX j + tx, with M(c, k) = Mat[c][k] (kRowC: v K^T, v KC^T) or
// Mat[k][c] (u K).  Mat is Ks in shared memory (kRowC its first copy, else
// its transposed one) or, not resident, Mg.  Two k a step: n rounded up to
// even meets the zero padding of K and of the w rows, which adds nothing.
template <int RC, bool kResident, bool kRowC>
__device__ __forceinline__ void product(double (&acc)[2][RC], const double* Ws, const double* Ks,
                                        const double* __restrict__ Mg, int n, int npad, int P,
                                        int c0, int TX, int tx, int ty) {
  const int ldk = npad + 2;
  const double* R = kRowC ? Ks : Ks + static_cast<size_t>(npad) * ldk;
#pragma unroll
  for (int j = 0; j < RC; ++j) acc[0][j] = acc[1][j] = 0.0;
#pragma unroll 2
  for (int k = 0; k < n; k += 2) {
    const double2 w0 = *reinterpret_cast<const double2*>(Ws + static_cast<size_t>(k) * P + 2 * ty);
    const double2 w1 =
        *reinterpret_cast<const double2*>(Ws + static_cast<size_t>(k + 1) * P + 2 * ty);
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int c = c0 + TX * j + tx;
      double2 m;
      if (kResident) {
        m = *reinterpret_cast<const double2*>(R + c * ldk + k);
      } else {
        const bool in0 = c < n;
        const bool in1 = c < n && k + 1 < n;
        m.x = in0 ? __ldg(Mg + (kRowC ? static_cast<size_t>(c) * n + k
                                      : static_cast<size_t>(k) * n + c))
                  : 0.0;
        m.y = in1 ? __ldg(Mg + (kRowC ? static_cast<size_t>(c) * n + k + 1
                                      : static_cast<size_t>(k + 1) * n + c))
                  : 0.0;
      }
      acc[0][j] = fma(w0.x, m.x, acc[0][j]);
      acc[1][j] = fma(w0.y, m.x, acc[1][j]);
      acc[0][j] = fma(w1.x, m.y, acc[0][j]);
      acc[1][j] = fma(w1.y, m.y, acc[1][j]);
    }
  }
}

// W[c][2 ty + pp] = hist_pp[c] / max(float32(acc), tiny) over the thread's
// tile (hist_0 = h0, hist_1 = h1); a pair past the batch (its row null)
// and a padding column get 0.
template <int RC>
__device__ __forceinline__ void scale(const double (&acc)[2][RC], double* W, const float* h0,
                                      const float* h1, int n, int P, int c0, int TX, int tx,
                                      int ty, float tiny) {
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    const float* hist = pp ? h1 : h0;
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int c = c0 + TX * j + tx;
      float y = __double2float_rn(acc[pp][j]);
      y = y < tiny ? tiny : y;
      const float h = (hist != nullptr && c < n) ? __ldg(hist + c) : 0.0f;
      W[static_cast<size_t>(c) * P + 2 * ty + pp] = static_cast<double>(__fdiv_rn(h, y));
    }
  }
}

// the most threads a K8a block has: 512 for the 2-column tile, 256 else
#define K8A_MAX_THREADS(RC) ((RC) == 2 ? 512 : 256)

// kPasses: a thread takes its columns in passes of TXp RC (else in one);
// kGlobalUV: u and v in the block's slice of the global workspace ws, not
// in shared memory
template <int RC, bool kResident, bool kPasses, bool kGlobalUV>
__global__ void __launch_bounds__(K8A_MAX_THREADS(RC))
k8a_exp(const float* __restrict__ Xn, const float* __restrict__ Zn,
        const long long* __restrict__ I, long long sI, const long long* __restrict__ J,
        long long sJ, const double* __restrict__ K, const double* __restrict__ KC, int B,
        int n, int npad, int TXp, int P, int n_iter, float tiny, double* ws,
        float* __restrict__ out) {
  extern __shared__ __align__(16) double smem8[];
  double* Ks = smem8;
  double* Us = kGlobalUV ? ws + blockIdx.x * exp_uv_doubles(npad, P)
                         : smem8 + exp_k_doubles(npad, kResident);  // [npad][P]
  double* Vs = Us + static_cast<size_t>(npad) * P;                   // [npad][P]
  double* part = kGlobalUV ? smem8 : Vs + static_cast<size_t>(npad) * P;  // [P][TX]
  // TX from npad and the compile-time RC where there is one pass: taken
  // from the argument, it made the 2-column tile measurably slower on the
  // H100
  const int TX = kPasses ? TXp : npad / RC;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  // the column passes: c0 = 0, TX RC, ... below npad, or c0 = 0 alone
  const int cend = kPasses ? npad : 1;
  const int step = kPasses ? TX * RC : 1;
  const long long q0 = static_cast<long long>(blockIdx.x) * P;

  // the histogram rows of the thread's two pairs, null past the batch
  const long long q = q0 + 2 * ty;
  const float* a0 = q < B ? Xn + static_cast<size_t>(I[q * sI]) * n : nullptr;
  const float* b0 = q < B ? Zn + static_cast<size_t>(J[q * sJ]) * n : nullptr;
  const float* a1 = q + 1 < B ? Xn + static_cast<size_t>(I[(q + 1) * sI]) * n : nullptr;
  const float* b1 = q + 1 < B ? Zn + static_cast<size_t>(J[(q + 1) * sJ]) * n : nullptr;
  if (kResident) stage_k<true>(Ks, K, n, npad);
  for (int idx = tid; idx < npad * P; idx += blockDim.x) Vs[idx] = idx / P < n ? 1.0 : 0.0;
  __syncthreads();

  // each half step reads only one of u, v and writes the other
  double acc[2][RC];
  for (int it = 0; it < n_iter; ++it) {
    for (int c0 = 0; c0 < cend; c0 += step) {
      product<RC, kResident, true>(acc, Vs, Ks, K, n, npad, P, c0, TX, tx, ty);
      scale<RC>(acc, Us, a0, a1, n, P, c0, TX, tx, ty, tiny);
    }
    __syncthreads();
    for (int c0 = 0; c0 < cend; c0 += step) {
      product<RC, kResident, false>(acc, Us, Ks, K, n, npad, P, c0, TX, tx, ty);
      scale<RC>(acc, Vs, b0, b1, n, P, c0, TX, tx, ty, tiny);
    }
    __syncthreads();
  }
  for (int c0 = 0; c0 < cend; c0 += step) {
    product<RC, kResident, true>(acc, Vs, Ks, K, n, npad, P, c0, TX, tx, ty);
    scale<RC>(acc, Us, a0, a1, n, P, c0, TX, tx, ty, tiny);
  }
  __syncthreads();

  // the cost: sum_c u_c (v KC^T)_c, each thread over its columns in order
  // (c0, then j), then the block over the threads of each pair in order
  if (kResident) {
    stage_k<false>(Ks, KC, n, npad);
    __syncthreads();
  }
  double s[2] = {0.0, 0.0};
  for (int c0 = 0; c0 < cend; c0 += step) {
    product<RC, kResident, true>(acc, Vs, Ks, KC, n, npad, P, c0, TX, tx, ty);
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int c = c0 + TX * j + tx;
        s[pp] = __dadd_rn(s[pp],
                          __dmul_rn(Us[static_cast<size_t>(c) * P + 2 * ty + pp], acc[pp][j]));
      }
    }
  }
  part[(2 * ty) * TX + tx] = s[0];
  part[(2 * ty + 1) * TX + tx] = s[1];
  __syncthreads();
  // a block has TX P / 2 threads, fewer than P where TX is 1
  for (int p = tid; p < P && q0 + p < B; p += blockDim.x) {
    double t = 0.0;
    for (int x = 0; x < TX; ++x) t = __dadd_rn(t, part[p * TX + x]);
    out[q0 + p] = __double2float_rn(t);
  }
}

// ---------------------------------------------------------------- K8b ----

// the row stride of -C/eps in shared memory: odd, so that a warp reading a
// column (32 rows) or a row hits 32 banks
__host__ __device__ inline int log_ldc(int n) { return n + 1 + (n & 1); }

// float32 slots of a block's f/eps, g/eps, log A and log B: (P, n) each
__host__ __device__ inline size_t log_vec_floats(int n, int P) {
  return 4 * static_cast<size_t>(P) * n;
}

inline size_t log_smem(int n, int P, int G, bool resident, bool global_v) {
  size_t f = resident ? static_cast<size_t>(n) * log_ldc(n) : 0;
  f += global_v ? 0 : log_vec_floats(n, P);
  f += f & 1;  // 8-byte alignment of the partial sums
  return f * sizeof(float) + static_cast<size_t>(P) * G * sizeof(double);
}

template <bool kResident>
__device__ __forceinline__ float negc(const float* Ns, const float* __restrict__ C, int n,
                                      int ldc, int i, int j, float inv) {
  return kResident ? Ns[i * ldc + j] : __fmul_rn(-__ldg(C + static_cast<size_t>(i) * n + j), inv);
}

// One potential (over eps) at output o: eps (logh - LSE_k x_k) / eps with
// x_k = -C/eps[o][k] + other_k (kRow: the f update) or -C/eps[k][o] +
// other_k (the g update), as PyTorch computes it.
template <bool kResident, bool kRow>
__device__ __forceinline__ float lse_update(const float* Ns, const float* __restrict__ C,
                                            const float* other, float logh, int o, int n,
                                            int ldc, float eps, float inv) {
  float mx = -INFINITY;
  for (int k = 0; k < n; ++k) {
    const float x = __fadd_rn(kRow ? negc<kResident>(Ns, C, n, ldc, o, k, inv)
                                   : negc<kResident>(Ns, C, n, ldc, k, o, inv),
                              other[k]);
    mx = fmaxf(mx, x);
  }
  if (isinf(mx)) mx = 0.0f;
  float s = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float x = __fadd_rn(kRow ? negc<kResident>(Ns, C, n, ldc, o, k, inv)
                                   : negc<kResident>(Ns, C, n, ldc, k, o, inv),
                              other[k]);
    s = __fadd_rn(s, expf(__fsub_rn(x, mx)));
  }
  const float lse = __fadd_rn(logf(s), mx);
  return __fmul_rn(__fmul_rn(eps, __fsub_rn(logh, lse)), inv);
}

// kGlobalV: f/eps, g/eps, log A and log B in the block's slice of the
// global workspace ws, not in shared memory
template <bool kResident, bool kGlobalV>
__global__ void __launch_bounds__(256)
k8b_log(const float* __restrict__ A, const float* __restrict__ Bh, const float* __restrict__ C,
        int m, int n, int P, int G, float eps, float inv, int n_iter, float* ws,
        float* __restrict__ out) {
  extern __shared__ __align__(16) float smem4[];
  const int ldc = log_ldc(n);
  const size_t kf = kResident ? static_cast<size_t>(n) * ldc : 0;
  float* Ns = smem4;
  float* F = kGlobalV ? ws + blockIdx.x * log_vec_floats(n, P) : smem4 + kf;  // f / eps, [P][n]
  float* Gp = F + static_cast<size_t>(P) * n;
  float* LA = Gp + static_cast<size_t>(P) * n;
  float* LB = LA + static_cast<size_t>(P) * n;
  size_t off = kf + (kGlobalV ? 0 : log_vec_floats(n, P));
  off += off & 1;
  double* part = reinterpret_cast<double*>(smem4 + off);  // [P][G]
  const int tid = threadIdx.x;
  const int p = tid / G;
  const int t = tid - p * G;
  const long long q0 = static_cast<long long>(blockIdx.x) * P;

  if (kResident) {
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      const int r = idx / n;
      Ns[r * ldc + idx - r * n] = __fmul_rn(-__ldg(C + idx), inv);
    }
  }
  for (int idx = tid; idx < P * n; idx += blockDim.x) {
    const long long q = q0 + idx / n;
    const int c = idx % n;
    const float a = q < m ? __ldg(A + q * n + c) : 0.0f;
    const float b = q < m ? __ldg(Bh + q * n + c) : 0.0f;
    // log(where(A > 0, A, 1)) + where(A > 0, 0, -1e9)
    LA[idx] = a > 0.0f ? logf(a) : -1e9f;
    LB[idx] = b > 0.0f ? logf(b) : -1e9f;
    F[idx] = 0.0f;
    Gp[idx] = 0.0f;
  }
  __syncthreads();

  float* Fp = F + static_cast<size_t>(p) * n;
  float* Gq = Gp + static_cast<size_t>(p) * n;
  for (int it = 0; it < n_iter; ++it) {
    for (int o = t; o < n; o += G)
      Fp[o] = lse_update<kResident, true>(Ns, C, Gq, LA[p * n + o], o, n, ldc, eps, inv);
    __syncthreads();
    for (int o = t; o < n; o += G)
      Gq[o] = lse_update<kResident, false>(Ns, C, Fp, LB[p * n + o], o, n, ldc, eps, inv);
    __syncthreads();
  }

  // sum_ij exp((-C/eps + f/eps) + g/eps) C_ij, in float64
  double s = 0.0;
  for (int i = t; i < n; i += G) {
    const float fi = Fp[i];
    for (int j = 0; j < n; ++j) {
      const float x = __fadd_rn(__fadd_rn(negc<kResident>(Ns, C, n, ldc, i, j, inv), fi), Gq[j]);
      s += static_cast<double>(__fmul_rn(expf(x), __ldg(C + static_cast<size_t>(i) * n + j)));
    }
  }
  part[tid] = s;
  __syncthreads();
  if (t == 0 && q0 + p < m) {
    double tot = 0.0;
    for (int x = 0; x < G; ++x) tot += part[p * G + x];
    out[q0 + p] = __double2float_rn(tot);
  }
}

// allow the kernel the dynamic shared memory its plan asks for
template <typename Fn>
int allow_smem(Fn fn, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

}  // namespace

extern "C" {

// Xn (nX, n), Zn (nZ, n) float32 rows; I, J int64 with element strides sI,
// sJ; K, KC (n, n) float64; out (B,) float32.  npad, tx, P, rc, resident
// and global_uv from ops/sinkhorn_cuda.exp_plan; with global_uv, ws holds
// the blocks' u and v, 2 npad P float64 a block.
int annchor_k8a_exp(const float* Xn, const float* Zn, const long long* I, long long sI,
                    const long long* J, long long sJ, const double* K, const double* KC, int B,
                    int n, int npad, int tx, int P, int rc, int resident, int global_uv,
                    int n_iter, float tiny, double* ws, float* out, void* stream) {
  if (B <= 0) return 0;
  const bool passes = npad != tx * rc;
  if (n < 1 || npad < n || tx < 1 || (rc != 2 && rc != 4 && rc != 8) ||
      npad % (tx * rc) != 0 || npad % 2 != 0 || P < 2 || P % 2 != 0 || n_iter < 0 ||
      ((passes || global_uv) && (resident || rc != 8)) || (global_uv && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = tx * (P / 2);
  const size_t smem = exp_smem(npad, tx, P, resident != 0, global_uv != 0);
  if (threads > K8A_MAX_THREADS(rc) || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(B) + P - 1) / P;
  // passes (above 2,048 bins) and u, v in global memory (above 7,136) only
  // with the 8-column tile and K streamed
  constexpr bool T = true, F = false;
  auto fn = global_uv  ? k8a_exp<8, F, T, T>
            : passes   ? k8a_exp<8, F, T, F>
            : rc == 2  ? (resident ? k8a_exp<2, T, F, F> : k8a_exp<2, F, F, F>)
            : rc == 4  ? (resident ? k8a_exp<4, T, F, F> : k8a_exp<4, F, F, F>)
                       : (resident ? k8a_exp<8, T, F, F> : k8a_exp<8, F, F, F>);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = allow_smem(fn, smem);
  if (code != 0) return code;
  fn<<<static_cast<unsigned>(blocks), threads, smem, st>>>(Xn, Zn, I, sI, J, sJ, K, KC, B, n, npad,
                                                           tx, P, n_iter, tiny, ws, out);
  return static_cast<int>(cudaGetLastError());
}

// A, Bh (m, n) float32 histograms; C (n, n) float32; out (m,) float32.  P,
// G, resident and global_v from ops/sinkhorn_cuda.log_plan; inv =
// float32(1 / eps); with global_v, ws holds the blocks' potentials and log
// histograms, 4 P n float32 a block.
int annchor_k8b_log(const float* A, const float* Bh, const float* C, int m, int n, int P,
                    int G, int resident, int global_v, float eps, float inv, int n_iter,
                    float* ws, float* out, void* stream) {
  if (m <= 0) return 0;
  if (n < 1 || P < 1 || G < 1 || G % 32 != 0 || P * G > 256 || n_iter < 0 ||
      (global_v && (resident || ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = log_smem(n, P, G, resident != 0, global_v != 0);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(m) + P - 1) / P;
  // the potentials leave shared memory only above 14,400 bins, where -C/eps
  // is read from global memory too
  auto fn = global_v   ? k8b_log<false, true>
            : resident ? k8b_log<true, false>
                       : k8b_log<false, false>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = allow_smem(fn, smem);
  if (code != 0) return code;
  fn<<<static_cast<unsigned>(blocks), P * G, smem, st>>>(A, Bh, C, m, n, P, G, eps, inv, n_iter,
                                                          ws, out);
  return static_cast<int>(cudaGetLastError());
}

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
