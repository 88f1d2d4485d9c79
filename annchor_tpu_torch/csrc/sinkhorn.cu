// K8: the Sinkhorn loop of the Wasserstein metrics, in two entry points.
//
// K8a (annchor_k8a_exp), the exp-domain loop: the scout of the
// scout/certify hybrid and its max-min anchors.  For each pair q, with
// A = Xn[I[q]], B = Zn[J[q]] and v = 1: n_iter times
// u = A / max(v K^T, TINY), v = B / max(u K, TINY); then u once more; and
// out[q] = sum_c u_c (v KC^T)_c.  It replaces the XLA program
// `_sinkhorn_exp_chunk` of annchor_tpu/ops/wasserstein.py (also run inside
// `_sinkhorn_maxmin`), not a Pallas kernel.  Its plain PyTorch version is
// `sinkhorn_exp_chunk_plain` in annchor_tpu_torch/ops/wasserstein.py: a
// float64 `torch.mm` (cuBLAS) and 4 elementwise kernels a half step; the
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
// each product term exact in float64 (a 24-bit by 24-bit product); the
// sum over k = 0..n-1 in float64, in that order, rounded once to float32
// (__double2float_rn); clamped below at TINY as torch's clamp does (a NaN
// passes); one IEEE float32 division.  The products run on the FP64
// tensor cores, `mma.sync.aligned.m16n8k8` (resident) and `m16n8k4`
// (streamed) `.row.col.f64`, chained over k: tools/probe_dmma.cu found
// every f64 mma shape on the H100 bit-equal to a chain of FMAs in k order
// (on uniform, positive, cancelling, 2^-30..2^-60 and half-ulp terms),
// so a chain of them is the same in-order FMA sum.  The cost: the terms u_c (v KC^T)_c, each one
// rounded product, summed over c = 0..n-1 in order and rounded once.
// `exp_chunk_model` in ops/sinkhorn_cuda.py repeats these operations in
// this order with torch, bit for bit.  cuBLAS sums in another order, so a
// rare entry rounds to the other float32 neighbour: the kernel is held to
// its plain version to rtol 2e-6.  K8b repeats the plain version's
// float32 formula as PyTorch runs it on a card: x / eps is x * (1 / eps)
// (PyTorch's division of a tensor by a Python scalar on a card), each LSE
// a row max (taken as 0 where it is infinite), the sum of expf(x - max)
// over the row in order, logf, the max added back, with the accurate expf
// and logf and no contraction (the __f*_rn intrinsics); the closing sum
// of exp(logP) C in float64.  Only the order of its float32 sums differs
// from the plain version's.  No fast math, no flush to zero.
//
// What bounds it on the H100.  K8a: (2 n_iter + 2) n^2 FP64 FMA a pair.
// The card's FP64 peak is its tensor cores' 128 FMA a clock per SM, 132 x
// 128 x 1.98e9 = 3.35e13 a second (tools/probe_dmma.cu measured 123-127
// for m16n8k4, k8 and k16, and 61-64 for m8n8k4, which issues at half
// rate): 0.60 ms for an 8,192-pair chunk of the digits (n 64, n_iter
// 300).  The bytes: two histogram rows a pair and K once, except where K
// is read from device memory for every product (above the resident limit:
// 415 MB a product at 7,200 bins).  K8b: (2 n_iter + 1) n^2 expf a pair,
// one MUFU.EX2 each at 16 a clock per SM, 4.18e12 a second: 1.61 ms for a
// 4,096-pair chunk at n_iter 200.
//
// The design of K8a.  Each half step is a matrix product [pairs x n] .
// [n x n] whose B operand, K or K^T, every pair shares: the pairs are the
// mma's M dimension, so one K fragment feeds 16 pairs.
// * Resident (to 144 bins; the digits are 64): one block runs 16 pairs
//   through every iteration in one launch; only the costs leave the
//   chip.  K is staged once in shared memory as float64 with a row
//   stride of npad + 4 (a multiple of 16 plus 4, so both the K and the K^T
//   fragment, 4 consecutive k of 8 rows or 8 consecutive columns of 4
//   rows, hit distinct banks in each half warp); one copy serves both
//   products, as a K^T fragment is K's with its index swapped.  u and v
//   live beside it as [pair][k] rows of the same stride.  Warp w owns
//   output columns 8 w .. 8 w + 7 of every pair (npad / 8 warps: with one
//   block on an SM, as for a 1,797-pair anchor column on 132 SMs, more
//   warps hide the chain of dependent mma better than wider ones feed
//   it), on m16n8k8.  The histogram values a lane divides by stay in
//   registers; the scale step works on the accumulator fragments.  The
//   closing product reads KC staged over K.
// * Streamed (above 144 bins): one launch a half step, each block a 64
//   pair x BN column tile of the product (BN 64, or 32 or 16 where the
//   pairs are too few to give every SM a block) with the scale (or the
//   cost terms) in its epilogue; 4 warps of 32 pairs x BN / 2 columns
//   (at BN 64, 2 x 4 m16n8k4 tiles: 0.5 bytes of shared memory a FMA);
//   k-slabs of 16 of u or v and of K double-buffered through shared
//   memory with cp.async, so each K element fetched feeds 64 pairs.  u
//   and v live in a device workspace, (Bp, npad) float64 each; a last
//   launch sums each pair's terms in order.  The launch plan is
//   ops/sinkhorn_cuda.exp_plan.
//
// K8b stages -C/eps in an (n, n + 1 | 1) float32 layout so a warp reading
// a row or a column hits 32 banks; G threads (a multiple of 32) share a
// pair, each owning outputs o = t, t + G, ...; f/eps and g/eps stay in
// shared memory, or above 14,400 bins in a global workspace of the
// block's own.  Its launch plan is ops/sinkhorn_cuda.log_plan.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block can have

// allow the kernel the dynamic shared memory its plan asks for
template <typename Fn>
int allow_smem(Fn fn, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

// ---------------------------------------------------------------- K8a ----

// acc[0..3] += A (16 x KS) . B (KS x 8) on the FP64 tensor cores, KS 4 or
// 8 (mma.sync m16n8k4, m16n8k8).  Lane l = 4 g + t holds
// A[g + 8 (i % 2)][t + 4 (i / 2)] (a[i]), B[t + 4 j][g] (b[j]) and the
// outputs (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  Each output
// is the chain fma(a b, ...fma(a0 b0, c)) in k order (tools/probe_dmma.cu).
template <int KS>
__device__ __forceinline__ void mma16x8(double (&d)[4], const double (&a)[KS / 2],
                                        const double (&b)[KS / 4]) {
  static_assert(KS == 4 || KS == 8, "m16n8k4 or m16n8k8");
  if constexpr (KS == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
        "{%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
}

// acc[i][j] += W[16 i + (g, g + 8)][k] . M(k, n0 + 8 j + g) over k in
// [0, kn), KS k a step, in order: W rows of stride ldw (the warp's first
// row at W), M(k, c) = Ms[c * ldm + k] (kTrans) or Ms[k * ldm + c].
template <int MT, int NT, int KS, bool kTrans>
__device__ __forceinline__ void warp_product(double (&acc)[MT][NT][4], const double* W, int ldw,
                                             const double* Ms, int ldm, int n0, int kn, int g,
                                             int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < kn; k0 += KS) {
    double a[MT][KS / 2], b[NT][KS / 4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < KS / 2; ++e)
        a[i][e] = W[(16 * i + g + 8 * (e % 2)) * ldw + k0 + t + 4 * (e / 2)];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < KS / 4; ++e) {
        const int c = n0 + 8 * j + g;
        const int k = k0 + t + 4 * e;
        b[j][e] = kTrans ? Ms[c * ldm + k] : Ms[k * ldm + c];
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma16x8<KS>(acc[i][j], a[i], b[j]);
  }
}

// h / max(float32(y), tiny) as float64
__device__ __forceinline__ double scale1(double y, float h, float tiny) {
  float f = __double2float_rn(y);
  f = f < tiny ? tiny : f;
  return static_cast<double>(__fdiv_rn(h, f));
}

// ------------------------------------------------------------ resident ----

constexpr int kResP = 16;  // pairs a block: one m16 tile
constexpr int kResKS = 8;  // k of an mma (m16n8k8)
constexpr int kResMaxThreads = 4 * 144;  // a warp per 8 columns, npad 144

// the row stride of K, u and v in shared memory (npad a multiple of 16)
__host__ __device__ inline int res_ld(int npad) { return npad + 4; }

// shared memory of a resident block: K (npad rows), u and v (16 rows each)
inline size_t res_smem(int npad) {
  return sizeof(double) * static_cast<size_t>(res_ld(npad)) * (npad + 2 * kResP);
}

// The lane's histogram values, constant over the iterations: pair
// g + 8 r at columns n0 + 2 t + e, 0 past the batch or past n.
__device__ __forceinline__ void res_hist(float (&h)[2][2], const float* __restrict__ X,
                                         const long long* __restrict__ ids, long long sid,
                                         long long q0, int B, int n, int c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long q = q0 + 8 * r;
    const float* row = q < B ? X + static_cast<size_t>(ids[q * sid]) * n : nullptr;
#pragma unroll
    for (int e = 0; e < 2; ++e) h[r][e] = (row != nullptr && c + e < n) ? __ldg(row + c + e) : 0.0f;
  }
}

// One half step of a resident block: Wout = hist / max(Win . M, tiny),
// M = K^T (kTrans) or K, for the warp's 8 columns n0 .. of every pair.
template <bool kTrans>
__device__ __forceinline__ void res_half(const double* Win, double* Wout, const double* Ks,
                                         int ld, int npad, int n0, const float (&h)[2][2],
                                         float tiny, int g, int t) {
  double acc[1][1][4] = {};
  warp_product<1, 1, kResKS, kTrans>(acc, Win, ld, Ks, ld, n0, npad, g, t);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    *reinterpret_cast<double2*>(Wout + (g + 8 * r) * ld + n0 + 2 * t) =
        make_double2(scale1(acc[0][0][2 * r], h[r][0], tiny),
                     scale1(acc[0][0][2 * r + 1], h[r][1], tiny));
}

// Stage the (n, n) float64 matrix M as Ks[r][c] = M[r][c], zero past n.
__device__ __forceinline__ void res_stage(double* Ks, const double* __restrict__ M, int n,
                                          int npad, int ld) {
  for (int idx = threadIdx.x; idx < npad * npad; idx += blockDim.x) {
    const int r = idx / npad;
    const int c = idx - r * npad;
    Ks[r * ld + c] = (r < n && c < n) ? __ldg(M + static_cast<size_t>(r) * n + c) : 0.0;
  }
}

// One block: 16 pairs through every iteration and the cost; warp w owns
// output columns 8 w .. 8 w + 7 of every pair.
__global__ void __launch_bounds__(kResMaxThreads, 1)
k8a_resident(const float* __restrict__ Xn, const float* __restrict__ Zn,
             const long long* __restrict__ I, long long sI, const long long* __restrict__ J,
             long long sJ, const double* __restrict__ K, const double* __restrict__ KC, int B,
             int n, int npad, int n_iter, float tiny, float* __restrict__ out) {
  extern __shared__ __align__(16) double smem8[];
  const int ld = res_ld(npad);
  double* Ks = smem8;
  double* Us = Ks + static_cast<size_t>(npad) * ld;  // [16][ld]
  double* Vs = Us + static_cast<size_t>(kResP) * ld;  // [16][ld]
  const int tid = threadIdx.x;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int n0 = 8 * (tid / 32);
  const long long q0 = static_cast<long long>(blockIdx.x) * kResP;

  float ha[2][2], hb[2][2];
  res_hist(ha, Xn, I, sI, q0 + g, B, n, n0 + 2 * t);
  res_hist(hb, Zn, J, sJ, q0 + g, B, n, n0 + 2 * t);
  res_stage(Ks, K, n, npad, ld);
  for (int idx = tid; idx < kResP * npad; idx += blockDim.x) {
    const int p = idx / npad;
    const int c = idx - p * npad;
    Vs[p * ld + c] = c < n ? 1.0 : 0.0;
  }
  __syncthreads();

  // each half step reads one of u, v and writes the other
  for (int it = 0; it < n_iter; ++it) {
    res_half<true>(Vs, Us, Ks, ld, npad, n0, ha, tiny, g, t);
    __syncthreads();
    res_half<false>(Us, Vs, Ks, ld, npad, n0, hb, tiny, g, t);
    __syncthreads();
  }
  res_half<true>(Vs, Us, Ks, ld, npad, n0, ha, tiny, g, t);
  __syncthreads();

  // the cost: y = v KC^T, the terms u_c y_c into v's rows, then each
  // pair's terms summed in order
  res_stage(Ks, KC, n, npad, ld);
  __syncthreads();
  double acc[1][1][4] = {};
  warp_product<1, 1, kResKS, true>(acc, Vs, ld, Ks, ld, n0, npad, g, t);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = (g + 8 * r) * ld + n0 + 2 * t;
    Vs[at] = __dmul_rn(Us[at], acc[0][0][2 * r]);
    Vs[at + 1] = __dmul_rn(Us[at + 1], acc[0][0][2 * r + 1]);
  }
  __syncthreads();
  if (tid < kResP && q0 + tid < B) {
    double s = 0.0;
    for (int c = 0; c < n; ++c) s = __dadd_rn(s, Vs[tid * ld + c]);
    out[q0 + tid] = __double2float_rn(s);
  }
}

// ------------------------------------------------------------ streamed ----

constexpr int kBM = 64;  // pairs of a block tile: 2 x 2 warps of 32 pairs
constexpr int kBK = 16;  // k of a slab
constexpr int kLdA = kBK + 4;  // [pair][k] slab stride

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy 16 bytes (2 doubles), or 8 (one double; src_bytes 0 fills a zero)
__device__ __forceinline__ void cp16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp8(double* dst, const double* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The [k][column] slab stride of a BN-column tile (u K)
template <int BN>
__host__ __device__ constexpr int ld_b() { return BN + 4; }

// Queue slab s of the block's W rows (p0 ..) and of M (the block's BN
// columns c0 ..): As[p][k], Bs[c][k] (kTrans, M(k, c) = M[c][k]) or
// Bs[k][c], zero past n.
template <int BN, bool kTrans>
__device__ __forceinline__ void load_slab(double* As, double* Bs, const double* W, int ldw,
                                          const double* __restrict__ M, int n, int p0, int c0,
                                          int s) {
  const int k0 = s * kBK;
  for (int idx = threadIdx.x; idx < kBM * kBK / 2; idx += blockDim.x) {
    const int p = idx / (kBK / 2);
    const int k = 2 * (idx - p * (kBK / 2));
    cp16(As + p * kLdA + k, W + static_cast<size_t>(p0 + p) * ldw + k0 + k);
  }
  for (int idx = threadIdx.x; idx < BN * kBK; idx += blockDim.x) {
    int c, k;
    if (kTrans) {
      c = idx / kBK;
      k = idx - c * kBK;
    } else {
      k = idx / BN;
      c = idx - k * BN;
    }
    const bool in = c0 + c < n && k0 + k < n;
    const double* src = in ? M + static_cast<size_t>(kTrans ? c0 + c : k0 + k) * n +
                                 (kTrans ? k0 + k : c0 + c)
                           : M;
    cp8(Bs + (kTrans ? c * kLdA + k : k * ld_b<BN>() + c), src, in ? 8 : 0);
  }
}

// One launch of a streamed half step, for the block's 64-pair x BN-column
// tile (4 warps of 32 pairs x BN / 2 columns): y = Win . M (M = K^T or
// KC^T with kTrans, else K) over k < n; then kTerms: Wout[p][c] *= y (the
// cost's terms, u in place), else Wout[p][c] = h_p[c] / max(float32(y),
// tiny) with h_p = X[ids[p]] (0 past the batch or past n).  Win and Wout:
// (Bp, ldw) float64.
template <int BN, bool kTrans, bool kTerms>
__global__ void __launch_bounds__(128)
k8a_step(const double* Win, double* Wout, int ldw, const double* __restrict__ M, int n,
         const float* __restrict__ X, const long long* __restrict__ ids, long long sid, int B,
         float tiny) {
  constexpr int NT = BN / 16;  // n8 tiles a warp
  constexpr int kSlabB = BN * kLdA > kBK * ld_b<BN>() ? BN * kLdA : kBK * ld_b<BN>();
  __shared__ __align__(16) double As[2][kBM * kLdA];
  __shared__ __align__(16) double Bs[2][kSlabB];
  const int p0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wp = 32 * (warp % 2);  // the warp's first pair and column in the tile
  const int wc = (BN / 2) * (warp / 2);
  double acc[2][NT][4] = {};
  const int slabs = (n + kBK - 1) / kBK;

  load_slab<BN, kTrans>(As[0], Bs[0], Win, ldw, M, n, p0, c0, 0);
  cp_commit();
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) {
      load_slab<BN, kTrans>(As[(s + 1) & 1], Bs[(s + 1) & 1], Win, ldw, M, n, p0, c0, s + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    warp_product<2, NT, 4, kTrans>(acc, As[s & 1] + wp * kLdA, kLdA, Bs[s & 1],
                                   kTrans ? kLdA : ld_b<BN>(), wc, kBK, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + wp + 16 * i + g + 8 * r;
      const float* h = nullptr;
      if (!kTerms && p < B) h = X + static_cast<size_t>(ids[p * sid]) * n;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = c0 + wc + 8 * j + 2 * t;
        double2* at = reinterpret_cast<double2*>(Wout + static_cast<size_t>(p) * ldw + c);
        const double y0 = acc[i][j][2 * r], y1 = acc[i][j][2 * r + 1];
        if (kTerms) {
          const double2 u = *at;
          *at = make_double2(__dmul_rn(u.x, y0), __dmul_rn(u.y, y1));
        } else {
          const float h0 = (h != nullptr && c < n) ? __ldg(h + c) : 0.0f;
          const float h1 = (h != nullptr && c + 1 < n) ? __ldg(h + c + 1) : 0.0f;
          *at = make_double2(scale1(y0, h0, tiny), scale1(y1, h1, tiny));
        }
      }
    }
}

// V[p][c] = 1 for c < n, else 0: the first half step's v
__global__ void k8a_ones(double* V, int ldw, int n, long long total) {
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x)
    V[idx] = idx % ldw < n ? 1.0 : 0.0;
}

// out[p] = float32(sum over c < n, in order, of T[p][c])
__global__ void k8a_sum(const double* __restrict__ T, int ldw, int n, int B,
                        float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  double s = 0.0;
  for (int c = 0; c < n; ++c) s = __dadd_rn(s, T[static_cast<size_t>(p) * ldw + c]);
  out[p] = __double2float_rn(s);
}

// The streamed half steps of one call with BN-column tiles.
template <int BN>
int streamed(const float* Xn, const float* Zn, const long long* I, long long sI,
             const long long* J, long long sJ, const double* K, const double* KC, int B, int n,
             int npad, int Bp, int n_iter, float tiny, double* ws, float* out, cudaStream_t st) {
  double* U = ws;
  double* V = ws + static_cast<size_t>(Bp) * npad;
  const dim3 grid(npad / BN, Bp / kBM);
  cudaError_t code;
  const long long total = static_cast<long long>(Bp) * npad;
  const long long ones_blocks = (total + 255) / 256;
  k8a_ones<<<static_cast<unsigned>(ones_blocks < 65535 ? ones_blocks : 65535), 256, 0, st>>>(
      V, npad, n, total);
  if ((code = cudaGetLastError()) != cudaSuccess) return static_cast<int>(code);
  for (int it = 0; it <= n_iter; ++it) {
    k8a_step<BN, true, false><<<grid, 128, 0, st>>>(V, U, npad, K, n, Xn, I, sI, B, tiny);
    if ((code = cudaGetLastError()) != cudaSuccess) return static_cast<int>(code);
    if (it == n_iter) break;
    k8a_step<BN, false, false><<<grid, 128, 0, st>>>(U, V, npad, K, n, Zn, J, sJ, B, tiny);
    if ((code = cudaGetLastError()) != cudaSuccess) return static_cast<int>(code);
  }
  k8a_step<BN, true, true><<<grid, 128, 0, st>>>(V, U, npad, KC, n, nullptr, nullptr, 0, B,
                                                  tiny);
  if ((code = cudaGetLastError()) != cudaSuccess) return static_cast<int>(code);
  k8a_sum<<<(B + 127) / 128, 128, 0, st>>>(U, npad, n, B, out);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" {

// K8a, resident: Xn (nX, n), Zn (nZ, n) float32 rows; I, J int64 with
// element strides sI, sJ; K, KC (n, n) float64; out (B,) float32; npad
// from ops/sinkhorn_cuda.exp_plan.
int annchor_k8a_resident(const float* Xn, const float* Zn, const long long* I, long long sI,
                         const long long* J, long long sJ, const double* K, const double* KC,
                         int B, int n, int npad, int n_iter, float tiny, float* out,
                         void* stream) {
  if (B <= 0) return 0;
  const int threads = 4 * npad;  // a warp per 8 columns
  const size_t smem = res_smem(npad);
  if (n < 1 || npad < n || npad % 16 != 0 || n_iter < 0 || threads > kResMaxThreads ||
      smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int code = allow_smem(k8a_resident, smem);
  if (code != 0) return code;
  const long long blocks = (static_cast<long long>(B) + kResP - 1) / kResP;
  k8a_resident<<<static_cast<unsigned>(blocks), threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(Xn, Zn, I, sI, J, sJ, K, KC, B, n, npad,
                                                      n_iter, tiny, out);
  return static_cast<int>(cudaGetLastError());
}

// K8a, streamed: arguments as annchor_k8a_resident, with npad, Bp (the
// workspace's columns and rows: multiples of bn and of 64) and bn (the
// tile's columns, 16, 32 or 64) from exp_plan, and ws, 2 Bp npad float64
// (u, then v).  2 n_iter + 4 launches: v = 1, the half steps, the closing
// u, the cost's terms, their sums.
int annchor_k8a_streamed(const float* Xn, const float* Zn, const long long* I, long long sI,
                         const long long* J, long long sJ, const double* K, const double* KC,
                         int B, int n, int npad, int Bp, int bn, int n_iter, float tiny,
                         double* ws, float* out, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || npad < n || (bn != 16 && bn != 32 && bn != 64) || npad % bn != 0 ||
      npad % kBK != 0 || Bp < B || Bp % kBM != 0 || n_iter < 0 || ws == nullptr ||
      Bp / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fn = bn == 64 ? streamed<64> : bn == 32 ? streamed<32> : streamed<16>;
  return fn(Xn, Zn, I, sI, J, sJ, K, KC, B, n, npad, Bp, n_iter, tiny, ws, out, st);
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
