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
// K8b (annchor_k8b_resident, annchor_k8b_streamed), the log-domain loop of
// the `wasserstein_sinkhorn` metric: n_iter times f = eps (log A - LSE_j(-C/eps + g/eps)),
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
// of exp(logP) C in float64, each row's terms over j in order, then the
// rows in order.  Only the order of its float32 sums differs from the
// plain version's; `log_batch_model` in ops/sinkhorn_cuda.py repeats these
// operations in this order with torch.  No fast math, no flush to zero.
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
// 4,096-pair chunk at n_iter 200.  Each element also costs ~12 more
// instructions (two adds and a max, the accurate expf's FFMA/FADD/FMUL and
// SHF, the running add), and an SM issues 128 a clock: the issue slots,
// not the MUFU, are the tighter bound.  Above the resident limit the
// bytes of C over the sweeps (two a half step, one for the cost) count too.
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
// The design of K8b.  A half step is an "LSE product" [pairs x n] (x) [n x
// n]: each output is a max, then an in-order sum, over k of M(o, k) +
// W(p, k), with M = -C/eps (the f update) or its transpose (the g update).
// A thread holds a register tile of R pairs x C outputs (4 x 4, 4 x 2, 4 x
// 1, or 1 x 1 where the pairs are too few to give the SMs enough threads;
// resident plans stop at 4 x 2, whose 104 registers leave more warps),
// their R C running maxima, then sums; each 4-k step reads C 16-byte
// loads of -C/eps and R of the potentials, so each -C/eps value feeds R
// pairs and each potential C outputs.  One copy of -C/eps serves both
// updates: its 16-byte chunks are swizzled (chunk XOR a key of the row)
// so that 4 rows read along k (the f update) and 4 rows read along o (the
// g update, its transpose) both hit 8 distinct chunks in a quarter warp.
// * Resident (to 224 bins, while -C/eps fits shared memory; the digits are
//   64): one launch; a block runs P
//   pairs through every iteration with -C/eps (swizzled, -inf past n),
//   f/eps, g/eps and the log histograms in shared memory; the cost's
//   float64 row sums go to the log histograms' place.
// * Streamed (above): one launch a half step, each block a tile of PT
//   pairs x 64 outputs, its two sweeps over k in slabs of 32: the slabs of
//   C (scaled to -C/eps on use, -inf past n) and of the potentials,
//   double-buffered through shared memory with cp.async, feed the whole
//   pair tile.  f/eps and g/eps live in a (Bp, npad) float32 workspace; the
//   cost's row sums in a float64 one, summed in order by a last launch.
//   Where the pairs are few the pair tile shrinks, so that 2 pairs at
//   14,401 bins still give 226 blocks.
// The launch plan is ops/sinkhorn_cuda.log_plan.

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

constexpr int kLogThreads = 256;  // threads a K8b block at most
constexpr int kLogBN = 64;  // outputs of a streamed tile
constexpr int kLogKS = 32;  // k of a streamed slab
constexpr int kLogLdW = kLogKS + 4;  // [pair][k] stride of a slab of potentials

// The column of element (r, c) of a swizzled tile (rows of a multiple of
// 32 floats): the 16-byte chunk c / 4 XOR a key of the row, (r / 4) % 8
// where a thread takes 4 outputs (C 4), r % 8 where it takes one (C 1), so
// that each read of load_m hits 8 distinct chunks in a quarter warp.
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  const int key = C == 4 ? (r >> 2) & 7 : r & 7;
  return (((c >> 2) ^ key) << 2) | (c & 3);
}

// The thread's -C values of a 4-k step: mv[i][kk] = M(ob + i, k0 + kk),
// M(o, k) = T[o][k], or T[k][o] (kTrans), from a swizzled tile T of row
// stride ld: C 16-byte loads along k, or 4 along o (kTrans, C 4), or 4
// words (kTrans, C 1).
template <int C, bool kTrans>
__device__ __forceinline__ void load_m(float (&mv)[C][4], const float* T, int ld, int ob, int k0) {
  if constexpr (!kTrans) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int r = ob + i;
      const float4 v = *reinterpret_cast<const float4*>(T + r * ld + swz<C>(r, k0));
      mv[i][0] = v.x, mv[i][1] = v.y, mv[i][2] = v.z, mv[i][3] = v.w;
    }
  } else if constexpr (C == 4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r = k0 + kk;
      const float4 v = *reinterpret_cast<const float4*>(T + r * ld + swz<4>(r, ob));
      mv[0][kk] = v.x, mv[1][kk] = v.y, mv[2][kk] = v.z, mv[3][kk] = v.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mv[0][kk] = T[(k0 + kk) * ld + swz<1>(k0 + kk, ob)];
  }
}

// The potentials of the thread's pairs pb .. pb + R - 1 at k0 .. k0 + 3,
// from [pair][k] rows of stride ldw (a multiple of 4)
template <int R>
__device__ __forceinline__ void load_w(float (&wv)[R][4], const float* W, int ldw, int pb,
                                       int k0) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(W + (pb + j) * ldw + k0);
    wv[j][0] = v.x, wv[j][1] = v.y, wv[j][2] = v.z, wv[j][3] = v.w;
  }
}

// One 4-k step of an LSE's sweeps over the thread's R pairs x C outputs:
// x = -C/eps + potential, then the running max (kSum false: acc is mx) or
// the running sum of expf(x - max), each in k order (kSum)
template <bool kSum, int C, int R>
__device__ __forceinline__ void lse_step(float (&acc)[R][C], const float (&mx)[R][C],
                                         const float (&mv)[C][4], const float (&wv)[R][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float x = __fadd_rn(mv[i][kk], wv[j][kk]);
        acc[j][i] = kSum ? __fadd_rn(acc[j][i], expf(__fsub_rn(x, mx[j][i])))
                         : fmaxf(acc[j][i], x);
      }
}

// the row max as LSE uses it: 0 where it is infinite
template <int C, int R>
__device__ __forceinline__ void lse_fix(float (&mx)[R][C]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < C; ++i) mx[j][i] = isinf(mx[j][i]) ? 0.0f : mx[j][i];
}

// the new potential over eps: eps (logh - (logf(s) + max)) * (1 / eps)
__device__ __forceinline__ float lse_out(float s, float mx, float logh, float eps, float inv) {
  return __fmul_rn(__fmul_rn(eps, __fsub_rn(logh, __fadd_rn(logf(s), mx))), inv);
}

// log(where(h > 0, h, 1)) + where(h > 0, 0, -1e9)
__device__ __forceinline__ float log_hist(float h) { return h > 0.0f ? logf(h) : -1e9f; }

// ------------------------------------------------------------ resident ----

// Floats of shared memory of a resident K8b block: -C/eps (npad rows of
// npad, swizzled, -inf past n), f/eps and g/eps ([P][npad + 4] each), log A
// and log B ([P][npad] each; then the closing's float64 row sums, [P][npad])
inline size_t log_res_floats(int npad, int P) {
  return static_cast<size_t>(npad) * npad + 2 * static_cast<size_t>(P) * (npad + 4) +
         2 * static_cast<size_t>(P) * npad;
}

// One half step of a resident block: Wout[p][o] = the potential from
// LSE_k(M(o, k) + Win[p][k]) for the thread's tile, M = -C/eps (the f
// update) or its transpose (kTrans: the g update), logh from LH
template <int C, int R, bool kTrans>
__device__ __forceinline__ void log_half(const float* Ns, int npad, const float* Win,
                                         float* Wout, int ldw, const float* LH, int ob, int pb,
                                         int n, float eps, float inv) {
  float mx[R][C], s[R][C], mv[C][4], wv[R][4];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < C; ++i) mx[j][i] = -INFINITY, s[j][i] = 0.0f;
  // k past n reads the -inf padding of -C/eps and 0 potentials: x = -inf
#pragma unroll 2
  for (int k0 = 0; k0 < n; k0 += 4) {
    load_m<C, kTrans>(mv, Ns, npad, ob, k0);
    load_w<R>(wv, Win, ldw, pb, k0);
    lse_step<false>(mx, mx, mv, wv);
  }
  lse_fix(mx);
#pragma unroll 2
  for (int k0 = 0; k0 < n; k0 += 4) {
    load_m<C, kTrans>(mv, Ns, npad, ob, k0);
    load_w<R>(wv, Win, ldw, pb, k0);
    lse_step<true>(s, mx, mv, wv);
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int o = ob + i;
      if (o < n)
        Wout[(pb + j) * ldw + o] =
            lse_out(s[j][i], mx[j][i], LH[(pb + j) * npad + o], eps, inv);
    }
}

// One block: P pairs through every iteration and the cost.  Thread t
// takes pairs R (t / TO) .. + R - 1 and outputs C (t % TO) .. + C - 1, TO
// = ceil(n / C).
template <int C, int R>
__global__ void __launch_bounds__(kLogThreads, 2)
k8b_resident(const float* __restrict__ A, const float* __restrict__ Bh,
             const float* __restrict__ Cm, int m, int n, int npad, int P, float eps, float inv,
             int n_iter, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem4[];
  const int ldw = npad + 4;
  float* Ns = smem4;
  float* F = Ns + static_cast<size_t>(npad) * npad;  // f / eps, [P][ldw]
  float* G = F + static_cast<size_t>(P) * ldw;  // g / eps
  float* LA = G + static_cast<size_t>(P) * ldw;  // [P][npad]
  float* LB = LA + static_cast<size_t>(P) * npad;
  const int TO = (n + C - 1) / C;
  const int tid = threadIdx.x;
  const int pb = tid / TO * R;
  const int ob = tid % TO * C;
  const long long q0 = static_cast<long long>(blockIdx.x) * P;

  for (int idx = tid; idx < npad * npad; idx += blockDim.x) {
    const int r = idx / npad;
    const int c = idx - r * npad;
    Ns[r * npad + swz<C>(r, c)] =
        (r < n && c < n) ? __fmul_rn(-__ldg(Cm + static_cast<size_t>(r) * n + c), inv)
                         : -INFINITY;
  }
  for (int idx = tid; idx < 2 * P * ldw; idx += blockDim.x) F[idx] = 0.0f;  // F and G
  for (int idx = tid; idx < P * npad; idx += blockDim.x) {
    const int p = idx / npad;
    const int c = idx - p * npad;
    const long long q = q0 + p;
    const bool in = q < m && c < n;
    LA[idx] = log_hist(in ? __ldg(A + q * n + c) : 0.0f);
    LB[idx] = log_hist(in ? __ldg(Bh + q * n + c) : 0.0f);
  }
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    log_half<C, R, false>(Ns, npad, G, F, ldw, LA, ob, pb, n, eps, inv);
    __syncthreads();
    log_half<C, R, true>(Ns, npad, F, G, ldw, LB, ob, pb, n, eps, inv);
    __syncthreads();
  }

  // the cost: row sums over j in order of float64(expf((-C/eps + f/eps) +
  // g/eps) C), one pair at a time, into the log histograms' place; then
  // each pair's rows in order
  double* Rs = reinterpret_cast<double*>(LA);  // [P][npad]
#pragma unroll 1
  for (int j = 0; j < R; ++j) {
    double acc[C];
    float fi[C], mv[C][4], wv[1][4];
#pragma unroll
    for (int i = 0; i < C; ++i) acc[i] = 0.0, fi[i] = F[(pb + j) * ldw + ob + i];
    for (int k0 = 0; k0 < n; k0 += 4) {
      load_m<C, false>(mv, Ns, npad, ob, k0);
      load_w<1>(wv, G, ldw, pb + j, k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int o = ob + i, k = k0 + kk;
          const float c = (o < n && k < n) ? __ldg(Cm + static_cast<size_t>(o) * n + k) : 0.0f;
          const float x = __fadd_rn(__fadd_rn(mv[i][kk], fi[i]), wv[0][kk]);
          acc[i] = __dadd_rn(acc[i], static_cast<double>(__fmul_rn(expf(x), c)));
        }
    }
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (ob + i < n) Rs[(pb + j) * npad + ob + i] = acc[i];
  }
  __syncthreads();
  for (int p = tid; p < P && q0 + p < m; p += blockDim.x) {
    double t = 0.0;
    for (int i = 0; i < n; ++i) t = __dadd_rn(t, Rs[p * npad + i]);
    out[q0 + p] = __double2float_rn(t);
  }
}

// ------------------------------------------------------------ streamed ----

// 4 bytes (src_bytes 0 fills a zero) and 16 bytes of floats, cp.async
__device__ __forceinline__ void cpf4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cpf16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Queue the slab at k0 of a streamed tile's C values, swizzled: M(o, k) =
// C[o][k] as [kLogBN rows o][kLogKS] (the f update and the cost), or C[k][o]
// as [kLogKS rows k][kLogBN] (kTrans: the g update); 0 past n
template <int C, bool kTrans>
__device__ __forceinline__ void queue_c(float* Ms, const float* __restrict__ Cm, int n, int o0,
                                        int k0) {
  constexpr int kCols = kTrans ? kLogBN : kLogKS;
  constexpr int kRows = kTrans ? kLogKS : kLogBN;
  for (int idx = threadIdx.x; idx < kRows * kCols; idx += blockDim.x) {
    const int r = idx / kCols;
    const int c = idx % kCols;
    const int gr = (kTrans ? k0 : o0) + r;
    const int gc = (kTrans ? o0 : k0) + c;
    const bool in = gr < n && gc < n;
    cpf4(Ms + r * kCols + swz<C>(r, c), in ? Cm + static_cast<size_t>(gr) * n + gc : Cm,
         in ? 4 : 0);
  }
}

// Queue the slab at k0 of the tile's potentials: Ws[p][kk] = W[p0 + p][k0 + kk]
__device__ __forceinline__ void queue_w(float* Ws, const float* W, int ldw, int p0, int PT,
                                        int k0) {
  for (int idx = threadIdx.x; idx < PT * (kLogKS / 4); idx += blockDim.x) {
    const int p = idx / (kLogKS / 4);
    const int c = 4 * (idx % (kLogKS / 4));
    cpf16(Ws + p * kLogLdW + c, W + static_cast<size_t>(p0 + p) * ldw + k0 + c);
  }
}

// C values of a slab step to -C/eps, -inf at the kleft-th k and past it
template <int C>
__device__ __forceinline__ void scale_m(float (&nv)[C][4], const float (&cv)[C][4], float inv,
                                        int kleft) {
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) nv[i][kk] = __fmul_rn(-cv[i][kk], inv);
  if (kleft < 4) {
#pragma unroll
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk >= kleft) nv[i][kk] = -INFINITY;
  }
}

// Shared memory bytes of a streamed block of PT pairs: two slabs of C
// values and two of potentials
inline size_t log_stream_smem(int PT) {
  return sizeof(float) * (2 * kLogBN * kLogKS + 2 * static_cast<size_t>(PT) * kLogLdW);
}

// The streamed launches' shared loop: the nsweep sweeps over k of the
// block's tile, slab by slab, the slabs of C values (queue_c) and of
// Win's rows p0 .. p0 + PT - 1 double-buffered with cp.async; step(sweep,
// M slab, W slab, k of the slab) consumes one.
template <int C, bool kTrans, typename Step>
__device__ __forceinline__ void stream_slabs(const float* Win, int ldw,
                                             const float* __restrict__ Cm, int n, int o0,
                                             int p0, int PT, int nsweep, Step step) {
  extern __shared__ __align__(16) float smem4[];
  float* Ms = smem4;  // [2][kLogBN * kLogKS]
  float* Ws = smem4 + 2 * kLogBN * kLogKS;  // [2][PT][kLogLdW]
  const int S = (n + kLogKS - 1) / kLogKS;
  queue_c<C, kTrans>(Ms, Cm, n, o0, 0);
  queue_w(Ws, Win, ldw, p0, PT, 0);
  cp_commit();
  for (int it = 0; it < nsweep * S; ++it) {
    const int b = it & 1;
    if (it + 1 < nsweep * S) {
      const int k1 = (it + 1) % S * kLogKS;
      queue_c<C, kTrans>(Ms + (b ^ 1) * kLogBN * kLogKS, Cm, n, o0, k1);
      queue_w(Ws + (b ^ 1) * PT * kLogLdW, Win, ldw, p0, PT, k1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    step(it / S, Ms + b * kLogBN * kLogKS, Ws + b * PT * kLogLdW, it % S * kLogKS);
    __syncthreads();
  }
}

// One launch of a streamed half step, for the block's tile of PT pairs x
// kLogBN outputs (PT = R blockDim.x / (kLogBN / C)): Wout[p][o] = the
// potential from LSE_k(M(o, k) + Win[p][k]), M(o, k) = -C[o][k] / eps (f)
// or -C[k][o] / eps (kTrans: g), logh from H[p][o] (0 past the batch); two
// sweeps over the slabs, the max, then the sum.  Win, Wout: (Bp, ldw).
template <int C, int R, bool kTrans>
__global__ void __launch_bounds__(kLogThreads, 2)
k8b_step(const float* Win, float* Wout, int ldw, const float* __restrict__ Cm,
         const float* __restrict__ H, int m, int n, float eps, float inv) {
  constexpr int TO = kLogBN / C;
  const int PT = static_cast<int>(blockDim.x) / TO * R;
  const int o0 = blockIdx.x * kLogBN;
  const int p0 = blockIdx.y * PT;
  const int pb = threadIdx.x / TO * R;
  const int ob = threadIdx.x % TO * C;
  float mx[R][C], s[R][C];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < C; ++i) mx[j][i] = -INFINITY, s[j][i] = 0.0f;
  stream_slabs<C, kTrans>(Win, ldw, Cm, n, o0, p0, PT, 2,
                          [&](int sweep, const float* Mb, const float* Wb, int k0) {
    if (sweep == 1 && k0 == 0) lse_fix(mx);
    float cv[C][4], nv[C][4], wv[R][4];
#pragma unroll
    for (int kk0 = 0; kk0 < kLogKS; kk0 += 4) {
      if (k0 + kk0 >= n) break;
      load_m<C, kTrans>(cv, Mb, kTrans ? kLogBN : kLogKS, ob, kk0);
      scale_m<C>(nv, cv, inv, n - k0 - kk0);
      load_w<R>(wv, Wb, kLogLdW, pb, kk0);
      if (sweep == 0)
        lse_step<false>(mx, mx, nv, wv);
      else
        lse_step<true>(s, mx, nv, wv);
    }
  });
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int p = p0 + pb + j;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int o = o0 + ob + i;
      if (o < n) {
        const float h = p < m ? __ldg(H + static_cast<size_t>(p) * n + o) : 0.0f;
        Wout[static_cast<size_t>(p) * ldw + o] =
            lse_out(s[j][i], mx[j][i], log_hist(h), eps, inv);
      }
    }
  }
}

// The cost's row sums of a streamed tile: Rw[p][o] = the sum over k < n,
// in order, of float64(expf((-C[o][k] / eps + F[p][o]) + G[p][k]) C[o][k])
template <int C, int R>
__global__ void __launch_bounds__(kLogThreads, 1)
k8b_cost(const float* F, const float* G, int ldw, const float* __restrict__ Cm, int n,
         float inv, double* Rw) {
  constexpr int TO = kLogBN / C;
  const int PT = static_cast<int>(blockDim.x) / TO * R;
  const int o0 = blockIdx.x * kLogBN;
  const int p0 = blockIdx.y * PT;
  const int pb = threadIdx.x / TO * R;
  const int ob = threadIdx.x % TO * C;
  double acc[R][C];
  float fi[R][C];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int o = o0 + ob + i;
      acc[j][i] = 0.0;
      fi[j][i] = o < n ? F[static_cast<size_t>(p0 + pb + j) * ldw + o] : 0.0f;
    }
  stream_slabs<C, false>(G, ldw, Cm, n, o0, p0, PT, 1,
                         [&](int, const float* Mb, const float* Wb, int k0) {
    float cv[C][4], nv[C][4], wv[R][4];
#pragma unroll
    for (int kk0 = 0; kk0 < kLogKS; kk0 += 4) {
      if (k0 + kk0 >= n) break;
      load_m<C, false>(cv, Mb, kLogKS, ob, kk0);
      scale_m<C>(nv, cv, inv, n - k0 - kk0);
      load_w<R>(wv, Wb, kLogLdW, pb, kk0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const float x = __fadd_rn(__fadd_rn(nv[i][kk], fi[j][i]), wv[j][kk]);
            acc[j][i] = __dadd_rn(acc[j][i], static_cast<double>(__fmul_rn(expf(x), cv[i][kk])));
          }
    }
  });
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int o = o0 + ob + i;
      if (o < n) Rw[static_cast<size_t>(p0 + pb + j) * ldw + o] = acc[j][i];
    }
}

// out[p] = float32(the sum over o < n, in order, of Rw[p][o])
__global__ void k8b_sum(const double* __restrict__ Rw, int ldw, int n, int m,
                        float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= m) return;
  double s = 0.0;
  for (int o = 0; o < n; ++o) s = __dadd_rn(s, Rw[static_cast<size_t>(p) * ldw + o]);
  out[p] = __double2float_rn(s);
}

// The streamed launches of one call: F, G (Bp, npad) float32 zero in ws,
// Rw (Bp, npad) float64; *launched counts each launch made.
template <int C, int R>
int log_streamed(const float* A, const float* Bh, const float* Cm, int m, int n, int npad,
                 int Bp, int PT, float eps, float inv, int n_iter, float* ws, double* rw,
                 float* out, int* launched, cudaStream_t st) {
  float* F = ws;
  float* G = ws + static_cast<size_t>(Bp) * npad;
  const int threads = PT / R * (kLogBN / C);
  const dim3 grid(npad / kLogBN, Bp / PT);
  const size_t smem = log_stream_smem(PT);
  cudaError_t code;
  for (int it = 0; it < n_iter; ++it) {
    k8b_step<C, R, false><<<grid, threads, smem, st>>>(G, F, npad, Cm, A, m, n, eps, inv);
    if ((code = cudaGetLastError()) != cudaSuccess) return static_cast<int>(code);
    ++*launched;
    k8b_step<C, R, true><<<grid, threads, smem, st>>>(F, G, npad, Cm, Bh, m, n, eps, inv);
    if ((code = cudaGetLastError()) != cudaSuccess) return static_cast<int>(code);
    ++*launched;
  }
  k8b_cost<C, R><<<grid, threads, smem, st>>>(F, G, npad, Cm, n, inv, rw);
  if ((code = cudaGetLastError()) != cudaSuccess) return static_cast<int>(code);
  ++*launched;
  k8b_sum<<<(m + 127) / 128, 128, 0, st>>>(rw, npad, n, m, out);
  if ((code = cudaGetLastError()) != cudaSuccess) return static_cast<int>(code);
  ++*launched;
  return 0;
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

// K8b, resident: A, Bh (m, n) float32 histograms; C (n, n) float32; out
// (m,) float32; npad, P and the thread tile, tc outputs x tr pairs (4 x 2,
// 4 x 1 or 1 x 1), from ops/sinkhorn_cuda.log_plan; inv = float32(1 /
// eps).  One launch.
int annchor_k8b_resident(const float* A, const float* Bh, const float* C, int m, int n,
                         int npad, int P, int tc, int tr, float eps, float inv, int n_iter,
                         float* out, void* stream) {
  if (m <= 0) return 0;
  const int threads = P / tr * ((n + tc - 1) / tc);
  const size_t smem = sizeof(float) * log_res_floats(npad, P);
  if (n < 1 || npad < n || npad % 32 != 0 || P < tr || P % tr != 0 || n_iter < 0 ||
      threads > kLogThreads || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = tc == 4 && tr == 2   ? k8b_resident<4, 2>
            : tc == 4 && tr == 1 ? k8b_resident<4, 1>
            : tc == 1 && tr == 1 ? k8b_resident<1, 1>
                                 : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int code = allow_smem(fn, smem);
  if (code != 0) return code;
  const long long blocks = (static_cast<long long>(m) + P - 1) / P;
  fn<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, Bh, C, m, n, npad, P, eps, inv, n_iter, out);
  return static_cast<int>(cudaGetLastError());
}

// K8b, streamed: arguments as annchor_k8b_resident, with npad (a multiple
// of 64), Bp (a multiple of the tile's PT pairs, at least m) from log_plan;
// ws, 2 Bp npad float32 zeros (f / eps, then g / eps); rw, Bp npad float64.
// 2 n_iter + 2 launches: the half steps, the cost's row sums, their sums;
// *launched is set to the launches made.
int annchor_k8b_streamed(const float* A, const float* Bh, const float* C, int m, int n,
                         int npad, int Bp, int PT, int tc, int tr, float eps, float inv,
                         int n_iter, float* ws, double* rw, float* out, int* launched,
                         void* stream) {
  *launched = 0;
  if (m <= 0) return 0;
  if (n < 1 || npad < n || npad % kLogBN != 0 || PT < tr || PT % tr != 0 || Bp < m ||
      Bp % PT != 0 || Bp / PT > 65535 || PT / tr * (kLogBN / tc) > kLogThreads || n_iter < 0 ||
      ws == nullptr || rw == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = tc == 4 && tr == 4   ? log_streamed<4, 4>
            : tc == 4 && tr == 2 ? log_streamed<4, 2>
            : tc == 4 && tr == 1 ? log_streamed<4, 1>
            : tc == 1 && tr == 1 ? log_streamed<1, 1>
                                 : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(A, Bh, C, m, n, npad, Bp, PT, eps, inv, n_iter, ws, rw, out, launched,
            static_cast<cudaStream_t>(stream));
}

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
