// K1: bit-parallel (Myers/Hyyrö) edit distance for a batch of string pairs.
//
// Replaces the TPU kernel `_kernel` of annchor_tpu/ops/levenshtein_pallas.py
// (launched by `_pallas_batch`) and, with it, the XLA tier
// `levenshtein_myers._myers_batch`: one kernel computes every edit
// distance of the fit (anchor columns, sample and refinement batches)
// and of BruteForce.
//
// What it computes.  For pair k = (I[k], J[k]) the pattern is the shorter
// string p (la characters) and the text the longer string t (lb >= la);
// the kernel makes that swap itself and writes out[k] in input order.  A
// pair of one string with itself (I[k] == J[k]) costs no work, except in
// a first thread-mode launch, which runs it as any other pair (the
// recurrence gives 0).
// The pattern's DP column is held as two bit-vectors VP/VN of
// W = ceil(la / 32) 32-bit words; each text character c updates them with
//
//     Eq  = peq[p, c, :]                 (bit i set iff p[i] == c)
//     D0  = (((Eq & VP) + VP) ^ VP) | Eq | VN     (multi-word add)
//     HP  = VN | ~(D0 | VP),  HN = VP & D0
//     X   = (HP << 1) | 1,   VP = (HN << 1) | ~(D0 | X),  VN = X & D0
//
// where the shifts run across words and the 1 shifted into HP's bit 0 is
// what makes this the edit-distance (not the search) variant.  VP/VN are
// the vertical deltas D(i, j) - D(i-1, j) of the current column and
// D(0, j) = j, so after the last character the distance is
//
//     D(la, lb) = lb + popc(VP & mask) - popc(VN & mask)
//
// over the la pattern bits.  No per-character score tap is needed, and an
// empty pattern gives lb with no special case.
//
// What bounds it on the H100.  The work is W * lb "word steps" per pair
// (one 32-bit word advanced by one character).  A word step needs at
// least 10 INT32 instructions: Eq & VP; the add with carry in and out
// (one IADD3.X chained through the carry predicate); D0 (two 3-input
// logic ops); HP and HN (one each); the two cross-word shifts (funnel
// shifts); VP and VN (one each).  The card issues 132 SMs x 64 INT32
// lanes x 1.98 GHz = 1.67e13 such instructions a second, so the bound is
// word_steps * 10 / 1.67e13 s.  The bytes are small next to that (peq
// and the text come from L2 and L1).  ptxas spends 11 on a word of
// thread mode (the k1_thread<20> SASS): it adds with IADD3 into two carry
// predicates and gathers them into a register with one more IADD3.X for
// the next word; each quad of words adds its guard, its 16-byte load and
// the branches around them, ~10 more.
//
// Three modes.  The wrapper's launch plan (ops/levenshtein_cuda.py) picks
// them from the batch size B and two word counts the host recorded when
// it encoded the dataset: `wbulk`, which 99 % of the strings do not
// exceed, and `wmax`, the longest string's.  The first launch is sized
// for wbulk and covers every pair; a pair whose pattern has more words
// than that launch holds goes onto an overflow list (an atomic counter
// and a slot) and is left to the next launch of the plan, which reads
// the list and its length on the card:
//
// - thread mode (`k1_thread<WB, LISTED>`): one thread owns one pair,
//   VP/VN in registers for patterns of at most WB words (WB in 4, 8, ...,
//   32, 48, 64), the carry and both shifts rippling through the unrolled
//   word loop, with one 16-byte load of Eq words and one guard per four
//   words.  The next character is read one step ahead.  It wins once B
//   gives the card enough warps (from 20,000-30,000 pairs at
//   strings-1600's W = 18):
//   it spends the fewest instructions per word step.  Below that its
//   limit is latency: a thread's chain is lb characters x W dependent
//   words.  It runs as the first launch (LISTED false), or over an
//   overflow list with a grid-stride loop and WB for the longest pattern
//   up to 64 words (LISTED true).
// - group mode (`k1_group<G, WPL, SMEM>`): G lanes of one warp (8, 16 or
//   32) own one pair, each lane WPL (1 or 2) consecutive words.  The add
//   crosses lanes through two ballots: lane i's generate bit g (carry out
//   of its words) and propagate bit p (its words sum to all ones), and
//   its carry in is bit i of ((G + (G | P)) ^ P); g and p are disjoint,
//   and each group's top lane reports neither, so that no carry crosses
//   from one group of the warp into the next.
//   The shifts take each word's top bit from the lane below
//   (__shfl_up_sync).  Text characters are loaded G at a time, one per
//   lane and coalesced, a chunk ahead, and broadcast with __shfl_sync; the
//   next character's Eq words are fetched one step ahead, from a per-lane
//   copy of the pattern's Peq words in shared memory (SMEM, alphabet x
//   WPL <= 32) or straight from the table.  A character step is then a
//   chain of ~25 dependent instructions (two ballots and a shuffle among
//   them) whatever W is, and a 1,600-pair column is 1,600 groups, not 13
//   blocks.  It wins for the fit's small batches (anchor columns, sample
//   batches), though a word step costs it more instructions than in
//   thread mode (the ballots, shuffles and carry-in bit on top).  It runs
//   only as the first launch.
// - long mode (`k1_long`): patterns of more than 64 words keep VP/VN in a
//   wrapper-allocated scratch buffer, word-major ([w][slot]), one
//   grid-stride thread per slot, over every pair or an overflow list.
//
// Registers per thread (ptxas -v, sm_90a, CUDA 12.8, as phase 1 of
// chip_smoke.py prints them); none spills:
//   k1_thread<WB, false>  WB 4: 32, 8: 48, 12: 48, 16: 62, 20: 75, 24: 86,
//                         28: 96, 32: 96, 48: 149, 64: 154
//   k1_thread<WB, true>   WB 4: 34, 8: 48, 12: 55, 16: 64, 20: 72, 24: 80,
//                         28: 89, 32: 96, 48: 128, 64: 160
//   k1_group<G,WPL,S>     32 with shared memory; 35-40 without
//   k1_long               48

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_step.cuh"

namespace {

constexpr int kThreads = 128;

// What every launch reads and writes.  I and J are int32 or int64
// (idx64) pair ids read at I[k * si], J[k * sj]; out is int32 (count,).
// `list`/`nlist`: the pairs to run, an overflow list and its length on
// the card (null: pairs 0 .. count-1).  `ovf`/`novf`: where a pair whose
// pattern has more words than the launch holds goes (null: the plan
// guarantees there is none).
struct Args {
  const uint32_t* __restrict__ peq;
  const int32_t* __restrict__ ids;
  const int32_t* __restrict__ lengths;
  const void* I;
  const void* J;
  int32_t* __restrict__ out;
  const int32_t* list;
  const int32_t* nlist;
  int32_t* ovf;
  int32_t* novf;
  int count, alphabet, wtab, L, si, sj, idx64;
};

// ---------------------------------------------------------------- thread

// The Eq words 4q .. 4q+3 of one text character: one 16-byte load where
// the table's rows are 16-byte aligned, else four guarded words.
__device__ __forceinline__ uint4 eq_quad(const uint32_t* __restrict__ eq,
                                         int q, bool vec4, int wtab) {
  if (vec4) return __ldg(reinterpret_cast<const uint4*>(eq) + q);
  const int w = 4 * q;
  return make_uint4(__ldg(eq + w), w + 1 < wtab ? __ldg(eq + w + 1) : 0u,
                    w + 2 < wtab ? __ldg(eq + w + 2) : 0u,
                    w + 3 < wtab ? __ldg(eq + w + 3) : 0u);
}

// Pair k in one thread.  WB is a multiple of 4: the word loop runs by
// quads, and a quad that starts below W runs whole (words past W hold
// state that never reaches the words below, and the score masks them
// off).  The first launch (not LISTED) runs a self pair like any other,
// the recurrence giving 0: the test for it slowed BruteForce there.  A
// self pair too long for it overflows to a launch that skips it.
template <int WB, bool LISTED>
__device__ __forceinline__ void thread_pair(const Args& a, int k) {
  static_assert(WB % 4 == 0, "thread-mode buckets are whole quads");
  const Pair q = load_pair(a, k, LISTED);
  const int W = (q.la + 31) >> 5;
  if (W > WB) {
    push_overflow(a, k);
    return;
  }
  if (q.la == 0) {
    a.out[k] = q.lb;
    return;
  }
  const bool vec4 =
      (a.wtab & 3) == 0 && (reinterpret_cast<uintptr_t>(a.peq) & 15) == 0;
  uint32_t VP[WB], VN[WB];
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    VP[w] = first_bits(q.la, w);
    VN[w] = 0u;
  }
  const uint32_t* peq_p = a.peq + (size_t)q.p * a.alphabet * a.wtab;
  const int32_t* text = a.ids + (size_t)q.t * a.L;
  int c = text[0];
  for (int j = 0; j < q.lb; ++j) {
    const uint32_t* eq = peq_p + (size_t)c * a.wtab;
    c = (j + 1 < q.lb) ? text[j + 1] : 0;
    uint32_t cy = 0u, php = 0x80000000u, phn = 0u;
#pragma unroll
    for (int b = 0; b < WB / 4; ++b) {
      if (4 * b < W) {
        const uint4 e = eq_quad(eq, b, vec4, a.wtab);
        myers_word(e.x, VP[4 * b], VN[4 * b], cy, php, phn);
        myers_word(e.y, VP[4 * b + 1], VN[4 * b + 1], cy, php, phn);
        myers_word(e.z, VP[4 * b + 2], VN[4 * b + 2], cy, php, phn);
        myers_word(e.w, VP[4 * b + 3], VN[4 * b + 3], cy, php, phn);
      }
    }
  }
  int score = q.lb;
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    const uint32_t m = first_bits(q.la, w);
    score += __popc(VP[w] & m) - __popc(VN[w] & m);
  }
  a.out[k] = score;
}

// LISTED: grid-stride threads over an overflow list; else one thread per
// pair, so that the first launch carries no loop state.
template <int WB, bool LISTED>
__global__ void __launch_bounds__(kThreads) k1_thread(const Args a) {
  if constexpr (LISTED) {
    const long long n = *a.nlist;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (long long)gridDim.x * kThreads)
      thread_pair<WB, true>(a, a.list[i]);
  } else {
    const unsigned k = blockIdx.x * kThreads + threadIdx.x;
    if (k < static_cast<unsigned>(a.count)) thread_pair<WB, false>(a, k);
  }
}

// ----------------------------------------------------------------- group

template <int G, int WPL, bool SMEM>
__global__ void __launch_bounds__(kThreads) k1_group(const Args a) {
  // per-lane copy of the pattern's Peq words: [c * WPL + i][threadIdx.x]
  extern __shared__ uint32_t s_eq[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gl = lane & (G - 1);   // lane within the group
  const long long gk = ((long long)blockIdx.x * kThreads + tid) / G;
  const bool active = gk < a.count;
  // every lane of the warp runs the loop (ballots and shuffles take the
  // whole warp); a group past the end works on the last pair, unwritten
  Pair q = load_pair(a, active ? gk : (long long)a.count - 1, true);
  // a pattern longer than the group's words is left to the next launch,
  // and the group idles as on an empty text, its result unwritten
  const bool over = ((q.la + 31) >> 5) > G * WPL;
  if (over) {
    if (active && gl == 0) push_overflow(a, gk);
    q.lb = 0;
  }
  const uint32_t* peq_p = a.peq + (size_t)q.p * a.alphabet * a.wtab;
  const int32_t* text = a.ids + (size_t)q.t * a.L;
  const int w0 = gl * WPL;

  uint32_t VP[WPL], VN[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    VP[i] = first_bits(q.la, w0 + i);
    VN[i] = 0u;
  }
  if constexpr (SMEM) {
    for (int c = 0; c < a.alphabet; ++c) {
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int w = w0 + i;
        s_eq[(c * WPL + i) * kThreads + tid] =
            w < a.wtab ? __ldg(peq_p + (size_t)c * a.wtab + w) : 0u;
      }
    }
  }
  auto fetch = [&](int c, uint32_t (&eq)[WPL]) {
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      if constexpr (SMEM) {
        eq[i] = s_eq[(c * WPL + i) * kThreads + tid];
      } else {
        const int w = w0 + i;
        eq[i] = w < a.wtab ? __ldg(peq_p + (size_t)c * a.wtab + w) : 0u;
      }
    }
  };

  const int lbmax = __reduce_max_sync(kFull, q.lb);
  // characters [j0, j0 + G) in `cur`, [j0 + G, j0 + 2G) in `nxt`
  int cur = gl < q.lb ? text[gl] : 0;
  int nxt = G + gl < q.lb ? text[G + gl] : 0;
  uint32_t eq[WPL];
  fetch(__shfl_sync(kFull, cur, 0, G), eq);
  for (int j = 0; j < lbmax; ++j) {
    const int jn = j + 1;
    if ((jn & (G - 1)) == 0) {
      cur = nxt;
      nxt = jn + G + gl < q.lb ? text[jn + G + gl] : 0;
    }
    uint32_t eqn[WPL];
    fetch(__shfl_sync(kFull, cur, jn & (G - 1), G), eqn);

    // the add (Eq & VP) + VP across the group's words: this lane's
    // generate bit (its words carry out) and propagate bit (they sum to
    // all ones).  The group's top lane reports neither, so no carry
    // crosses into the next group of the warp and the warp-wide ballots
    // need no shifting.
    uint32_t s[WPL], g;
    bool pr;
    if constexpr (WPL == 1) {
      const uint64_t t = static_cast<uint64_t>(eq[0] & VP[0]) + VP[0];
      s[0] = static_cast<uint32_t>(t);
      g = static_cast<uint32_t>(t >> 32);
      pr = s[0] == kFull;
    } else {
      const uint64_t t0 = static_cast<uint64_t>(eq[0] & VP[0]) + VP[0];
      const uint64_t t1 =
          static_cast<uint64_t>(eq[1] & VP[1]) + VP[1] + (t0 >> 32);
      s[0] = static_cast<uint32_t>(t0);
      s[1] = static_cast<uint32_t>(t1);
      g = static_cast<uint32_t>(t1 >> 32);
      pr = (s[0] & s[1]) == kFull;
    }
    const bool top = gl == G - 1;
    const uint32_t Gb = __ballot_sync(kFull, g != 0u && !top);
    const uint32_t Pb = __ballot_sync(kFull, pr && !top);
    const uint32_t cin = (((Gb + (Gb | Pb)) ^ Pb) >> lane) & 1u;
    if constexpr (WPL == 1) {
      s[0] += cin;
    } else {
      const uint64_t t = static_cast<uint64_t>(s[0]) + cin;
      s[0] = static_cast<uint32_t>(t);
      s[1] += static_cast<uint32_t>(t >> 32);
    }

    uint32_t d0[WPL], hp[WPL], hn[WPL];
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      d0[i] = (s[i] ^ VP[i]) | eq[i] | VN[i];
      hp[i] = VN[i] | ~(d0[i] | VP[i]);
      hn[i] = VP[i] & d0[i];
    }
    uint32_t php = __shfl_up_sync(kFull, hp[WPL - 1], 1, G);
    uint32_t phn = __shfl_up_sync(kFull, hn[WPL - 1], 1, G);
    if (gl == 0) {
      php = 0x80000000u;  // shifts the edit-distance 1 into HP's bit 0
      phn = 0u;
    }
    if (j < q.lb) {
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const uint32_t x = __funnelshift_l(i ? hp[i > 0 ? i - 1 : 0] : php, hp[i], 1);
        const uint32_t y = __funnelshift_l(i ? hn[i > 0 ? i - 1 : 0] : phn, hn[i], 1);
        VP[i] = y | ~(d0[i] | x);
        VN[i] = x & d0[i];
      }
    }
#pragma unroll
    for (int i = 0; i < WPL; ++i) eq[i] = eqn[i];
  }

  int score = 0;
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    const uint32_t m = first_bits(q.la, w0 + i);
    score += __popc(VP[i] & m) - __popc(VN[i] & m);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    score += __shfl_xor_sync(kFull, score, off, G);
  if (active && gl == 0 && !over) a.out[gk] = q.lb + score;
}

// ------------------------------------------------------------------ long

// Patterns of any length: state in global scratch, word-major
// ([w][slot]) so that neighbouring threads touch neighbouring words; each
// of the grid's `slots` threads walks the pairs i = slot, slot + slots, ...
__global__ void __launch_bounds__(kThreads) k1_long(
    const Args a, uint32_t* __restrict__ scratch) {
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  const int slots = gridDim.x * kThreads;
  uint32_t* VP = scratch + slot;
  uint32_t* VN = scratch + (size_t)a.wtab * slots + slot;
  const long long n = a.list ? *a.nlist : a.count;
  for (long long i = slot; i < n; i += slots) {
    const long long k = a.list ? a.list[i] : i;
    const Pair q = load_pair(a, k, true);
    const int W = (q.la + 31) >> 5;
    for (int w = 0; w < W; ++w) {
      VP[(size_t)w * slots] = first_bits(q.la, w);
      VN[(size_t)w * slots] = 0u;
    }
    const uint32_t* peq_p = a.peq + (size_t)q.p * a.alphabet * a.wtab;
    const int32_t* text = a.ids + (size_t)q.t * a.L;
    for (int j = 0; j < (W ? q.lb : 0); ++j) {
      const uint32_t* eq = peq_p + (size_t)text[j] * a.wtab;
      uint32_t cy = 0u, php = 0x80000000u, phn = 0u;
      for (int w = 0; w < W; ++w) {
        uint32_t vp = VP[(size_t)w * slots];
        uint32_t vn = VN[(size_t)w * slots];
        myers_word(__ldg(eq + w), vp, vn, cy, php, phn);
        VP[(size_t)w * slots] = vp;
        VN[(size_t)w * slots] = vn;
      }
    }
    int score = q.lb;
    for (int w = 0; w < W; ++w) {
      const uint32_t m = first_bits(q.la, w);
      score += __popc(VP[(size_t)w * slots] & m) -
               __popc(VN[(size_t)w * slots] & m);
    }
    a.out[k] = score;
  }
}

Args make_args(const void* peq, const void* ids, const void* lengths,
               const void* I, const void* J, void* out, const void* list,
               const void* nlist, void* ovf, void* novf, int count,
               int alphabet, int wtab, int L, int si, int sj, int idx64) {
  return Args{static_cast<const uint32_t*>(peq),
              static_cast<const int32_t*>(ids),
              static_cast<const int32_t*>(lengths),
              I, J, static_cast<int32_t*>(out),
              static_cast<const int32_t*>(list),
              static_cast<const int32_t*>(nlist),
              static_cast<int32_t*>(ovf), static_cast<int32_t*>(novf),
              count, alphabet, wtab, L, si, sj, idx64};
}

}  // namespace

// The C interface.  Every launcher takes the (n, alphabet, wtab) peq
// table, the (n, L) text-id table, the (n,) lengths, the pair ids I and J
// (int32 or int64 by idx64, read at I[k * si], J[k * sj]), the int32
// (count,) output, the input list and its length on the card (null: all
// `count` pairs), the overflow list and its counter (null: none), and a
// grid of `blocks` blocks of 128 threads; each runs on `stream` and
// returns the cudaError_t of its launch.
#define ANNCHOR_K1_ARGS                                                      \
  const void *peq, const void *ids, const void *lengths, const void *I,     \
      const void *J, void *out, const void *list, const void *nlist,        \
      void *ovf, void *novf, int count, int alphabet, int wtab, int L,      \
      int si, int sj, int idx64, int blocks
#define ANNCHOR_K1_MAKE_ARGS                                                 \
  make_args(peq, ids, lengths, I, J, out, list, nlist, ovf, novf, count,    \
            alphabet, wtab, L, si, sj, idx64)

extern "C" {

// Thread mode: one thread per pair, patterns of at most `wb` words.
int annchor_k1_thread(ANNCHOR_K1_ARGS, int wb, void* stream) {
  if (blocks <= 0) return 0;
  const Args a = ANNCHOR_K1_MAKE_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wb) {
#define ANNCHOR_WB(WB)                                   \
  case WB:                                               \
    if (list)                                            \
      k1_thread<WB, true><<<blocks, kThreads, 0, s>>>(a);  \
    else                                                 \
      k1_thread<WB, false><<<blocks, kThreads, 0, s>>>(a); \
    break;
    ANNCHOR_WB(4)
    ANNCHOR_WB(8)
    ANNCHOR_WB(12)
    ANNCHOR_WB(16)
    ANNCHOR_WB(20)
    ANNCHOR_WB(24)
    ANNCHOR_WB(28)
    ANNCHOR_WB(32)
    ANNCHOR_WB(48)
    ANNCHOR_WB(64)
#undef ANNCHOR_WB
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Group mode: `g` lanes per pair, `wpl` words per lane, the Peq words in
// shared memory when `smem` (alphabet * wpl * 128 * 4 bytes); the layouts
// of the launch plan (8x1, 8x2, 16x2, 32x2).  It runs every pair, never a
// list.
int annchor_k1_group(ANNCHOR_K1_ARGS, int g, int wpl, int smem,
                     void* stream) {
  if (blocks <= 0) return 0;
  if (list != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = ANNCHOR_K1_MAKE_ARGS;
  const size_t shared =
      smem ? (size_t)alphabet * wpl * kThreads * sizeof(uint32_t) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = g * 4 + wpl * 2 + (smem ? 1 : 0);
  switch (key) {
#define ANNCHOR_GROUP(G, WPL, SM)                                     \
  case G * 4 + WPL * 2 + SM:                                          \
    k1_group<G, WPL, (SM != 0)><<<blocks, kThreads, shared, s>>>(a);  \
    break;
    ANNCHOR_GROUP(8, 1, 0)
    ANNCHOR_GROUP(8, 1, 1)
    ANNCHOR_GROUP(8, 2, 0)
    ANNCHOR_GROUP(8, 2, 1)
    ANNCHOR_GROUP(16, 2, 0)
    ANNCHOR_GROUP(16, 2, 1)
    ANNCHOR_GROUP(32, 2, 0)
    ANNCHOR_GROUP(32, 2, 1)
#undef ANNCHOR_GROUP
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Long mode: patterns of any length, `scratch` holding 2 * wtab * blocks
// * 128 words.  It overflows nothing.
int annchor_k1_long(ANNCHOR_K1_ARGS, void* scratch, void* stream) {
  if (blocks <= 0) return 0;
  if (ovf != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  k1_long<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ANNCHOR_K1_MAKE_ARGS, static_cast<uint32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
