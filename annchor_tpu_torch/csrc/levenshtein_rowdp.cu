// K10: edit distance for alphabets of more than 192 symbols, by K1's
// bit-parallel (Myers/Hyyrö) word step over a per-string sparse Peq table.
//
// Replaces the XLA program `_lev_batch` of annchor_tpu/ops/levenshtein.py
// (reached from `levenshtein_pairs` whenever `MyersEncoding.from_codes`
// finds too many symbols), not a Pallas kernel.  Its plain PyTorch version
// is `lev_pairs_plain` in annchor_tpu_torch/ops/levenshtein.py (the row
// DP); `sparse_myers_pairs_plain` there runs this kernel's table, search
// and word step on the CPU.
//
// Why a sparse table.  K1's Peq holds a row for every symbol of the
// dataset's alphabet in every string, (n, alphabet, W) words, which is
// why the JAX package stops at 192 symbols.  A pattern needs Eq rows only
// for the symbols it contains, so `RowDPEncoding` keeps, per string s:
//
//     sym[soff[s] .. soff[s+1])   its distinct code points, ascending;
//     mask[moff[s] + r * Wp + w]  word w of the position mask of its r-th
//                                 symbol; W = ceil(len / 32) words, rows
//                                 Wp = W rounded up to 4 apart, so that a
//                                 row starts on 16 bytes (moff is a
//                                 multiple of 4 too).
//
// At most sum(ceil(len / 32) * min(len, alphabet)) words, whatever the
// alphabet.  A text character c finds its row by a binary search of the
// pattern's symbols (the branchless halving below, ceil(log2 n) + 1
// probes for n symbols); a symbol the pattern lacks has the zero row.
// Then the word step of K1 (myers_step.cuh; the recurrence is described
// in levenshtein_myers.cu), and D(la, lb) = lb + popc(VP) - popc(VN) over
// the pattern's bits.  The pattern is the shorter string of the pair (the
// kernel swaps), a pair of one string with itself gives 0 with no work,
// and an empty pattern gives lb.
//
// What bounds it on the H100.  The word steps (W x lb a pair) at K1's 10
// INT32 instructions each, plus the search: each probe is at least a
// compare and a select, 2 instructions, ceil(log2 n) + 1 probes per text
// character.  The card issues 132 SMs x 64 INT32 lanes x 1.98 GHz =
// 1.67e13 of them a second, so the bound is
// (10 * word_steps + 2 * probes) / 1.67e13 s (chip_smoke.py phase 12(c)
// prints both counts).  The tables come from L2 and L1; their bytes are
// far below that.  The row DP this kernel replaced spent about 5
// instructions a cell, 32 x 5 per word step.
//
// Three modes, as K1's, planned by ops/levenshtein_rowdp_cuda.py from the
// batch size B and the word counts the host recorded with the table
// (`wbulk`, which 99 % of the strings do not exceed, and `wmax`); a pair
// whose pattern has more words than its launch holds goes onto an
// overflow list on the card, which the plan's next launch runs:
//
// - thread mode (`k10_thread<WB, LISTED>`): one thread owns one pair,
//   VP/VN in registers for patterns of at most WB words, the Eq words of
//   a character read as 16-byte quads.  The next character's row is
//   searched one step ahead, before the word loop of the current one;
//   the search's chain of dependent loads is hidden by the other warps.
// - group mode (`k10_group<G, WPL, SMEM>`): G lanes of a warp own one
//   pair, WPL words each, the add carried across lanes by K1's two
//   ballots.  Text characters come G at a time, one per lane, and each
//   lane searches the row of its own character of the NEXT chunk one
//   probe per step (two for G = 8), each probe's load issued a step
//   before its value is used: the search is spread over the chunk's G
//   steps and leaves the per-character chain, which carries a shuffle of
//   the row index and the fetch of its Eq words one step ahead.  With
//   SMEM, a group whose pattern's table (n symbols + n x Wp words) fits
//   its share of the block's dynamic shared memory copies it there;
//   other groups read it through __ldg.
// - long mode (`k10_long`): patterns of more than 64 words keep VP/VN in
//   a wrapper-allocated scratch buffer, word-major ([w][slot]), one
//   grid-stride thread per slot, over every pair or an overflow list.

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_step.cuh"

namespace {

constexpr int kThreads = 128;
// the dynamic shared memory a block may take without an opt-in
constexpr size_t kSharedMax = 48 * 1024;

// What every launch reads and writes: the sparse table (sym, soff, mask,
// moff), the (n, L) code points of the texts, the lengths, the pair ids,
// the output and the lists as in K1 (`list`/`nlist`: the pairs to run,
// null for 0 .. count-1; `ovf`/`novf`: where an oversized pattern goes).
struct Args {
  const int32_t* __restrict__ sym;
  const int64_t* __restrict__ soff;
  const uint32_t* __restrict__ mask;
  const int64_t* __restrict__ moff;
  const int32_t* __restrict__ ids;
  const int32_t* __restrict__ lengths;
  const void* I;
  const void* J;
  int32_t* __restrict__ out;
  const int32_t* list;
  const int32_t* nlist;
  int32_t* ovf;
  int32_t* novf;
  int count, L, si, sj, idx64;
};

__device__ __forceinline__ int row_words(int la) {
  return (((la + 31) >> 5) + 3) & ~3;
}

// A pattern's table in device memory: its n symbols and its rows, wp
// words apart.
struct Table {
  const int32_t* sym;
  const uint32_t* mask;
  int n, wp;
};

__device__ __forceinline__ Table load_table(const Args& a, int p, int la) {
  const long long s0 = a.soff[p];
  return Table{a.sym + s0, a.mask + a.moff[p],
               static_cast<int>(a.soff[p + 1] - s0), row_words(la)};
}

// The row of symbol c in the table, or -1: halve [lo, lo + len) on
// sym[lo + len / 2] <= c, then compare the one candidate left.
__device__ __forceinline__ int find_row(const Table& t, int c) {
  int lo = 0, len = t.n;
  while (len > 1) {
    const int half = len >> 1;
    if (__ldg(t.sym + lo + half) <= c) lo += half;
    len -= half;
  }
  return (len == 1 && __ldg(t.sym + lo) == c) ? lo : -1;
}

// ---------------------------------------------------------------- thread

template <int WB, bool LISTED>
__device__ __forceinline__ void thread_pair(const Args& a, long long k) {
  static_assert(WB % 4 == 0, "thread-mode buckets are whole quads");
  const Pair q = load_pair(a, k, true);
  const int W = (q.la + 31) >> 5;
  if (W > WB) {
    push_overflow(a, k);
    return;
  }
  if (q.la == 0) {
    a.out[k] = q.lb;
    return;
  }
  const Table tb = load_table(a, q.p, q.la);
  uint32_t VP[WB], VN[WB];
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    VP[w] = first_bits(q.la, w);
    VN[w] = 0u;
  }
  const int32_t* text = a.ids + (size_t)q.t * a.L;
  int row = find_row(tb, text[0]);
  for (int j = 0; j < q.lb; ++j) {
    // the rows are 16-byte aligned and Wp words long, so a quad that
    // starts below W lies inside the row
    const bool hit = row >= 0;
    const uint4* eq = reinterpret_cast<const uint4*>(
        tb.mask + (size_t)(hit ? row : 0) * tb.wp);
    row = j + 1 < q.lb ? find_row(tb, text[j + 1]) : -1;  // one step ahead
    uint32_t cy = 0u, php = 0x80000000u, phn = 0u;
#pragma unroll
    for (int b = 0; b < WB / 4; ++b) {
      if (4 * b < W) {
        const uint4 e = hit ? __ldg(eq + b) : make_uint4(0u, 0u, 0u, 0u);
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
// pair.
template <int WB, bool LISTED>
__global__ void __launch_bounds__(kThreads) k10_thread(const Args a) {
  if constexpr (LISTED) {
    const long long n = *a.nlist;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (long long)gridDim.x * kThreads)
      thread_pair<WB, true>(a, a.list[i]);
  } else {
    const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (k < a.count) thread_pair<WB, false>(a, k);
  }
}

// ----------------------------------------------------------------- group

// A group's view of its pattern's table: in shared memory when staged,
// else in device memory, read through __ldg.
template <bool SMEM>
struct GroupTable {
  const int32_t* gsym;
  const uint32_t* gmask;
  const int32_t* ssym;
  const uint32_t* smask;
  int n, wp;
  bool staged;

  __device__ __forceinline__ int sym(int i) const {
    if (SMEM && staged) return ssym[i];
    return __ldg(gsym + i);
  }
  __device__ __forceinline__ uint32_t word(int r, int w) const {
    if (SMEM && staged) return smask[r * wp + w];
    return __ldg(gmask + (size_t)r * wp + w);
  }
};

// find_row one probe at a time: `v` holds the probe loaded by the
// previous call (sym[lo + len / 2], or sym[lo] once len is 1), so its
// load has a whole character step to arrive.  `row` is final once len is
// 0: after ceil(log2 n) + 1 calls.
struct Search {
  int c, lo, len, v, row;

  template <class T>
  __device__ __forceinline__ void start(const T& t, int ch) {
    c = ch;
    lo = 0;
    len = t.n;
    row = -1;
    v = len > 0 ? t.sym(len >> 1) : 0;
  }
  template <class T>
  __device__ __forceinline__ void step(const T& t) {
    if (len > 1) {
      const int half = len >> 1;
      if (v <= c) lo += half;
      len -= half;
      v = t.sym(lo + (len >> 1));
    } else if (len == 1) {
      row = v == c ? lo : -1;
      len = 0;
    }
  }
};

__host__ __device__ constexpr int ceil_log2(int n) {
  return n <= 1 ? 0 : 1 + ceil_log2((n + 1) / 2);
}

// G = 8 holds patterns of up to 512 symbols (10 probes) in 8 steps: two
// probes a step.  G = 16 and 32 need at most 11 and 12 probes.
template <int G, int WPL, bool SMEM>
__global__ void __launch_bounds__(kThreads)
    k10_group(const Args a, int smem_words) {
  static_assert(ceil_log2(32 * G * WPL) + 1 <= (G == 8 ? 2 * G : G),
                "the chunk's steps must cover the search's probes");
  // each group's share: [sym: n][mask: n * wp], smem_words in all
  extern __shared__ uint32_t s_tab[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gl = lane & (G - 1);
  const long long gk = ((long long)blockIdx.x * kThreads + tid) / G;
  const bool active = gk < a.count;
  // every lane of the warp runs the loop (ballots and shuffles take the
  // whole warp); a group past the end works on the last pair, unwritten
  Pair q = load_pair(a, active ? gk : (long long)a.count - 1, true);
  const int W = (q.la + 31) >> 5;
  // a pattern longer than the group's words is left to the next launch,
  // and the group idles as on an empty text and an empty table
  const bool over = W > G * WPL;
  if (over) {
    if (active && gl == 0) push_overflow(a, gk);
    q.lb = 0;
  }
  GroupTable<SMEM> tb;
  const long long s0 = a.soff[q.p];
  tb.gsym = a.sym + s0;
  tb.gmask = a.mask + a.moff[q.p];
  tb.n = over ? 0 : static_cast<int>(a.soff[q.p + 1] - s0);
  tb.wp = row_words(q.la);
  tb.ssym = nullptr;
  tb.smask = nullptr;
  tb.staged = false;
  if constexpr (SMEM) {
    uint32_t* mine = s_tab + (size_t)(tid / G) * smem_words;
    tb.staged = tb.n * (tb.wp + 1) <= smem_words;
    if (tb.staged) {
      int32_t* ss = reinterpret_cast<int32_t*>(mine);
      uint32_t* sm = mine + tb.n;
      for (int i = gl; i < tb.n; i += G) ss[i] = __ldg(tb.gsym + i);
      for (int i = gl; i < tb.n * tb.wp; i += G) sm[i] = __ldg(tb.gmask + i);
      tb.ssym = ss;
      tb.smask = sm;
    }
    __syncwarp();
  }
  const int32_t* text = a.ids + (size_t)q.t * a.L;
  const int w0 = gl * WPL;

  uint32_t VP[WPL], VN[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    VP[i] = first_bits(q.la, w0 + i);
    VN[i] = 0u;
  }
  auto fetch = [&](int row, uint32_t (&eq)[WPL]) {
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const int w = w0 + i;
      eq[i] = (row >= 0 && w < W) ? tb.word(row, w) : 0u;
    }
  };

  const int lbmax = __reduce_max_sync(kFull, q.lb);
  // chunk 0's rows by a whole search per lane; chunk 1's searched one
  // probe a step while chunk 0 runs
  Search s;
  s.start(tb, gl < q.lb ? text[gl] : -1);
  while (s.len > 0) s.step(tb);
  int cur = s.row;  // the row of character j0 + gl of the current chunk
  s.start(tb, G + gl < q.lb ? text[G + gl] : -1);
  uint32_t eq[WPL];
  fetch(__shfl_sync(kFull, cur, 0, G), eq);
  for (int j = 0; j < lbmax; ++j) {
    s.step(tb);
    if constexpr (G == 8) s.step(tb);
    const int jn = j + 1;
    if ((jn & (G - 1)) == 0) {
      cur = s.row;
      s.start(tb, jn + G + gl < q.lb ? text[jn + G + gl] : -1);
    }
    uint32_t eqn[WPL];
    fetch(__shfl_sync(kFull, cur, jn & (G - 1), G), eqn);

    // the add (Eq & VP) + VP across the group's words, as in K1
    uint32_t sum[WPL], g;
    bool pr;
    if constexpr (WPL == 1) {
      const uint64_t t = static_cast<uint64_t>(eq[0] & VP[0]) + VP[0];
      sum[0] = static_cast<uint32_t>(t);
      g = static_cast<uint32_t>(t >> 32);
      pr = sum[0] == kFull;
    } else {
      const uint64_t t0 = static_cast<uint64_t>(eq[0] & VP[0]) + VP[0];
      const uint64_t t1 =
          static_cast<uint64_t>(eq[1] & VP[1]) + VP[1] + (t0 >> 32);
      sum[0] = static_cast<uint32_t>(t0);
      sum[1] = static_cast<uint32_t>(t1);
      g = static_cast<uint32_t>(t1 >> 32);
      pr = (sum[0] & sum[1]) == kFull;
    }
    const bool top = gl == G - 1;
    const uint32_t Gb = __ballot_sync(kFull, g != 0u && !top);
    const uint32_t Pb = __ballot_sync(kFull, pr && !top);
    const uint32_t cin = (((Gb + (Gb | Pb)) ^ Pb) >> lane) & 1u;
    if constexpr (WPL == 1) {
      sum[0] += cin;
    } else {
      const uint64_t t = static_cast<uint64_t>(sum[0]) + cin;
      sum[0] = static_cast<uint32_t>(t);
      sum[1] += static_cast<uint32_t>(t >> 32);
    }

    uint32_t d0[WPL], hp[WPL], hn[WPL];
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      d0[i] = (sum[i] ^ VP[i]) | eq[i] | VN[i];
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
// ([w][slot], `wtab` words a slot); each of the grid's `slots` threads
// walks the pairs i = slot, slot + slots, ...
__global__ void __launch_bounds__(kThreads)
    k10_long(const Args a, uint32_t* __restrict__ scratch, int wtab) {
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  const int slots = gridDim.x * kThreads;
  uint32_t* VP = scratch + slot;
  uint32_t* VN = scratch + (size_t)wtab * slots + slot;
  const long long n = a.list ? *a.nlist : a.count;
  for (long long i = slot; i < n; i += slots) {
    const long long k = a.list ? a.list[i] : i;
    const Pair q = load_pair(a, k, true);
    const int W = (q.la + 31) >> 5;
    for (int w = 0; w < W; ++w) {
      VP[(size_t)w * slots] = first_bits(q.la, w);
      VN[(size_t)w * slots] = 0u;
    }
    const Table tb = load_table(a, q.p, q.la);
    const int32_t* text = a.ids + (size_t)q.t * a.L;
    for (int j = 0; j < (W ? q.lb : 0); ++j) {
      const int row = find_row(tb, text[j]);
      const uint32_t* eq = tb.mask + (size_t)(row >= 0 ? row : 0) * tb.wp;
      uint32_t cy = 0u, php = 0x80000000u, phn = 0u;
      for (int w = 0; w < W; ++w) {
        uint32_t vp = VP[(size_t)w * slots];
        uint32_t vn = VN[(size_t)w * slots];
        myers_word(row >= 0 ? __ldg(eq + w) : 0u, vp, vn, cy, php, phn);
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

}  // namespace

// The C interface.  Every launcher takes the sparse table (sym int32,
// soff int64 (n+1), mask uint32, moff int64 (n+1)), the (n, L) int32
// code points, the (n,) int32 lengths, the pair ids I and J (int32 or
// int64 by idx64, read at I[k * si], J[k * sj]), the int32 (count,)
// output, the input list and its length on the card (null: all `count`
// pairs), the overflow list and its counter (null: none), and a grid of
// `blocks` blocks of 128 threads; each runs on `stream` and returns the
// cudaError_t of its launch.
#define ANNCHOR_K10_ARGS                                                     \
  const void *sym, const void *soff, const void *mask, const void *moff,    \
      const void *ids, const void *lengths, const void *I, const void *J,   \
      void *out, const void *list, const void *nlist, void *ovf,            \
      void *novf, int count, int L, int si, int sj, int idx64, int blocks
#define ANNCHOR_K10_MAKE_ARGS                                                \
  Args {                                                                     \
    static_cast<const int32_t*>(sym), static_cast<const int64_t*>(soff),    \
        static_cast<const uint32_t*>(mask),                                  \
        static_cast<const int64_t*>(moff),                                   \
        static_cast<const int32_t*>(ids),                                    \
        static_cast<const int32_t*>(lengths), I, J,                          \
        static_cast<int32_t*>(out), static_cast<const int32_t*>(list),      \
        static_cast<const int32_t*>(nlist), static_cast<int32_t*>(ovf),     \
        static_cast<int32_t*>(novf), count, L, si, sj, idx64                 \
  }

extern "C" {

// Thread mode: one thread per pair, patterns of at most `wb` words.
int annchor_k10_thread(ANNCHOR_K10_ARGS, int wb, void* stream) {
  if (blocks <= 0) return 0;
  const Args a = ANNCHOR_K10_MAKE_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wb) {
#define ANNCHOR_WB(WB)                                      \
  case WB:                                                  \
    if (list)                                               \
      k10_thread<WB, true><<<blocks, kThreads, 0, s>>>(a);  \
    else                                                    \
      k10_thread<WB, false><<<blocks, kThreads, 0, s>>>(a); \
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

// Group mode: `g` lanes per pair, `wpl` words per lane (8x1, 8x2, 16x2,
// 32x2, the layouts of K1's plan); with `smem_words` > 0 each group has
// that many words of dynamic shared memory for its pattern's table
// (smem_words * 128 / g * 4 bytes a block, at most 48 KB).  It runs every
// pair, never a list.
int annchor_k10_group(ANNCHOR_K10_ARGS, int g, int wpl, int smem_words,
                      void* stream) {
  if (blocks <= 0) return 0;
  if (list != nullptr || smem_words < 0 || g <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = (size_t)smem_words * (kThreads / g) * sizeof(uint32_t);
  if (shared > kSharedMax) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = ANNCHOR_K10_MAKE_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = g * 4 + wpl * 2 + (smem_words > 0 ? 1 : 0);
  switch (key) {
#define ANNCHOR_GROUP(G, WPL, SM)                                          \
  case G * 4 + WPL * 2 + SM:                                               \
    k10_group<G, WPL, (SM != 0)><<<blocks, kThreads, shared, s>>>(a,       \
                                                                  smem_words); \
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
// * 128 words, wtab at least the longest pattern's words.  It overflows
// nothing.
int annchor_k10_long(ANNCHOR_K10_ARGS, int wtab, void* scratch,
                     void* stream) {
  if (blocks <= 0) return 0;
  if (ovf != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  k10_long<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ANNCHOR_K10_MAKE_ARGS, static_cast<uint32_t*>(scratch), wtab);
  return static_cast<int>(cudaGetLastError());
}

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
