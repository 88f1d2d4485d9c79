// Bit-parallel (Myers/Hyyrö) edit distance for a batch of string pairs.
//
// Replaces the TPU kernel `_kernel` of annchor_tpu/ops/levenshtein_pallas.py
// (launched by `_pallas_batch`) and, with it, the XLA tier
// `levenshtein_myers._myers_batch`: one kernel computes every edit
// distance of the fit (anchor columns, sample and refinement batches)
// and of BruteForce.
//
// What it computes.  For pair k the pattern is the shorter string p
// (la characters) and the text the longer string t (lb >= la).  The
// pattern's DP column is held as two bit-vectors VP/VN of
// W = ceil(la / 32) 32-bit words; each text character c updates them
// with the Myers step
//
//     Eq  = peq[p, c, :]                 (bit i set iff p[i] == c)
//     D0  = (((Eq & VP) + VP) ^ VP) | Eq | VN     (multi-word add)
//     HP  = VN | ~(D0 | VP),  HN = VP & D0
//     score += HP[la-1] - HN[la-1]
//     X   = (HP << 1) | 1,   VP = (HN << 1) | ~(D0 | X),  VN = X & D0
//
// where the shifts run across words and the 1 shifted into HP's bit 0 is
// what makes this the edit-distance (not the search) variant.  The score
// starts at la; an empty pattern gives lb.
//
// Design for Hopper.  The TPU kernel put pairs on the 128-wide lane axis
// and selected Eq through bitplanes because a per-lane gather is slow
// there.  Here one thread owns one pair: VP/VN live in registers (a
// template on the word bucket WB in {1,2,4,8,16,32,64} unrolls the word
// loop fully, guarded by `w < W`), the carry of the addition and the
// bits of both shifts ripple through the word loop in registers, and Eq
// is read straight from the (n, alphabet, wtab) table.  Patterns longer
// than 64 words keep VP/VN in a scratch buffer the wrapper allocates.
// The wrapper swaps each pair so the pattern is the shorter string,
// sorts pairs by pattern words and launches one bucket per segment, so
// a warp's threads run loops of nearly the same length.
//
// What bounds it on the H100: integer ALU work, about 17 operations per
// pattern word per text character (W = 18 words at the strings-1600
// shape), and the reads of `peq` and of the text, which come from L2
// (the peq table is 1600 x 4 x 18 x 4 B = 0.46 MB there).  Known limits,
// left for later work: an anchor column is only 1600 pairs, 13 blocks of
// 128 threads on 132 SMs; text reads are one int32 per thread per step
// and are not coalesced across the warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// One word of the Myers step.  `add_c`, `hp_c` and `hn_c` carry the
// addition's carry and the top bits of HP and HN into the next word.
__device__ __forceinline__ void myers_word(
    uint32_t eq, uint32_t& vp, uint32_t& vn, uint32_t& add_c,
    uint32_t& hp_c, uint32_t& hn_c, uint32_t& hp, uint32_t& hn) {
  const uint32_t a = eq & vp;
  const uint32_t s1 = a + vp;
  const uint32_t s2 = s1 + add_c;
  add_c = (s1 < a) | (s2 < s1);
  const uint32_t d0 = (s2 ^ vp) | eq | vn;
  hp = vn | ~(d0 | vp);
  hn = vp & d0;
  const uint32_t x = (hp << 1) | hp_c;
  const uint32_t hns = (hn << 1) | hn_c;
  hp_c = hp >> 31;
  hn_c = hn >> 31;
  vp = hns | ~(d0 | x);
  vn = x & d0;
}

__device__ __forceinline__ uint32_t first_bits(int la, int w) {
  const int nbits = la - 32 * w;
  if (nbits >= 32) return 0xFFFFFFFFu;
  if (nbits <= 0) return 0u;
  return (1u << nbits) - 1u;
}

// State in registers: patterns of at most WB words.
template <int WB>
__global__ void __launch_bounds__(kThreads) myers_pairs_reg(
    const uint32_t* __restrict__ peq, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ pat,
    const int32_t* __restrict__ txt, int32_t* __restrict__ out, int count,
    int alphabet, int wtab, int L) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  const int p = pat[k];
  const int t = txt[k];
  const int la = lengths[p];
  const int lb = lengths[t];
  if (la == 0) {
    out[k] = lb;
    return;
  }
  const int W = (la + 31) >> 5;
  const int tap_w = (la - 1) >> 5;
  const uint32_t tap = 1u << ((la - 1) & 31);
  uint32_t VP[WB], VN[WB];
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    VP[w] = first_bits(la, w);
    VN[w] = 0u;
  }
  const uint32_t* peq_p = peq + (size_t)p * alphabet * wtab;
  const int32_t* text = ids + (size_t)t * L;
  int score = la;
  for (int j = 0; j < lb; ++j) {
    const uint32_t* eq = peq_p + (size_t)text[j] * wtab;
    uint32_t add_c = 0u, hp_c = 1u, hn_c = 0u;
#pragma unroll
    for (int w = 0; w < WB; ++w) {
      if (w < W) {
        uint32_t hp, hn;
        myers_word(__ldg(eq + w), VP[w], VN[w], add_c, hp_c, hn_c, hp, hn);
        if (w == tap_w) score += ((hp & tap) != 0u) - ((hn & tap) != 0u);
      }
    }
  }
  out[k] = score;
}

// State in global scratch, word-major ([w][k]) so that neighbouring
// threads touch neighbouring words: patterns of more than 64 words.
__global__ void __launch_bounds__(kThreads) myers_pairs_scratch(
    const uint32_t* __restrict__ peq, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ pat,
    const int32_t* __restrict__ txt, int32_t* __restrict__ out,
    uint32_t* __restrict__ scratch, int count, int alphabet, int wtab,
    int L) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  const int p = pat[k];
  const int t = txt[k];
  const int la = lengths[p];
  const int lb = lengths[t];
  if (la == 0) {
    out[k] = lb;
    return;
  }
  const int W = (la + 31) >> 5;
  const int tap_w = (la - 1) >> 5;
  const uint32_t tap = 1u << ((la - 1) & 31);
  uint32_t* VP = scratch + k;
  uint32_t* VN = scratch + (size_t)wtab * count + k;
  for (int w = 0; w < W; ++w) {
    VP[(size_t)w * count] = first_bits(la, w);
    VN[(size_t)w * count] = 0u;
  }
  const uint32_t* peq_p = peq + (size_t)p * alphabet * wtab;
  const int32_t* text = ids + (size_t)t * L;
  int score = la;
  for (int j = 0; j < lb; ++j) {
    const uint32_t* eq = peq_p + (size_t)text[j] * wtab;
    uint32_t add_c = 0u, hp_c = 1u, hn_c = 0u;
    for (int w = 0; w < W; ++w) {
      uint32_t vp = VP[(size_t)w * count];
      uint32_t vn = VN[(size_t)w * count];
      uint32_t hp, hn;
      myers_word(__ldg(eq + w), vp, vn, add_c, hp_c, hn_c, hp, hn);
      if (w == tap_w) score += ((hp & tap) != 0u) - ((hn & tap) != 0u);
      VP[(size_t)w * count] = vp;
      VN[(size_t)w * count] = vn;
    }
  }
  out[k] = score;
}

}  // namespace

extern "C" {

// Launch one word bucket on `count` pairs.  `pat`/`txt` are row ids into
// the (n, alphabet, wtab) peq table and the (n, L) text-id table, already
// swapped so that lengths[pat] <= lengths[txt]; every pattern of the
// segment has at most `bucket` words (bucket 0: more than 64 words, state
// in `scratch`, which holds 2 * wtab * count words).  Runs on `stream`;
// returns the cudaError_t of the launch.
int annchor_myers_pairs(const void* peq, const void* ids, const void* lengths,
                        const void* pat, const void* txt, void* out,
                        void* scratch, int count, int alphabet, int wtab,
                        int L, int bucket, void* stream) {
  if (count <= 0) return 0;
  const dim3 grid((count + kThreads - 1) / kThreads);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* P = static_cast<const uint32_t*>(peq);
  const auto* I = static_cast<const int32_t*>(ids);
  const auto* N = static_cast<const int32_t*>(lengths);
  const auto* A = static_cast<const int32_t*>(pat);
  const auto* B = static_cast<const int32_t*>(txt);
  auto* O = static_cast<int32_t*>(out);
  switch (bucket) {
#define ANNCHOR_BUCKET(WB)                                                  \
  case WB:                                                                  \
    myers_pairs_reg<WB><<<grid, block, 0, s>>>(P, I, N, A, B, O, count,     \
                                               alphabet, wtab, L);          \
    break;
    ANNCHOR_BUCKET(1)
    ANNCHOR_BUCKET(2)
    ANNCHOR_BUCKET(4)
    ANNCHOR_BUCKET(8)
    ANNCHOR_BUCKET(16)
    ANNCHOR_BUCKET(32)
    ANNCHOR_BUCKET(64)
#undef ANNCHOR_BUCKET
    case 0:
      myers_pairs_scratch<<<grid, block, 0, s>>>(
          P, I, N, A, B, O, static_cast<uint32_t*>(scratch), count, alphabet,
          wtab, L);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
