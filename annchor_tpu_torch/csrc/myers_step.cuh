// The Myers/Hyyrö word step and the per-pair helpers shared by the two
// bit-parallel edit-distance kernels: K1 (levenshtein_myers.cu, a dense
// Peq table per string) and K10 (levenshtein_rowdp.cu, a sparse one).
// Each kernel's `Args` has the fields these templates read: the pair ids
// I, J (int32 or int64 by idx64, read at I[k * si], J[k * sj]), the
// lengths and the overflow list `ovf` with its counter `novf`.

#pragma once

#include <cstdint>

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;

// The bits of pattern word w that hold characters of a pattern of la.
__device__ __forceinline__ uint32_t first_bits(int la, int w) {
  const int nbits = la - 32 * w;
  if (nbits >= 32) return kFull;
  if (nbits <= 0) return 0u;
  return (1u << nbits) - 1u;
}

__device__ __forceinline__ int load_index(const void* ix, long long k,
                                          int stride, int idx64) {
  const long long at = k * stride;
  return idx64 ? static_cast<int>(static_cast<const int64_t*>(ix)[at])
               : static_cast<const int32_t*>(ix)[at];
}

// The pair's pattern row p and text row t (lengths[p] <= lengths[t]).
// With `self_zero`, a string against itself reads as two empty strings
// (distance 0, no work).
struct Pair {
  int p, t, la, lb;
};

template <class Args>
__device__ __forceinline__ Pair load_pair(const Args& a, long long k,
                                          bool self_zero) {
  Pair r;
  r.p = load_index(a.I, k, a.si, a.idx64);
  r.t = load_index(a.J, k, a.sj, a.idx64);
  if (self_zero && r.p == r.t) {
    r.la = r.lb = 0;
    return r;
  }
  r.la = a.lengths[r.p];
  r.lb = a.lengths[r.t];
  if (r.la > r.lb) {
    const int p = r.p, la = r.la;
    r.p = r.t;
    r.la = r.lb;
    r.t = p;
    r.lb = la;
  }
  return r;
}

template <class Args>
__device__ __forceinline__ void push_overflow(const Args& a, long long k) {
  a.ovf[atomicAdd(a.novf, 1)] = static_cast<int32_t>(k);
}

// One word of the step: 11 instructions as ptxas compiles it.  `cy`
// carries the add's carry, `php`/`phn` the previous word's HP/HN (top bit
// shifted in).
__device__ __forceinline__ void myers_word(uint32_t eq, uint32_t& vp,
                                           uint32_t& vn, uint32_t& cy,
                                           uint32_t& php, uint32_t& phn) {
  const uint32_t a = eq & vp;
  const uint64_t t = static_cast<uint64_t>(a) + vp + cy;
  const uint32_t s = static_cast<uint32_t>(t);
  cy = static_cast<uint32_t>(t >> 32);
  const uint32_t d0 = (s ^ vp) | eq | vn;
  const uint32_t hp = vn | ~(d0 | vp);
  const uint32_t hn = vp & d0;
  const uint32_t x = __funnelshift_l(php, hp, 1);
  const uint32_t y = __funnelshift_l(phn, hn, 1);
  php = hp;
  phn = hn;
  vp = y | ~(d0 | x);
  vn = x & d0;
}

}  // namespace
