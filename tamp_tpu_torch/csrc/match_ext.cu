// Kernels B1, B2 and B5: match tables of the window model, one source and
// one kernel template.
//
// Replaces three TPU kernels that compute one definition
// (tamp_tpu/engine/search_np.py match_tables / match_tables_ext) in three
// layouts shaped by TPU costs:
//   B1  tamp_tpu/ops/match_ext_pallas.py::_kernel_swar  (entry tpt_ext_tables)
//   B2  tamp_tpu/ops/match_ext_pallas.py::_kernel       (tpt_ext_tables_probe)
//   B5  tamp_tpu/ops/match_pallas.py::_kernel_body      (tpt_v1_tables)
//
// For every position t of every shard it finds, over all W ring slots, the
// longest linear-buffer match of the target (runs stop at npos) against the
// window model C = dict || row, lowest ring slot among the longest: the
// score is len * W + (W - 1 - slot).  A candidate at slot x is capped by the
// linear buffer at W - x; a candidate just behind the write head (delta =
// W - j bytes from it) continues past the head with the oldest ring bytes
// (the glue diagonals of engine/search_np.py).  Families:
//   main   target row[t:], runs to 16, scored at cap `cap_main` (B1/B2: 16
//          on the model history; B5: min(16, minp + 13), which is 15 or
//          16, on the raw shard);
//   long   (B1/B2, kLong) the same target and runs to `lrun` (LEXT =
//          minp + 131), scored uncapped;
//   probe  (B2, and B5 with probe; kProbe) target row[t+1:] against the
//          ring at t, cap 15: the lazy-matching probe.  The literal at t is
//          not yet written, so slot j = 0 still holds C[t] and the source
//          walk, including its wrap at the write head, is the main family's.
// The cap enters the score before the arg-max: at cap 15 a slot with 16
// equal bytes ties with an earlier slot with 15.
//
// One block per (shard, chunk of TB positions), one thread per position.
// The block stages the slab C[t0 .. t0 + TB + W + pad) that its positions
// read (sources and targets both lie in C) in shared memory, and with it
// the slab's eight bit planes (plane b, word k: bit b of slab bytes 32k ..
// 32k + 31, by __ballot_sync).  The slots of a 32-byte word whose byte
// equals a value v are then the AND of the eight planes, each complemented
// where v's bit is 0: eight word operations for 32 slots, where a byte scan
// would compare every slot.  A thread scans its window word by word in ring
// order from slot 0 (the slab indices whose C index is at or past the next
// multiple of W first, then the rest from t), keeps as survivors the slots
// whose first two bytes match (the slots of c0 AND those of c1 one slab
// byte on), and extends only those, 16 bytes at once by word compares of
// funnel-shifted slab words.  One pass serves every family: the probe's
// first target byte c1 is the main family's second, and the long family
// shares the main family's target, survivors and 16-byte compare, going on
// 16 bytes a step only where all 16 match.  The slot just behind the head
// is a survivor on its first byte alone, since its second source byte is
// the glue's C[t].  A candidate that matches one byte and no more scores
// len 1, so the lowest such slot (the first first-byte match in ring
// order) is kept beside the survivors.  Because the scan runs in ring
// order, a later slot wins only if strictly longer: a family is done at
// its first candidate of the longest length its target allows, the long
// family also once a slot's cap W - x (which falls along the ring) no
// longer exceeds its best, and a warp stops when all its threads are.
//
// The glue: the main and probe families (at most 16 bytes) compare byte by
// byte within 16 bytes of the head.  The long family's runs reach LEXT
// bytes, so a survivor within LEXT of the head compares two linear runs by
// the same word compares: slab [i, head), then from tl (C[t], the oldest
// byte) on.  The slab's pad covers the long target's loads: a multiple of
// 32 past LEXT + 20 (32 without the long family).
//
// What bounds it: the filter's word operations, about 8 a value and word
// (three values with the probe), and the survivors' extensions, which
// depend on the data.  Simple by design: the TPU kernels' SWAR quarter-lane
// rolls and MXU one-hot and band-space layouts answer the TPU's matmul and
// roll costs and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exit_maps.cuh"

namespace {

constexpr int TB = 256;     // positions (threads) per block
constexpr int PROBE_CAP = 15;
constexpr int V1_RUN = 16;  // the main family's longest run
constexpr int V1_PAD = 32;  // slab bytes past TB + W without the long family

// slab bytes past TB + W: the targets and their 16-byte loads
__host__ __device__ constexpr int slab_pad(bool long_family, int lrun) {
  return long_family ? (lrun + 20 + 31) / 32 * 32 : V1_PAD;
}

// The eight bit planes of slab word k match byte value v: bit i of the
// result is slab[32k + i] == v.  nv[b] is 0 where bit b of v is 1, else ~0.
__device__ __forceinline__ uint32_t match_word(const uint32_t (&P)[8],
                                               const uint32_t (&nv)[8]) {
  uint32_t m = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < 8; ++b) m &= P[b] ^ nv[b];
  return m;
}

__device__ __forceinline__ void value_masks(uint32_t v, uint32_t (&nv)[8]) {
#pragma unroll
  for (int b = 0; b < 8; ++b) nv[b] = ((v >> b) & 1u) - 1u;
}

__device__ __forceinline__ void load_planes(const uint32_t* planes, int k,
                                            uint32_t (&P)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(planes + 8 * k);
  const uint4 b = *reinterpret_cast<const uint4*>(planes + 8 * k + 4);
  P[0] = a.x, P[1] = a.y, P[2] = a.z, P[3] = a.w;
  P[4] = b.x, P[5] = b.y, P[6] = b.z, P[7] = b.w;
}

// the 16 slab bytes from index i, as four little-endian words
__device__ __forceinline__ void load16(const uint32_t* s32, int i,
                                       uint32_t (&o)[4]) {
  const int a = i >> 2;
  const uint32_t sh = (uint32_t)(i & 3) * 8;
  uint32_t w[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) w[q] = s32[a + q];
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = __funnelshift_r(w[q], w[q + 1], sh);
}

// index of the first byte where two 16-byte strings differ (16: none)
__device__ __forceinline__ int diff16(const uint32_t (&a)[4],
                                      const uint32_t (&b)[4]) {
  const uint64_t lo = ((uint64_t)(a[1] ^ b[1]) << 32) | (a[0] ^ b[0]);
  const uint64_t hi = ((uint64_t)(a[3] ^ b[3]) << 32) | (a[2] ^ b[2]);
  return lo ? (__ffsll((long long)lo) - 1) >> 3
            : (hi ? 8 + ((__ffsll((long long)hi) - 1) >> 3) : 16);
}

// leading equal bytes of slab[a ..] and slab[b ..], at most n
__device__ __forceinline__ int common(const uint32_t* s32, int a, int b,
                                      int n) {
  for (int len = 0; len < n; len += 16) {
    uint32_t x[4], y[4];
    load16(s32, a + len, x);
    load16(s32, b + len, y);
    const int m = diff16(x, y);
    if (m < 16) return min(len + m, n);
  }
  return n;
}

// bits of slab word k whose index lies in [lo, hi)
__device__ __forceinline__ uint32_t range_bits(int k, int lo, int hi) {
  const int a = max(lo - 32 * k, 0), b = min(hi - 32 * k, 32);
  if (a >= b) return 0;
  return (b == 32 ? 0xFFFFFFFFu : (1u << b) - 1u) & (0xFFFFFFFFu << a);
}

// One family of one position: its target, its best score so far, the
// lowest slot matching one byte, and whether it is done.
struct Fam {
  uint32_t T[4];  // the target's 16 bytes
  int tgt;        // slab index of the target's first byte
  int lim;        // target bytes usable (<= 0: nothing to find)
  int cap;        // the family's cap
  int lmax;       // the longest length the target allows: min(lim, cap)
  int best;       // packed score
  int one;        // slab index of the first one-byte match in ring order
  bool done;
};

__device__ __forceinline__ void fam_init(Fam& f, const uint8_t* slab,
                                         int tgt, int lim, int cap, int W) {
  load16(reinterpret_cast<const uint32_t*>(slab), tgt, f.T);
  f.tgt = tgt;
  f.lim = lim;
  f.cap = cap;
  f.lmax = min(lim, cap);
  f.best = W - 1;  // len 0 at slot 0
  f.one = -1;
  f.done = lim <= 0;
}

// Extend the survivors `sv` of slab word k (bits in ring order) and take
// the first one-byte match `one` of the word; the family is done at a
// candidate of length lmax.
__device__ __forceinline__ void fam_word(Fam& f, const uint8_t* slab, int k,
                                         uint32_t one, uint32_t sv, int tl,
                                         int head, int t0, int W, int wbits) {
  if (f.done) return;
  if (f.one < 0 && one) {
    f.one = 32 * k + __ffs(one) - 1;
    if (f.lmax <= 1) {  // no survivor can beat it
      f.done = true;
      return;
    }
  }
  if (f.lmax <= 1) return;
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(slab);
  while (sv) {
    const int i = 32 * k + __ffs(sv) - 1;
    sv &= sv - 1;
    const int x = (t0 + i) & (W - 1);
    const int capx = W - x;
    const int l = min(f.lim, capx);
    int len;
    if (head - i >= l) {  // no glue within l bytes: word compares
      uint32_t s[4];
      load16(s32, i, s);
      len = min(diff16(s, f.T), l);
    } else {  // the glue: past the head, the oldest bytes
      len = 0;
      int src = i;
      while (len < l && slab[src] == slab[f.tgt + len]) {
        ++len;
        if (++src == head) src = tl;
      }
    }
    const int eff = min(len, f.cap);
    const int sc = (eff << wbits) + capx - 1;
    f.best = sc > f.best ? sc : f.best;
    if (eff == f.lmax) {
      f.done = true;
      return;
    }
  }
}

// The long family of one position: the main family's target (Fam::T,
// Fam::tgt) and first one-byte match (Fam::one), runs to lrun, uncapped.
struct Long {
  int lim;   // target bytes usable: min(npos - t, lrun)
  int best;  // packed score
  bool done;
};

// The main family `f` (cap 16) and the long family `g` over slab word k at
// once: one 16-byte compare a survivor serves both, and only a survivor
// whose 16 bytes all match goes on, 16 bytes a step.  Slots come in ring
// order, so their caps W - x fall: once a slot's min(lim, W - x) does not
// exceed the long family's best, no later slot beats either family.  A
// done long family implies a done main family.
__device__ __forceinline__ void ext_word(Fam& f, Long& g, const uint8_t* slab,
                                         int k, uint32_t one, uint32_t sv,
                                         int tl, int head, int t0, int W,
                                         int wbits) {
  if (g.done) return;
  if (f.one < 0 && one) {
    f.one = 32 * k + __ffs(one) - 1;
    if (f.lmax <= 1) {  // one target byte: no survivor can beat it
      f.done = g.done = true;
      return;
    }
  }
  if (f.lmax <= 1) return;
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(slab);
  while (sv) {
    const int i = 32 * k + __ffs(sv) - 1;
    sv &= sv - 1;
    const int capx = W - ((t0 + i) & (W - 1));
    const int l = min(g.lim, capx);
    if (l <= (g.best >> wbits)) {
      f.done = g.done = true;
      return;
    }
    int len;
    const int d = head - i;  // source bytes before the head
    if (d >= l) {
      uint32_t s[4];
      load16(s32, i, s);
      len = diff16(s, f.T);
      if (len == 16 && l > 16)
        len += common(s32, i + 16, f.tgt + 16, l - 16);
      len = min(len, l);
    } else {  // the glue: slab [i, head), then the oldest bytes from tl
      len = common(s32, i, f.tgt, d);
      if (len == d) len += common(s32, tl, f.tgt + d, l - d);
    }
    const int sc = (len << wbits) + capx - 1;
    g.best = sc > g.best ? sc : g.best;
    if (!f.done) {
      const int eff = min(min(len, f.lim), f.cap);
      const int sm = (eff << wbits) + capx - 1;
      f.best = sm > f.best ? sm : f.best;
      f.done = eff == f.lmax;
    }
    if (len == g.lim) {
      f.done = g.done = true;
      return;
    }
  }
}

// a family's packed score with its first one-byte match (slab index `one`,
// -1: none) taken in
__device__ __forceinline__ int with_one(int best, int one, int t0, int W,
                                        int wbits) {
  if (one < 0) return best;
  const int s1 = (1 << wbits) + (W - 1 - ((t0 + one) & (W - 1)));
  return s1 > best ? s1 : best;
}

template <bool kProbe, bool kLong>
__global__ void __launch_bounds__(TB)
tables_kernel(const uint8_t* __restrict__ row0,
              const int32_t* __restrict__ npos,
              const uint8_t* __restrict__ dict,
              int32_t* __restrict__ len_m, int32_t* __restrict__ idx_m,
              int32_t* __restrict__ len_l, int32_t* __restrict__ idx_l,
              int32_t* __restrict__ len_p, int32_t* __restrict__ idx_p,
              int MP, int wbits, int cap_main, int lrun) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W = 1 << wbits;
  const int slab_len = TB + W + slab_pad(kLong, lrun);  // a multiple of 32
  uint8_t* slab = smem;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + slab_len);
  const ShardBlock sb = shard_block((MP + TB - 1) / TB);
  const int s = sb.s;
  const int t0 = sb.b * TB;
  const uint8_t* row = row0 + (size_t)s * MP;
  const int lane = threadIdx.x & 31;
  // stage the slab; each warp's 32 bytes also give one word of each plane
  for (int i = threadIdx.x; i < slab_len; i += TB) {
    const int c = t0 + i;  // index into C = dict || row
    uint32_t v = 0;
    if (c < W) {
      v = dict[c];
    } else if (c - W < MP) {
      v = row[c - W];
    }
    slab[i] = (uint8_t)v;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint32_t p = __ballot_sync(0xFFFFFFFFu, (v >> b) & 1u);
      if (lane == b) planes[8 * (i >> 5) + b] = p;
    }
  }
  __syncthreads();

  const int tl = threadIdx.x;
  const int t = t0 + tl;
  const int head = tl + W;  // slab index of the target's first byte
  const int left = t < MP ? npos[s] - t : 0;  // target bytes before npos
  Fam fm, fp;
  fam_init(fm, slab, head, min(left, V1_RUN), cap_main, W);
  fam_init(fp, slab, head + 1, kProbe ? min(left - 1, PROBE_CAP) : 0,
           PROBE_CAP, W);
  Long gl;
  gl.lim = kLong ? min(left, lrun) : 0;
  gl.best = W - 1;
  gl.done = gl.lim <= 0;
  uint32_t nv0[8], nv1[8], nv2[8];
  value_masks(slab[head], nv0);
  value_masks(slab[head + 1], nv1);
  value_masks(slab[head + 2], nv2);

  // ring order: slot 0 sits at slab index iw (C index a multiple of W), so
  // segment A = [iw, tl + W) holds slots 0 .. tau - 1 and segment B =
  // [tl, iw) slots tau .. W - 1; iw is the same for every thread of the
  // block (t0 and W are multiples of TB), and a thread whose t is a
  // multiple of W has an empty segment A
  const int iw = W - (t0 & (W - 1));
  const int w = threadIdx.x >> 5;
  const int seg_k[2][2] = {{iw >> 5, w + (W >> 5)}, {w, (iw - 1) >> 5}};
  const int seg_r[2][2] = {{iw, tl + W}, {tl, iw}};
  const int glue_k = (head - 1) >> 5;
  const uint32_t glue_bit = 1u << ((head - 1) & 31);
  for (int g = 0; g < 2; ++g) {
    uint32_t P[8], Pn[8];
    int k = seg_k[g][0];
    load_planes(planes, k, P);
    uint32_t m1 = match_word(P, nv1), m2 = kProbe ? match_word(P, nv2) : 0;
    for (; k <= seg_k[g][1]; ++k) {
      if (!__any_sync(0xFFFFFFFFu, !(fm.done && (!kProbe || fp.done) &&
                                     (!kLong || gl.done))))
        break;
      load_planes(planes, k + 1, Pn);
      const uint32_t m0 = match_word(P, nv0);
      const uint32_t m1n = match_word(Pn, nv1);
      const uint32_t win = range_bits(k, seg_r[g][0], seg_r[g][1]);
      const uint32_t glue = k == glue_k ? glue_bit : 0u;
      // survivors: first two bytes equal (the glue slot: its first byte)
      uint32_t sv = m0 & __funnelshift_r(m1, m1n, 1);
      sv = ((sv & ~glue) | (m0 & glue)) & win;
      if (kLong)
        ext_word(fm, gl, slab, k, m0 & win, sv, tl, head, t0, W, wbits);
      else
        fam_word(fm, slab, k, m0 & win, sv, tl, head, t0, W, wbits);
      if (kProbe) {
        const uint32_t m2n = match_word(Pn, nv2);
        uint32_t pv = m1 & __funnelshift_r(m2, m2n, 1);
        pv = ((pv & ~glue) | (m1 & glue)) & win;
        fam_word(fp, slab, k, m1 & win, pv, tl, head, t0, W, wbits);
        m2 = m2n;
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) P[b] = Pn[b];
      m1 = m1n;
    }
  }
  if (t >= MP) return;
  const size_t o = (size_t)s * MP + t;
  const int bm = with_one(fm.best, fm.one, t0, W, wbits);
  len_m[o] = bm >> wbits;
  idx_m[o] = (W - 1) - (bm & (W - 1));
  if (kLong) {
    const int bl = with_one(gl.best, fm.one, t0, W, wbits);
    len_l[o] = bl >> wbits;
    idx_l[o] = (W - 1) - (bl & (W - 1));
  }
  if (kProbe) {
    const int bp = with_one(fp.best, fp.one, t0, W, wbits);
    len_p[o] = bp >> wbits;
    idx_p[o] = (W - 1) - (bp & (W - 1));
  }
}

template <bool kProbe, bool kLong>
int launch(const void* row, const void* npos, const void* dict, void* len_m,
           void* idx_m, void* len_l, void* idx_l, void* len_p, void* idx_p,
           int S, int MP, int wbits, int cap, int lrun, void* stream) {
  const int slab_len = TB + (1 << wbits) + slab_pad(kLong, lrun);
  const size_t smem = (size_t)slab_len + slab_len;  // bytes, bit planes
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tables_kernel<kProbe, kLong>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_shards(tables_kernel<kProbe, kLong>, S,
                            (MP + TB - 1) / TB, TB, smem,
                            (cudaStream_t)stream, row, npos, dict, len_m,
                            idx_m, len_l, idx_l, len_p, idx_p, MP, wbits, cap,
                            lrun);
}

}  // namespace

// B1: (len16, idx16, lenx, idxx) on the model history, runs to LEXT.
extern "C" int tpt_ext_tables(const void* dh, const void* npos,
                              const void* dict, void* len16, void* idx16,
                              void* lenx, void* idxx, int S, int MP,
                              int wbits, int lext, void* stream) {
  return launch<false, true>(dh, npos, dict, len16, idx16, lenx, idxx,
                             nullptr, nullptr, S, MP, wbits, 16, lext, stream);
}

// B2: B1's four planes plus the probe family (plen, pidx).
extern "C" int tpt_ext_tables_probe(const void* dh, const void* npos,
                                    const void* dict, void* len16,
                                    void* idx16, void* lenx, void* idxx,
                                    void* plen, void* pidx, int S, int MP,
                                    int wbits, int lext, void* stream) {
  return launch<true, true>(dh, npos, dict, len16, idx16, lenx, idxx, plen,
                            pidx, S, MP, wbits, 16, lext, stream);
}

// B5: the v1 tables (flen, fidx) at cap 15 or 16 on the raw shard, runs to
// 16, and with probe != 0 the probe family (plen, pidx).
extern "C" int tpt_v1_tables(const void* data, const void* npos,
                             const void* dict, void* flen, void* fidx,
                             void* plen, void* pidx, int S, int MP, int wbits,
                             int cap, int probe, void* stream) {
  if (probe)
    return launch<true, false>(data, npos, dict, flen, fidx, nullptr, nullptr,
                               plen, pidx, S, MP, wbits, cap, V1_RUN, stream);
  return launch<false, false>(data, npos, dict, flen, fidx, nullptr, nullptr,
                              nullptr, nullptr, S, MP, wbits, cap, V1_RUN,
                              stream);
}
