// Kernels B1, B2 and B5: match tables of the window model, one source.
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
//   main   target row[t:], runs to `lrun`, scored at cap `cap_main`
//          (B1/B2: 16 on the model history; B5: min(16, minp + 13), which
//          is 15 or 16, on the raw shard);
//   long   (B1/B2) the same runs scored at cap `lrun` (LEXT);
//   probe  (B2, and B5 with probe) target row[t+1:] against the ring at t,
//          cap 15: the lazy-matching probe.  The literal at t is not yet
//          written, so slot j = 0 still holds C[t] and the source walk,
//          including its wrap at the write head, is the main family's.
// The cap enters the score before the arg-max: at cap 15 a slot with 16
// equal bytes ties with an earlier slot with 15.
//
// B1 and B2 (tables_kernel): one block per (shard, chunk of TB positions),
// one thread per position.  The block stages the slab C[t0 .. t0 + TB + W +
// lrun) that its positions read (sources and targets both lie in C) in
// shared memory, then each thread walks all W candidates in slot order,
// once per target, byte by byte.  A candidate whose first byte differs
// scores len 0, which never beats the len-0 score of slot 0 (W - 1), so
// only first-byte matches are extended.  The glue is a source wrap: when
// the source index reaches the write head (C index t + W) it continues at
// C[t]; the linear-buffer cap keeps that wrap from happening where the
// format forbids it.  What bounds it: the W byte compares of each position
// and the extension of every first-byte match, an integer-ALU and
// shared-memory load rate, not a memory rate.
//
// B5 (v1_tables_kernel) filters the candidates 32 slots a word before it
// extends any.  What bounds the first port's scan was the candidates, not
// bytes: on text about one slot in 27 matches the first byte, and a warp
// extended a first-byte match at nearly every slot.  Here the block stages
// the same slab, and with it the slab's eight bit planes (plane b, word k:
// bit b of slab bytes 32k .. 32k + 31, by __ballot_sync).  The slots of a
// 32-byte word whose byte equals a value v are then the AND of the eight
// planes, each complemented where v's bit is 0: eight word operations for
// 32 slots.  A thread scans its window word by word in ring order from
// slot 0 (the slab indices whose C index is at or past the next multiple
// of W first, then the rest from t), keeps as survivors the slots whose
// first two bytes match (the slots of c0 AND those of c1 one slab byte on),
// and extends only those, 16 bytes at once by word compares of funnel-
// shifted slab words (byte by byte where the glue can occur, within 16
// bytes of the head).  One pass serves both families: the probe's first
// target byte c1 is the main family's second.  The slot just behind the
// head is a survivor on its first byte alone, since its second source byte
// is the glue's C[t].  A candidate that matches one byte and no more scores
// len 1, so the lowest such slot (the first first-byte match in ring order)
// is kept beside the survivors.  Because the scan runs in ring order, a
// family is done at its first candidate of the longest length its target
// allows, and a warp stops when all its threads are.  What bounds it now:
// the filter's word operations, about 8 a value and word (three values with
// the probe), and the survivors' extensions, which depend on the data.
// Simple by design: the TPU kernels' MXU one-hot and band-space layouts
// answer the TPU's matmul and roll costs and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 256;     // positions (threads) per block
constexpr int PROBE_CAP = 15;
constexpr int V1_RUN = 16;  // B5's longest run (the 16-byte look-ahead)
constexpr int V1_PAD = 32;  // slab bytes past TB + W: targets and loads

// Best packed score over the W slots for the target at slab index `tgt`
// with `lim` target bytes usable; `cap_fam` is the family cap.  With kTwo,
// the same runs are also scored uncapped into `best2`.
template <bool kTwo>
__device__ __forceinline__ void scan(const uint8_t* slab, int tl, int head,
                                     int tgt, int tau, int W, int wbits,
                                     int lim, int cap_fam, int& best,
                                     int& best2) {
  const uint8_t c0 = slab[tgt];
  for (int j = 0; j < W; ++j) {
    if (slab[tl + j] != c0) continue;
    const int x = (tau + j) & (W - 1);
    const int cap = W - x;
    const int l = lim < cap ? lim : cap;
    int k = 1;
    int src = tl + j + 1;
    if (src == head) src = tl;  // glue: past the head, the oldest bytes
    while (k < l && slab[src] == slab[tgt + k]) {
      ++k;
      if (++src == head) src = tl;
    }
    const int s = ((k < cap_fam ? k : cap_fam) << wbits) + cap - 1;
    best = s > best ? s : best;
    if (kTwo) {
      const int s2 = (k << wbits) + cap - 1;
      best2 = s2 > best2 ? s2 : best2;
    }
  }
}

template <bool kProbe>
__global__ void __launch_bounds__(TB)
tables_kernel(const uint8_t* __restrict__ row0,
              const int32_t* __restrict__ npos,
              const uint8_t* __restrict__ dict,
              int32_t* __restrict__ len_m, int32_t* __restrict__ idx_m,
              int32_t* __restrict__ len_l, int32_t* __restrict__ idx_l,
              int32_t* __restrict__ len_p, int32_t* __restrict__ idx_p,
              int MP, int wbits, int lrun, int cap_main) {
  extern __shared__ uint8_t slab[];
  const int W = 1 << wbits;
  const int s = blockIdx.y;
  const int t0 = blockIdx.x * TB;
  const int slab_len = TB + W + lrun;
  const uint8_t* row = row0 + (size_t)s * MP;
  for (int i = threadIdx.x; i < slab_len; i += TB) {
    const int c = t0 + i;  // index into C = dict || row
    uint8_t v = 0;
    if (c < W) {
      v = dict[c];
    } else if (c - W < MP) {
      v = row[c - W];
    }
    slab[i] = v;
  }
  __syncthreads();

  const int tl = threadIdx.x;
  const int t = t0 + tl;
  if (t >= MP) return;
  const int tau = t & (W - 1);
  const int head = tl + W;  // slab index of the target's first byte
  int best_m = W - 1;       // len 0 at slot 0
  int best_l = W - 1;
  const int left = npos[s] - t;  // target bytes before npos
  if (left > 0) {
    scan<true>(slab, tl, head, head, tau, W, wbits,
                left < lrun ? left : lrun, cap_main, best_m, best_l);
  }
  const size_t o = (size_t)s * MP + t;
  len_m[o] = best_m >> wbits;
  idx_m[o] = (W - 1) - (best_m & (W - 1));
  len_l[o] = best_l >> wbits;
  idx_l[o] = (W - 1) - (best_l & (W - 1));
  if (kProbe) {
    int best_p = W - 1, unused = 0;
    if (left > 1) {
      scan<false>(slab, tl, head, head + 1, tau, W, wbits,
                  left - 1 < PROBE_CAP ? left - 1 : PROBE_CAP, PROBE_CAP,
                  best_p, unused);
    }
    len_p[o] = best_p >> wbits;
    idx_p[o] = (W - 1) - (best_p & (W - 1));
  }
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
      const uint64_t lo = ((uint64_t)(s[1] ^ f.T[1]) << 32) | (s[0] ^ f.T[0]);
      const uint64_t hi = ((uint64_t)(s[3] ^ f.T[3]) << 32) | (s[2] ^ f.T[2]);
      len = lo ? (__ffsll((long long)lo) - 1) >> 3
               : (hi ? 8 + ((__ffsll((long long)hi) - 1) >> 3) : 16);
      len = min(len, l);
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

__device__ __forceinline__ int fam_score(const Fam& f, int t0, int W,
                                         int wbits) {
  if (f.one < 0) return f.best;
  const int s1 = (1 << wbits) + (W - 1 - ((t0 + f.one) & (W - 1)));
  return s1 > f.best ? s1 : f.best;
}

template <bool kProbe>
__global__ void __launch_bounds__(TB)
v1_tables_kernel(const uint8_t* __restrict__ row0,
                 const int32_t* __restrict__ npos,
                 const uint8_t* __restrict__ dict,
                 int32_t* __restrict__ len_m, int32_t* __restrict__ idx_m,
                 int32_t* __restrict__ len_p, int32_t* __restrict__ idx_p,
                 int MP, int wbits, int cap_main) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W = 1 << wbits;
  const int slab_len = TB + W + V1_PAD;  // a multiple of 32
  uint8_t* slab = smem;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + slab_len);
  const int s = blockIdx.y;
  const int t0 = blockIdx.x * TB;
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
      if (!__any_sync(0xFFFFFFFFu, !(fm.done && (!kProbe || fp.done))))
        break;
      load_planes(planes, k + 1, Pn);
      const uint32_t m0 = match_word(P, nv0);
      const uint32_t m1n = match_word(Pn, nv1);
      const uint32_t win = range_bits(k, seg_r[g][0], seg_r[g][1]);
      const uint32_t glue = k == glue_k ? glue_bit : 0u;
      // survivors: first two bytes equal (the glue slot: its first byte)
      uint32_t sv = m0 & __funnelshift_r(m1, m1n, 1);
      sv = ((sv & ~glue) | (m0 & glue)) & win;
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
  const int bm = fam_score(fm, t0, W, wbits);
  len_m[o] = bm >> wbits;
  idx_m[o] = (W - 1) - (bm & (W - 1));
  if (kProbe) {
    const int bp = fam_score(fp, t0, W, wbits);
    len_p[o] = bp >> wbits;
    idx_p[o] = (W - 1) - (bp & (W - 1));
  }
}

template <bool kProbe>
int launch_ext(const void* row, const void* npos, const void* dict,
               void* len_m, void* idx_m, void* len_l, void* idx_l,
               void* len_p, void* idx_p, int S, int MP, int wbits, int lrun,
               void* stream) {
  const int W = 1 << wbits;
  const size_t smem = (size_t)TB + W + lrun;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tables_kernel<kProbe>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (S == 0 || MP == 0) return 0;
  dim3 grid((MP + TB - 1) / TB, S);
  tables_kernel<kProbe><<<grid, TB, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)row, (const int32_t*)npos, (const uint8_t*)dict,
      (int32_t*)len_m, (int32_t*)idx_m, (int32_t*)len_l, (int32_t*)idx_l,
      (int32_t*)len_p, (int32_t*)idx_p, MP, wbits, lrun, 16);
  return (int)cudaGetLastError();
}

template <bool kProbe>
int launch_v1(const void* row, const void* npos, const void* dict,
              void* len_m, void* idx_m, void* len_p, void* idx_p, int S,
              int MP, int wbits, int cap, void* stream) {
  const int W = 1 << wbits;
  const int slab_len = TB + W + V1_PAD;
  const size_t smem = (size_t)slab_len + slab_len;  // bytes, bit planes
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        v1_tables_kernel<kProbe>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (S == 0 || MP == 0) return 0;
  dim3 grid((MP + TB - 1) / TB, S);
  v1_tables_kernel<kProbe><<<grid, TB, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)row, (const int32_t*)npos, (const uint8_t*)dict,
      (int32_t*)len_m, (int32_t*)idx_m, (int32_t*)len_p, (int32_t*)idx_p, MP,
      wbits, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// B1: (len16, idx16, lenx, idxx) on the model history, runs to LEXT.
extern "C" int tpt_ext_tables(const void* dh, const void* npos,
                              const void* dict, void* len16, void* idx16,
                              void* lenx, void* idxx, int S, int MP,
                              int wbits, int lext, void* stream) {
  return launch_ext<false>(dh, npos, dict, len16, idx16, lenx, idxx, nullptr,
                       nullptr, S, MP, wbits, lext, stream);
}

// B2: B1's four planes plus the probe family (plen, pidx).
extern "C" int tpt_ext_tables_probe(const void* dh, const void* npos,
                                    const void* dict, void* len16,
                                    void* idx16, void* lenx, void* idxx,
                                    void* plen, void* pidx, int S, int MP,
                                    int wbits, int lext, void* stream) {
  return launch_ext<true>(dh, npos, dict, len16, idx16, lenx, idxx, plen, pidx,
                      S, MP, wbits, lext, stream);
}

// B5: the v1 tables (flen, fidx) at cap 15 or 16 on the raw shard, runs to
// 16, and with probe != 0 the probe family (plen, pidx).
extern "C" int tpt_v1_tables(const void* data, const void* npos,
                             const void* dict, void* flen, void* fidx,
                             void* plen, void* pidx, int S, int MP, int wbits,
                             int cap, int probe, void* stream) {
  if (probe)
    return launch_v1<true>(data, npos, dict, flen, fidx, plen, pidx, S, MP,
                           wbits, cap, stream);
  return launch_v1<false>(data, npos, dict, flen, fidx, nullptr, nullptr, S,
                          MP, wbits, cap, stream);
}
