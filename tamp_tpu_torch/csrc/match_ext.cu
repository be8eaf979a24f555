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
//   long   (kLong) the same runs scored at cap `lrun` (B1/B2: LEXT);
//   probe  (kProbe) target row[t+1:] against the ring at t, cap 15: the
//          lazy-matching probe.  The literal at t is not yet written, so
//          slot j = 0 still holds C[t] and the source walk, including its
//          wrap at the write head, is the main family's.
// The cap enters the score before the arg-max: at cap 15 a slot with 16
// equal bytes ties with an earlier slot with 15.
//
// What bounds it on this card: the W candidates of each position are
// compared byte by byte (S * npos * W first-byte compares per family, plus
// the extensions of the candidates whose first byte matches), an
// integer-ALU and shared-memory load rate, not a memory rate: the kernel
// reads the model bytes once and writes 2 to 6 int32 planes.
//
// Design: one block per (shard, chunk of TB positions), one thread per
// position.  The block stages the slab C[t0 .. t0 + TB + W + lrun) that its
// positions read (sources and targets both lie in C) in shared memory, then
// each thread walks all W candidates in slot order, once per target.  A
// candidate whose first byte differs scores len 0, which never beats the
// len-0 score of slot 0 (W - 1), so only first-byte matches are extended.
// The glue is a source wrap: when the source index reaches the write head
// (C index t + W) it continues at C[t]; the linear-buffer cap keeps that
// wrap from happening where the format forbids it.  The probe is a
// compile-time switch, so the tables without it run the code they ran
// before it existed.  Simple by design: the TPU kernels' MXU one-hot and
// band-space layouts answer the TPU's matmul and roll costs and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 256;     // positions (threads) per block
constexpr int PROBE_CAP = 15;

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

template <bool kLong, bool kProbe>
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
    scan<kLong>(slab, tl, head, head, tau, W, wbits,
                left < lrun ? left : lrun, cap_main, best_m, best_l);
  }
  const size_t o = (size_t)s * MP + t;
  len_m[o] = best_m >> wbits;
  idx_m[o] = (W - 1) - (best_m & (W - 1));
  if (kLong) {
    len_l[o] = best_l >> wbits;
    idx_l[o] = (W - 1) - (best_l & (W - 1));
  }
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

template <bool kLong, bool kProbe>
int launch(const void* row, const void* npos, const void* dict, void* len_m,
           void* idx_m, void* len_l, void* idx_l, void* len_p, void* idx_p,
           int S, int MP, int wbits, int lrun, int cap_main, void* stream) {
  const int W = 1 << wbits;
  const size_t smem = (size_t)TB + W + lrun;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tables_kernel<kLong, kProbe>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (S == 0 || MP == 0) return 0;
  dim3 grid((MP + TB - 1) / TB, S);
  tables_kernel<kLong, kProbe><<<grid, TB, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)row, (const int32_t*)npos, (const uint8_t*)dict,
      (int32_t*)len_m, (int32_t*)idx_m, (int32_t*)len_l, (int32_t*)idx_l,
      (int32_t*)len_p, (int32_t*)idx_p, MP, wbits, lrun, cap_main);
  return (int)cudaGetLastError();
}

}  // namespace

// B1: (len16, idx16, lenx, idxx) on the model history, runs to LEXT.
extern "C" int tpt_ext_tables(const void* dh, const void* npos,
                              const void* dict, void* len16, void* idx16,
                              void* lenx, void* idxx, int S, int MP,
                              int wbits, int lext, void* stream) {
  return launch<true, false>(dh, npos, dict, len16, idx16, lenx, idxx,
                             nullptr, nullptr, S, MP, wbits, lext, 16,
                             stream);
}

// B2: B1's four planes plus the probe family (plen, pidx).
extern "C" int tpt_ext_tables_probe(const void* dh, const void* npos,
                                    const void* dict, void* len16,
                                    void* idx16, void* lenx, void* idxx,
                                    void* plen, void* pidx, int S, int MP,
                                    int wbits, int lext, void* stream) {
  return launch<true, true>(dh, npos, dict, len16, idx16, lenx, idxx, plen,
                            pidx, S, MP, wbits, lext, 16, stream);
}

// B5: the v1 tables (flen, fidx) at cap 15 or 16 on the raw shard, runs to
// 16, and with probe != 0 the probe family (plen, pidx).
extern "C" int tpt_v1_tables(const void* data, const void* npos,
                             const void* dict, void* flen, void* fidx,
                             void* plen, void* pidx, int S, int MP, int wbits,
                             int cap, int probe, void* stream) {
  if (probe)
    return launch<false, true>(data, npos, dict, flen, fidx, nullptr,
                               nullptr, plen, pidx, S, MP, wbits, 16, cap,
                               stream);
  return launch<false, false>(data, npos, dict, flen, fidx, nullptr, nullptr,
                              nullptr, nullptr, S, MP, wbits, 16, cap,
                              stream);
}
