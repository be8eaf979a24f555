// Kernel B1: extended match tables for the planned extended encode.
//
// Replaces the TPU kernel tamp_tpu/ops/match_ext_pallas.py::_kernel_swar
// (via ext_tables_pallas).  For every model position t of every shard it
// finds, over all W ring slots, the longest linear-buffer match of dh[t:]
// (runs stop at npos) against the window model C = dict || dh, at two caps:
// 16 (len16, idx16) and LEXT = minp + 131 (lenx, idxx).  Ties go to the
// lowest ring slot: the score is len * W + (W - 1 - slot).  A candidate at
// slot x is capped by the linear buffer at W - x; a candidate just behind
// the write head (delta = W - j bytes from it) continues past the head with
// the oldest ring bytes (the glue diagonals of engine/search_np.py).
//
// What bounds it on this card: the W candidates of each position are
// compared byte by byte (S * MP * W compares, plus the extensions of the
// candidates whose first byte matches), an integer-ALU and shared-memory
// load rate, not a memory rate: the kernel reads the S * MP model bytes
// once and writes four int32 planes.
//
// Design: one block per (shard, chunk of TB positions), one thread per
// position.  The block stages the slab C[t0 .. t0 + TB + W + LEXT) that its
// positions read (sources and targets both lie in C) in shared memory, then
// each thread walks all W candidates in slot order.  A candidate whose
// first byte differs scores len 0, which never beats the len-0 score of
// slot 0 (W - 1), so only first-byte matches are extended.  The glue is a
// source wrap: when the source index reaches the write head (C index
// t + W) it continues at C[t]; the linear-buffer cap keeps that wrap from
// happening where the format forbids it.  Simple by design: the TPU kernel's
// band-space SWAR layout answers the TPU's roll costs and is not carried
// over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 256;  // positions (threads) per block

__global__ void __launch_bounds__(TB)
ext_tables_kernel(const uint8_t* __restrict__ dh,
                  const int32_t* __restrict__ npos,
                  const uint8_t* __restrict__ dict,
                  int32_t* __restrict__ len16, int32_t* __restrict__ idx16,
                  int32_t* __restrict__ lenx, int32_t* __restrict__ idxx,
                  int MP, int wbits, int lext) {
  extern __shared__ uint8_t slab[];
  const int W = 1 << wbits;
  const int s = blockIdx.y;
  const int t0 = blockIdx.x * TB;
  const int slab_len = TB + W + lext;
  const uint8_t* row = dh + (size_t)s * MP;
  for (int i = threadIdx.x; i < slab_len; i += TB) {
    const int c = t0 + i;  // index into C = dict || dh
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
  int best16 = W - 1;       // len 0 at slot 0
  int bestx = W - 1;
  const int left = npos[s] - t;  // target bytes before npos
  if (left > 0) {
    const int lim_t = left < lext ? left : lext;
    const uint8_t c0 = slab[head];
    for (int j = 0; j < W; ++j) {
      if (slab[tl + j] != c0) continue;
      const int x = (tau + j) & (W - 1);
      const int cap = W - x;
      const int lim = lim_t < cap ? lim_t : cap;
      int k = 1;
      int src = tl + j + 1;
      if (src == head) src = tl;  // glue: past the head, the oldest bytes
      while (k < lim && slab[src] == slab[head + k]) {
        ++k;
        if (++src == head) src = tl;
      }
      const int s16 = ((k < 16 ? k : 16) << wbits) + cap - 1;
      const int sx = (k << wbits) + cap - 1;
      best16 = s16 > best16 ? s16 : best16;
      bestx = sx > bestx ? sx : bestx;
    }
  }
  const size_t o = (size_t)s * MP + t;
  len16[o] = best16 >> wbits;
  idx16[o] = (W - 1) - (best16 & (W - 1));
  lenx[o] = bestx >> wbits;
  idxx[o] = (W - 1) - (bestx & (W - 1));
}

}  // namespace

extern "C" int tpt_ext_tables(const void* dh, const void* npos,
                              const void* dict, void* len16, void* idx16,
                              void* lenx, void* idxx, int S, int MP,
                              int wbits, int lext, void* stream) {
  const int W = 1 << wbits;
  const size_t smem = (size_t)TB + W + lext;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ext_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((MP + TB - 1) / TB, S);
  ext_tables_kernel<<<grid, TB, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)dh, (const int32_t*)npos, (const uint8_t*)dict,
      (int32_t*)len16, (int32_t*)idx16, (int32_t*)lenx, (int32_t*)idxx, MP,
      wbits, lext);
  return (int)cudaGetLastError();
}
