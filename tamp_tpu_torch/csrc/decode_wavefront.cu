// Kernels B8 (token-boundary chase) and X1 (window-write truncation
// deficits) of the wavefront decode modes.
//
// B8 replaces the TPU kernel tamp_tpu/ops/token_chase_pallas.py::_kernel
// (via token_table_chase).  Per shard, the orbit of the per-bit jump array
// nxt (S, NBP) from bit 0 is the list of real token starts: c = 0, then
// c = nxt[c] while c < NBP.  A bit whose nxt is NBP is an incomplete
// trailing token: it is dropped and the chase ends there.  Output: the
// starts in order, compact, in starts (S, T_max) (the wrapper zero-fills the
// rest), and their count T (S,).  A hop that does not advance ends the
// chase as well (the parse never makes one; the guard keeps malformed
// input from spinning).
//
// What bounds B8 on this card: the dependence chain of the chase (each hop
// is one load whose address is the previous load's value), not bytes: one
// thread chases a shard, so the kernel uses S SMs.
//
// Design: one block per shard.  Warp 0's lane 0 chases; warps 1..7 stage
// the next 16 KiB tile of nxt into the other half of a double buffer in
// shared memory while the chaser walks the current one, so each hop is a
// shared-memory load.  Starts go straight to the output row.  The TPU
// kernel's per-tile SMEM rows and the scatter that compacts them answer the
// TPU's SMEM tiles and are not carried over: the chaser appends to one
// compact row.
//
// X1 replaces the serial lax.while_loop `tr_body` of
// tamp_tpu/ops/decode_wavefront.py::_wavefront_finish.  Over the truncating
// tokens of a shard (RLE and extended matches, compacted by the caller into
// seg_c, s_c, w_c: segment id, segment-relative untruncated write offset,
// untruncated write count), in order:
//   D = 0 where the segment changes; room = W - ((s - D) mod W);
//   d = max(0, w - room); D += d; defs_c[i] = d.
// What bounds X1: the chain through D, a few integer operations per token.
// Design: one thread per shard, reading three sequential int32 rows, so no
// load depends on the chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH_THREADS = 256;
constexpr int CH_TILE = 4096;  // nxt words per staged tile

__global__ void __launch_bounds__(CH_THREADS)
token_chase_kernel(const int32_t* __restrict__ nxt,
                   int32_t* __restrict__ starts, int32_t* __restrict__ T,
                   int NBP, int T_max) {
  __shared__ int32_t tiles[2][CH_TILE];
  const int s = blockIdx.x;
  const int32_t* row = nxt + (size_t)s * NBP;
  int32_t* srow = starts + (size_t)s * T_max;
  const int n_tiles = (NBP + CH_TILE - 1) / CH_TILE;

  for (int i = threadIdx.x; i < CH_TILE && i < NBP; i += CH_THREADS)
    tiles[0][i] = row[i];
  __syncthreads();

  int c = 0, k = 0;  // chaser state (meaningful in thread 0 only)
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * CH_TILE;
      int32_t* dst = tiles[cur ^ 1];
      for (int i = threadIdx.x - 32; i < CH_TILE && base + i < NBP;
           i += CH_THREADS - 32)
        dst[i] = row[base + i];
    }
    if (threadIdx.x == 0) {
      const int base = tile * CH_TILE;
      const int end = min(base + CH_TILE, NBP);
      const int32_t* src = tiles[cur];
      while (c < end) {
        const int n = src[c - base];
        if (n >= NBP || n <= c) {  // incomplete trailing token: drop, stop
          c = NBP;
          break;
        }
        if (k < T_max) srow[k] = c;
        ++k;
        c = n;
      }
    }
    // barrier (the next tile is staged) and the chaser's verdict in one
    if (__syncthreads_or(threadIdx.x == 0 && c >= NBP)) break;
  }
  if (threadIdx.x == 0) T[s] = min(k, T_max);
}

__global__ void trunc_deficits_kernel(const int32_t* __restrict__ seg_c,
                                      const int32_t* __restrict__ s_c,
                                      const int32_t* __restrict__ w_c,
                                      const int32_t* __restrict__ n_tr,
                                      int32_t* __restrict__ defs_c, int S,
                                      int T_max, int W) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t off = (size_t)s * T_max;
  const int n = n_tr[s];
  int D = 0, cur = 0;
  for (int i = 0; i < n; ++i) {
    const int sg = seg_c[off + i];
    if (sg != cur) D = 0;
    const int room = W - ((s_c[off + i] - D) & (W - 1));
    const int d = max(0, w_c[off + i] - room);
    D += d;
    cur = sg;
    defs_c[off + i] = d;
  }
}

}  // namespace

extern "C" int tpt_token_chase(const void* nxt, void* starts, void* T, int S,
                               int NBP, int T_max, void* stream) {
  token_chase_kernel<<<S, CH_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nxt, (int32_t*)starts, (int32_t*)T, NBP, T_max);
  return (int)cudaGetLastError();
}

extern "C" int tpt_trunc_deficits(const void* seg_c, const void* s_c,
                                  const void* w_c, const void* n_tr,
                                  void* defs_c, int S, int T_max, int W,
                                  void* stream) {
  const int threads = 32;
  trunc_deficits_kernel<<<(S + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)seg_c, (const int32_t*)s_c, (const int32_t*)w_c,
      (const int32_t*)n_tr, (int32_t*)defs_c, S, T_max, W);
  return (int)cudaGetLastError();
}
