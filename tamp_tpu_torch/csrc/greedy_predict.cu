// Kernel B7: the speculative greedy walk of the greedy-parity encode.
//
// Replaces the TPU kernel tamp_tpu/ops/greedy_predict_pallas.py::_kernel
// (via greedy_predict_batch).  Per shard, a replay of the reference greedy
// step over the packed plane pk[t] = idx16 | len16 << 15 | run << 20 (and,
// under lazy matching, the probe plane pp[t] = pidx | plen << 15), from
// t = 0 while t < min(npos - 15, NP):
//   - ln = (p >> 15) & 31, run = (p >> 20) & 255, matchy = ln >= minp;
//   - rle_go = run >= 2 and not (run <= 6 and ln > run): advance
//     min(run, 241);
//   - lazy: go_lazy = matchy, ln <= 8, psz > ln, not rle_go, and the probe
//     source [pix, pix + psz) does not hold tau = t & (W - 1): advance 1;
//   - otherwise advance ln when matchy, else 1;
//   - when matchy and run <= 6: set bit t of the start bitmap and append p
//     (then q when lazy) to the entry row.
// Outputs: the bitmap row (NP / 32 words, every word written, zeros
// included: the host popcounts whole rows), the entry row (entries
// [0, ne) written, the rest untouched), and the state row
// (ne, t, ne / 128, 0, 0, 0, 0, 0); the TPU kernel's third slot counts the
// 128-word chunks it flushed, which is ne / 128 at the end.
//
// What bounds it on this card: the dependence chain of the walk (each step
// needs the previous step's advance), as for B3 and B6: one thread walks a
// shard, each step a shared-memory load and a few integer operations.
//
// Design: one block per shard.  All threads zero the bitmap row and stage
// the first tile; then thread 0 walks while warps 1..7 stage the next
// 16 KiB tile of pk (and pp) into the other half of a double buffer in
// dynamic shared memory.  The walker keeps the current bitmap word in a
// register and stores it when the walk leaves it; entries go straight to
// the entry row.  The TPU kernel's 512-position tiles, SMEM chunk flushes
// and NP % 4096 rule answer Mosaic's constraints and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;  // positions per staged tile: 16 KiB per plane
constexpr int NSLOTS = 8;
constexpr int ECHUNK_W = 128;

__global__ void __launch_bounds__(THREADS)
greedy_predict_kernel(const int32_t* __restrict__ pk,
                      const int32_t* __restrict__ pp,
                      const int32_t* __restrict__ npos_arr,
                      int32_t* __restrict__ bm, int32_t* __restrict__ ent,
                      int32_t* __restrict__ state, int NP, int epad,
                      int wmask, int minp, int lazy) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;             // [2][TILE] of pk
  int32_t* sq = smem + 2 * TILE;  // [2][TILE] of pp (lazy only)
  const int s = blockIdx.x;
  const int hard_stop = min(npos_arr[s] - 15, NP);
  const int32_t* k_row = pk + (size_t)s * NP;
  const int32_t* q_row = pp + (size_t)s * NP;
  int32_t* b_row = bm + (size_t)s * (NP / 32);
  int32_t* e_row = ent + (size_t)s * epad;
  const int n_tiles = hard_stop > 0 ? (hard_stop + TILE - 1) / TILE : 0;

  for (int i = threadIdx.x; i < NP / 32; i += THREADS) b_row[i] = 0;
  if (n_tiles > 0) {
    for (int i = threadIdx.x; i < TILE && i < NP; i += THREADS) {
      sk[i] = k_row[i];
      if (lazy) sq[i] = q_row[i];
    }
  }
  __syncthreads();  // the zeroed bitmap and the first tile

  // walker state (meaningful in thread 0 only)
  int t = 0, ne = 0, wi = -1;
  uint32_t word = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = (tile & 1) * TILE;
    const int nxt = TILE - cur;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NP;
           i += THREADS - 32) {
        sk[nxt + i] = k_row[base + i];
        if (lazy) sq[nxt + i] = q_row[base + i];
      }
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, hard_stop);
      while (t < end) {
        const int32_t p = sk[cur + t - base];
        const int ln = (p >> 15) & 31;
        const int run = (p >> 20) & 255;
        const bool matchy = ln >= minp;
        const bool rle_go = run >= 2 && !(run <= 6 && ln > run);
        bool go_lazy = false;
        int32_t q = 0;
        if (lazy) {
          q = sq[cur + t - base];
          const int pix = q & 0x7FFF;
          const int psz = (q >> 15) & 15;
          const int tau = t & wmask;
          go_lazy = matchy && ln <= 8 && psz > ln && !rle_go &&
                    !(pix <= tau && tau < pix + psz);
        }
        if (matchy && run <= 6) {
          if ((t >> 5) != wi) {
            if (word) b_row[wi] = (int32_t)word;
            wi = t >> 5;
            word = 0;
          }
          word |= 1u << (t & 31);
          e_row[ne++] = p;
          if (lazy) e_row[ne++] = q;
        }
        t += rle_go ? min(run, 241) : ((matchy && !go_lazy) ? ln : 1);
      }
    }
    // barrier (the next tile is staged) and the walker's verdict in one
    if (__syncthreads_or(threadIdx.x == 0 && t >= hard_stop)) break;
  }
  if (threadIdx.x == 0) {
    if (word) b_row[wi] = (int32_t)word;
    int32_t* st = state + (size_t)s * NSLOTS;
    st[0] = ne;
    st[1] = t;
    st[2] = ne / ECHUNK_W;
    for (int k = 3; k < NSLOTS; ++k) st[k] = 0;
  }
}

}  // namespace

extern "C" int tpt_greedy_predict(const void* pk, const void* pp,
                                  const void* npos, void* bm, void* ent,
                                  void* state, int S, int NP, int epad,
                                  int window, int minp, int lazy,
                                  void* stream) {
  if (S == 0) return 0;
  const int smem = (lazy ? 4 : 2) * TILE * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  greedy_predict_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pk, (const int32_t*)pp, (const int32_t*)npos,
      (int32_t*)bm, (int32_t*)ent, (int32_t*)state, NP, epad,
      (1 << window) - 1, minp, lazy);
  return (int)cudaGetLastError();
}
