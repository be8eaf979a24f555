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
// What bounds it on this card: as one walk a shard, its dependence chain
// (the first port ran it on one thread a shard, 8 of 132 SMs).  But the
// next position depends only on the plane words at t, so t -> t + adv(t) is
// a function and the walk resolves in parallel as B3's does; what is left
// is bytes (each visited word read once, the bitmap and the entries written
// once) and a few operations a step.
//
// Design: B3's launches on the caller's stream, over tiles of FT = 4096
// positions, every tile of every shard a block:
//   1. predict_maps_kernel: per tile, in shared memory, the exit map of
//      every position (the first chain position at or past the tile's end)
//      with the entries emitted on the way, by pointer doubling: log2(FT)
//      rounds.  An advance is at most 241, so a tile is entered at one of
//      its first 256 positions and only those maps are kept.
//   2. predict_entries_kernel: per shard, one lookup a tile gives each
//      visited tile's entry position and entry offset, and the state row.
//   3. predict_pack_kernel: every tile writes its 128 bitmap words (it owns
//      them: no atomics); a visited tile first walks its own chain from its
//      entry, in shared memory, setting its bits and writing its entries
//      from its offset, in walk order.
// The wrapper (ops/greedy_predict.greedy_predict_batch) allocates the
// workspace with torch.  The TPU kernel's 512-position tiles, SMEM chunk
// flushes and NP % 4096 rule answer Mosaic's constraints and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT = 4096;   // positions per tile
constexpr int FENT = 256;  // entry offsets of a tile (an advance is <= 241)
constexpr int MAP_THREADS = 256;
constexpr int PACK_THREADS = 128;
constexpr int NSLOTS = 8;
constexpr int ECHUNK_W = 128;

struct PredictCfg {
  int wmask, minp, lazy;
};

// one step at t: the advance, and 1 when it emits an entry
__device__ __forceinline__ int predict_step(int t, int32_t p, int32_t q,
                                            const PredictCfg& c,
                                            int* emits) {
  const int ln = (p >> 15) & 31;
  const int run = (p >> 20) & 255;
  const bool matchy = ln >= c.minp;
  const bool rle_go = run >= 2 && !(run <= 6 && ln > run);
  bool go_lazy = false;
  if (c.lazy) {
    const int pix = q & 0x7FFF;
    const int psz = (q >> 15) & 15;
    const int tau = t & c.wmask;
    go_lazy = matchy && ln <= 8 && psz > ln && !rle_go &&
              !(pix <= tau && tau < pix + psz);
  }
  *emits = matchy && run <= 6;
  return rle_go ? min(run, 241) : ((matchy && !go_lazy) ? ln : 1);
}

// a map word: entries emitted << 32 | exit position
__device__ __forceinline__ int map_exit(int64_t v) {
  return (int)(uint32_t)(uint64_t)v;
}

__global__ void __launch_bounds__(MAP_THREADS)
predict_maps_kernel(const int32_t* __restrict__ pk,
                    const int32_t* __restrict__ pp,
                    const int32_t* __restrict__ npos_arr,
                    int64_t* __restrict__ maps, int NP, int n_tiles,
                    PredictCfg c) {
  __shared__ int64_t F[FT];
  const int s = blockIdx.y, k = blockIdx.x, base = k * FT;
  const int limit = min(npos_arr[s] - 15, NP);  // first position not walked
  if (base >= limit) return;                    // never entered
  const int E = min(FT, limit - base);          // local positions walked
  const int32_t* k_row = pk + (size_t)s * NP + base;
  const int32_t* q_row = pp + (size_t)s * NP + base;
  const int per = c.lazy ? 2 : 1;  // words an entry appends
  for (int i = threadIdx.x; i < FT; i += MAP_THREADS) {
    int f = i;  // a position past the walk is its own exit
    int64_t cnt = 0;
    if (i < E) {
      int emits;
      f = i + predict_step(base + i, k_row[i], c.lazy ? q_row[i] : 0, c,
                           &emits);
      cnt = emits * per;
    }
    F[i] = (int64_t)((uint64_t)cnt << 32 | (uint32_t)f);
  }
  __syncthreads();
  // pointer doubling; in place is safe (B3's argument): every value is a
  // valid (exit, count) pair of its position, a later one further along
  for (int r = 1; r < FT; r <<= 1) {
    for (int i = threadIdx.x; i < E; i += MAP_THREADS) {
      const int64_t v = F[i];
      const int g = map_exit(v);
      if (g < E) {
        const int64_t w = F[g];
        F[i] = (int64_t)((uint64_t)((v >> 32) + (w >> 32)) << 32 |
                         (uint32_t)map_exit(w));
      }
    }
    __syncthreads();
  }
  int64_t* m_row = maps + ((size_t)s * n_tiles + k) * FENT;
  for (int o = threadIdx.x; o < FENT; o += MAP_THREADS) {
    const int64_t v = F[o];
    m_row[o] = (int64_t)((uint64_t)(v >> 32) << 32 |
                         (uint32_t)(base + map_exit(v)));
  }
}

__global__ void predict_entries_kernel(const int32_t* __restrict__ npos_arr,
                                       const int64_t* __restrict__ maps,
                                       int32_t* __restrict__ ent_at,
                                       int32_t* __restrict__ ent_off,
                                       int32_t* __restrict__ state, int NP,
                                       int n_tiles) {
  const int s = blockIdx.x;
  int32_t* a_row = ent_at + (size_t)s * n_tiles;
  for (int i = threadIdx.x; i < n_tiles; i += 32) a_row[i] = -1;
  __syncwarp();
  if (threadIdx.x != 0) return;
  const int limit = min(npos_arr[s] - 15, NP);
  int t = 0;
  int64_t ne = 0;
  // t lies in the first FENT of its tile, and a tile's exit in a later
  // tile: at most n_tiles lookups
  for (int hop = 0; hop < n_tiles && t < limit; ++hop) {
    const int k = t / FT;
    a_row[k] = t;
    ent_off[(size_t)s * n_tiles + k] = (int32_t)ne;
    const int64_t v = maps[((size_t)s * n_tiles + k) * FENT + (t - k * FT)];
    ne += v >> 32;
    t = map_exit(v);
  }
  int32_t* st = state + (size_t)s * NSLOTS;
  st[0] = (int32_t)ne;
  st[1] = t;
  st[2] = (int32_t)(ne / ECHUNK_W);
  for (int i = 3; i < NSLOTS; ++i) st[i] = 0;
}

__global__ void __launch_bounds__(PACK_THREADS)
predict_pack_kernel(const int32_t* __restrict__ pk,
                    const int32_t* __restrict__ pp,
                    const int32_t* __restrict__ npos_arr,
                    const int32_t* __restrict__ ent_at,
                    const int32_t* __restrict__ ent_off,
                    int32_t* __restrict__ bm, int32_t* __restrict__ ent,
                    int NP, int n_tiles, int epad, PredictCfg c) {
  __shared__ int32_t sk[FT];
  __shared__ int32_t sq[FT];
  __shared__ uint32_t bits[FT / 32];
  const int s = blockIdx.y, k = blockIdx.x, base = k * FT;
  const int e = ent_at[(size_t)s * n_tiles + k];
  const int end = min(base + FT, min(npos_arr[s] - 15, NP));
  for (int i = threadIdx.x; i < FT / 32; i += PACK_THREADS) bits[i] = 0;
  if (e >= 0) {
    const int32_t* k_row = pk + (size_t)s * NP;
    const int32_t* q_row = pp + (size_t)s * NP;
    for (int i = e + threadIdx.x; i < end; i += PACK_THREADS) {
      sk[i - base] = k_row[i];
      if (c.lazy) sq[i - base] = q_row[i];
    }
  }
  __syncthreads();
  if (e >= 0 && threadIdx.x == 0) {
    int32_t* e_row = ent + (size_t)s * epad + ent_off[(size_t)s * n_tiles + k];
    for (int t = e; t < end;) {
      const int32_t p = sk[t - base];
      const int32_t q = c.lazy ? sq[t - base] : 0;
      int emits;
      const int adv = predict_step(t, p, q, c, &emits);
      if (emits) {
        bits[(t - base) >> 5] |= 1u << (t & 31);
        *e_row++ = p;
        if (c.lazy) *e_row++ = q;
      }
      t += adv;
    }
  }
  __syncthreads();
  int32_t* b_row = bm + (size_t)s * (NP / 32) + base / 32;
  const int nwords = (min(base + FT, NP) - base) / 32;
  for (int i = threadIdx.x; i < nwords; i += PACK_THREADS)
    b_row[i] = (int32_t)bits[i];
}

}  // namespace

extern "C" int tpt_greedy_predict(const void* pk, const void* pp,
                                  const void* npos, void* bm, void* ent,
                                  void* state, void* maps, void* ent_at,
                                  void* ent_off, int S, int NP, int n_tiles,
                                  int epad, int window, int minp, int lazy,
                                  void* stream) {
  // the workspace is sized by the wrapper: n_tiles rows of FENT maps
  if (n_tiles != (NP + FT - 1) / FT) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const PredictCfg c{(1 << window) - 1, minp, lazy};
  if (n_tiles > 0)
    predict_maps_kernel<<<dim3(n_tiles, S), MAP_THREADS, 0, st>>>(
        (const int32_t*)pk, (const int32_t*)pp, (const int32_t*)npos,
        (int64_t*)maps, NP, n_tiles, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  predict_entries_kernel<<<S, 32, 0, st>>>((const int32_t*)npos,
                                           (const int64_t*)maps,
                                           (int32_t*)ent_at, (int32_t*)ent_off,
                                           (int32_t*)state, NP, n_tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (n_tiles > 0)
    predict_pack_kernel<<<dim3(n_tiles, S), PACK_THREADS, 0, st>>>(
        (const int32_t*)pk, (const int32_t*)pp, (const int32_t*)npos,
        (const int32_t*)ent_at, (const int32_t*)ent_off, (int32_t*)bm,
        (int32_t*)ent, NP, n_tiles, epad, c);
  return (int)cudaGetLastError();
}
