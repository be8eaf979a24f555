// Kernels X3 and X4: the optimal (minimum-bit) parse DPs of the v1 and
// extended formats, as three passes over blocks of B positions.
//
// Replaces the serial lax.scan loops of tamp_tpu/ops/opt_parse.py:66
// opt_v1_choice_device (X3: K = 16) and tamp_tpu/ops/opt_parse_ext.py:57
// opt_ext_choice_device (X4: K = minp + 131).  cost[p] is the least number
// of payload bits that codes positions p.. of a shard; it depends on
// cost[p + 1 .. p + K] through the edges of position p:
//   - advance 1 at weight w0: a literal (1 + literal bits; INF for a byte
//     wider than `literal` bits; 0 at or past npos, where positions are
//     free literals), or inside an X4 forced-RLE region the chunk-cost
//     chain weight;
//   - advances minp .. hi at the static token bits of a match of that size
//     (X3: hi = min(flen, minp + 13); X4: hi = min(flen, bound, room >=
//     minp + 12 ? room : minp + 11), none inside a region).
// Every sum saturates at INF = 2^26 - 64, so no int32 sum overflows, and
// saturation commutes with min-plus over non-negative weights: the output
// does not depend on B.
//
//   pass 1   one block of K columns per (shard, block of B positions):
//            column j is the block's first K costs as a function of entry
//            j of the next block's boundary vector (the min-plus identity
//            pushed through the block, right to left).  Thread j owns
//            column j and never reads another's, so no barrier runs after
//            the block's inputs are staged.  Each step relaxes only the
//            edges that exist (advance 1 and minp..hi), the same number
//            for every thread of the block: no divergence.  X3 keeps its
//            16-row ring in registers (16 threads a block, 8 blocks a
//            CTA); X4 keeps its K rows of K columns in shared memory (72 KB
//            at K = 134, one block a CTA).  The matrix is written column by
//            column: T[blk][j][i].
//   combine  one CTA per shard, thread i owns row i: right to left over the
//            blocks, write the block's incoming boundary vector, then
//            v[i] = min_j T[i][j] + v[j].  The matrices stream through
//            shared memory with cp.async, several blocks ahead.
//   pass 2   one thread per (shard, block), serial over its B positions
//            with exact costs: the choice is the lowest advance among the
//            minimal saturated costs (X3's score = cost * 32 + priority,
//            X4's argmin); `bad` is any in-shard position (X4: not inside
//            a region) whose cost is INF.
//
// What bounds it on this card: the dependence chains (each position's cost
// needs the one after it, inside a block) and, in pass 1, the K x edges
// integer operations a position; bytes are a few per position.  The design
// spreads pass 1 over S * NP / B blocks and keeps the chains to B steps.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = (1 << 26) - 64;
// Huffman code lengths (flag bit included), symbols 0..14 (an extended
// match's second symbol reaches 14)
__constant__ int HL[15] = {2, 3, 5, 5, 6, 7, 7, 7, 8, 8, 9, 9, 9, 7, 9};

struct Cfg {
  int S, NP, B, n_b, window, literal, minp, lit_limit;
};

__host__ __device__ constexpr int tsize(int K) { return (K * K + 3) & ~3; }

// Token bits of a match of advance a (INF where no match has that size).
template <bool EXT>
__device__ __forceinline__ int match_bits(const Cfg& c, int a) {
  if (a < c.minp) return INF;
  if (!EXT) return a <= c.minp + 13 ? HL[a - c.minp] + c.window : INF;
  if (a <= c.minp + 11) return HL[a - c.minp] + c.window;
  return HL[13] + HL[(a - c.minp - 12) >> 3] - 1 + 3 + c.window;
}

struct Edges {
  int w0;      // weight of advance 1
  int hi;      // highest match advance (none below minp)
  bool count;  // an INF cost here makes the shard bad
};

// The edges of position p of shard s.  X3: plane = flen, data = the bytes;
// X4: plane = packed, data = the bytes or null (literal 8), cw = the chain
// weights.
template <bool EXT, int K>
__device__ __forceinline__ Edges edges(const Cfg& c, const int32_t* plane,
                                       const uint8_t* data,
                                       const int32_t* cw, int s, int p,
                                       int npos) {
  if (p >= npos) return {0, 0, false};
  const int64_t off = (int64_t)s * c.NP + p;
  int lc = 1 + c.literal;
  if (data != nullptr && data[off] >= c.lit_limit) lc = INF;
  const int v = plane[off];
  if (!EXT) return {lc, min(v, c.minp + 13), true};
  if (v < 0) return {cw[off], 0, false};  // interior: the chain edge only
  const int room = ((v >> 8) & 0x7FFF) + 1;
  int hi = min(min(v & 0xFF, (v >> 23) & 0xFF), K);
  hi = min(hi, room >= c.minp + 12 ? room : c.minp + 11);
  return {lc, hi, true};
}

// ---- pass 1, registers (X3): 16 threads a block ---------------------------
// Row i (cost[p + 1 + i]) of the ring at step k lives in r[(i - k) mod K];
// the loop is unrolled by K, so every index is static (B is a multiple of
// K).
template <int K, bool EXT>
__global__ void __launch_bounds__(128)
pass1_regs(Cfg c, const int32_t* plane, const uint8_t* data,
           const int32_t* cw, const int32_t* npos, int32_t* T) {
  const int j = threadIdx.x % K;
  const int blk = blockIdx.x * (blockDim.x / K) + threadIdx.x / K;
  if (blk >= c.S * c.n_b) return;
  const int s = blk / c.n_b, pend = (blk % c.n_b + 1) * c.B;
  const int np = npos[s];
  int wt[K + 1];
#pragma unroll
  for (int a = 0; a <= K; a++) wt[a] = match_bits<EXT>(c, a);
  int r[K];
#pragma unroll
  for (int i = 0; i < K; i++) r[i] = i == j ? 0 : INF;
  for (int q = 0; q < c.B; q += K) {
#pragma unroll
    for (int u = 0; u < K; u++) {
      const Edges e = edges<EXT, K>(c, plane, data, cw, s, pend - 1 - q - u,
                                    np);
      int nv = r[(K - u) % K] + e.w0;
#pragma unroll
      for (int a = 2; a <= K; a++) {
        const int x = r[(a - 1 - u + K) % K] + wt[a];
        nv = min(nv, a <= e.hi ? x : INF);
      }
      r[K - 1 - u] = min(nv, INF);
    }
  }
  // after B (a multiple of K) steps, row i is back in r[i]
  int4* out = reinterpret_cast<int4*>(T + (int64_t)blk * tsize(K) + j * K);
#pragma unroll
  for (int i = 0; i < K / 4; i++)
    out[i] = make_int4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
}

// ---- pass 1, shared memory (X4): one block a CTA, K threads ---------------
// ring[(top + i) mod K][j] holds row i of column j; stage[k] the edges of
// the block's k-th position from the right.
template <int K, bool EXT>
__global__ void pass1_shared(Cfg c, const int32_t* plane, const uint8_t* data,
                             const int32_t* cw, const int32_t* npos,
                             int32_t* T) {
  extern __shared__ int4 smem4[];
  int* ring = reinterpret_cast<int*>(smem4);
  int2* stage = reinterpret_cast<int2*>(ring + ((K * K + 1) & ~1));
  int* wt = reinterpret_cast<int*>(stage + c.B);
  const int j = threadIdx.x;
  const int blk = blockIdx.x;
  const int s = blk / c.n_b, pend = (blk % c.n_b + 1) * c.B;
  const int np = npos[s];
  for (int k = j; k < c.B; k += blockDim.x) {
    const Edges e = edges<EXT, K>(c, plane, data, cw, s, pend - 1 - k, np);
    stage[k] = make_int2(e.w0, e.hi);
  }
  for (int a = j; a <= K; a += blockDim.x) wt[a] = match_bits<EXT>(c, a);
  for (int i = 0; i < K; i++) ring[i * K + j] = i == j ? 0 : INF;
  __syncthreads();
  int top = 0;
  for (int k = 0; k < c.B; k++) {
    const int2 e = stage[k];
    int nv = ring[top * K + j] + e.x;
    for (int a = c.minp; a <= e.y; a++) {
      int idx = top + a - 1;
      if (idx >= K) idx -= K;
      nv = min(nv, ring[idx * K + j] + wt[a]);
    }
    top = top == 0 ? K - 1 : top - 1;
    ring[top * K + j] = min(nv, INF);
  }
  __syncthreads();
  int32_t* Tb = T + (int64_t)blk * tsize(K);
  for (int x = j; x < K * K; x += blockDim.x) {
    const int col = x / K, row = x - col * K;
    int ph = top + row;
    if (ph >= K) ph -= K;
    Tb[x] = ring[ph * K + col];
  }
}

// ---- combine: one CTA per shard -------------------------------------------
template <int K, int NST>
__global__ void combine(int n_b, const int32_t* T, int32_t* bounds,
                        int32_t* cost0) {
  extern __shared__ int4 smem4[];
  constexpr int TS = tsize(K);
  int* buf = reinterpret_cast<int*>(smem4);
  int* v = buf + NST * TS;
  const int s = blockIdx.x, tid = threadIdx.x;
  const int32_t* Ts = T + (int64_t)s * n_b * TS;
  auto fetch = [&](int t) {  // the t-th block from the right
    if (t < n_b) {
      const int4* src = reinterpret_cast<const int4*>(
          Ts + (int64_t)(n_b - 1 - t) * TS);
      int4* dst = reinterpret_cast<int4*>(buf + (t % NST) * TS);
      for (int x = tid; x < TS / 4; x += blockDim.x)
        __pipeline_memcpy_async(dst + x, src + x, 16);
    }
    __pipeline_commit();
  };
  for (int t = 0; t < NST - 1; t++) fetch(t);
  if (tid < K) v[tid] = 0;
  for (int t = 0; t < n_b; t++) {
    fetch(t + NST - 1);
    __pipeline_wait_prior(NST - 1);
    __syncthreads();
    const int* Tb = buf + (t % NST) * TS;
    int nv = INF;
    if (tid < K) {
      bounds[((int64_t)s * n_b + n_b - 1 - t) * K + tid] = v[tid];
      for (int jj = 0; jj < K; jj++) nv = min(nv, Tb[jj * K + tid] + v[jj]);
    }
    __syncthreads();
    if (tid < K) v[tid] = nv;
  }
  __syncthreads();
  if (tid == 0) cost0[s] = v[0];
}

// ---- pass 2, registers (X3): one thread per block --------------------------
template <int K, bool EXT, typename Choice>
__global__ void pass2_regs(Cfg c, const int32_t* plane, const uint8_t* data,
                           const int32_t* cw, const int32_t* npos,
                           const int32_t* bounds, Choice* choice,
                           int32_t* bad) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= c.S * c.n_b) return;
  const int s = blk / c.n_b, pend = (blk % c.n_b + 1) * c.B;
  const int np = npos[s];
  int wt[K + 1];
#pragma unroll
  for (int a = 0; a <= K; a++) wt[a] = match_bits<EXT>(c, a);
  int r[K];
#pragma unroll
  for (int i = 0; i < K; i++) r[i] = bounds[(int64_t)blk * K + i];
  bool flag = false;
  Choice* out = choice + (int64_t)s * c.NP;
  for (int q = 0; q < c.B; q += K) {
#pragma unroll
    for (int u = 0; u < K; u++) {
      const int p = pend - 1 - q - u;
      const Edges e = edges<EXT, K>(c, plane, data, cw, s, p, np);
      int best = min(r[(K - u) % K] + e.w0, INF), ch = 1;
#pragma unroll
      for (int a = 2; a <= K; a++) {
        const int x = min(r[(a - 1 - u + K) % K] + wt[a], INF);
        if (a <= e.hi && x < best) {
          best = x;
          ch = a;
        }
      }
      flag |= e.count && best >= INF;
      out[p] = (Choice)ch;
      r[K - 1 - u] = best;
    }
  }
  if (flag) atomicOr(bad + s, 1);
}

// ---- pass 2, shared memory (X4): one thread per block, 32 a CTA ------------
template <int K, bool EXT, typename Choice>
__global__ void __launch_bounds__(32)
pass2_shared(Cfg c, const int32_t* plane, const uint8_t* data,
             const int32_t* cw, const int32_t* npos, const int32_t* bounds,
             Choice* choice, int32_t* bad) {
  __shared__ int ring[K * 32];  // ring[row][lane]
  __shared__ int wt[K + 1];
  const int lane = threadIdx.x;
  for (int a = lane; a <= K; a += 32) wt[a] = match_bits<EXT>(c, a);
  __syncthreads();
  const int blk = blockIdx.x * 32 + lane;
  if (blk >= c.S * c.n_b) return;
  const int s = blk / c.n_b, pend = (blk % c.n_b + 1) * c.B;
  const int np = npos[s];
  for (int i = 0; i < K; i++)
    ring[i * 32 + lane] = bounds[(int64_t)blk * K + i];
  bool flag = false;
  Choice* out = choice + (int64_t)s * c.NP;
  int top = 0;
  for (int k = 0; k < c.B; k++) {
    const int p = pend - 1 - k;
    const Edges e = edges<EXT, K>(c, plane, data, cw, s, p, np);
    int best = min(ring[top * 32 + lane] + e.w0, INF), ch = 1;
    for (int a = c.minp; a <= e.hi; a++) {
      int idx = top + a - 1;
      if (idx >= K) idx -= K;
      const int x = min(ring[idx * 32 + lane] + wt[a], INF);
      if (x < best) {
        best = x;
        ch = a;
      }
    }
    flag |= e.count && best >= INF;
    out[p] = (Choice)ch;
    top = top == 0 ? K - 1 : top - 1;
    ring[top * 32 + lane] = best;
  }
  if (flag) atomicOr(bad + s, 1);
}

Cfg make_cfg(int S, int NP, int B, int window, int literal) {
  Cfg c;
  c.S = S;
  c.NP = NP;
  c.B = B;
  c.n_b = NP / B;
  c.window = window;
  c.literal = literal;
  c.minp = 2 + (window > 10 + ((literal - 5) << 1) ? 1 : 0);
  c.lit_limit = literal == 8 ? 256 : 1 << literal;
  return c;
}

template <int K, int NST>
int run_combine(const Cfg& c, int threads, const int32_t* T,
                int32_t* bounds, int32_t* cost0, cudaStream_t st) {
  const size_t smem = ((size_t)NST * tsize(K) + K) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      combine<K, NST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  combine<K, NST><<<c.S, threads, smem, st>>>(c.n_b, T, bounds, cost0);
  return (int)cudaGetLastError();
}

template <int K>
int run_ext(const Cfg& c, const int32_t* packed, const uint8_t* data,
            const int32_t* npos, const int32_t* cw, uint8_t* choice,
            int32_t* cost0, int32_t* bad, int32_t* T, int32_t* bounds,
            cudaStream_t st) {
  const int nblk = c.S * c.n_b;
  const size_t smem1 = ((size_t)((K * K + 1) & ~1) + 2 * (size_t)c.B + K + 1)
                       * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      pass1_shared<K, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (e != cudaSuccess) return (int)e;
  pass1_shared<K, true><<<nblk, K, smem1, st>>>(c, packed, data, cw, npos,
                                                 T);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  int rc = run_combine<K, 2>(c, 256, T, bounds, cost0, st);
  if (rc != 0) return rc;
  pass2_shared<K, true, uint8_t><<<(nblk + 31) / 32, 32, 0, st>>>(
      c, packed, data, cw, npos, bounds, choice, bad);
  return (int)cudaGetLastError();
}

}  // namespace

// X3.  flen (S, NP) int32, data (S, NP) uint8, npos (S,); out: choice (S,
// NP) int32, cost0 (S,), bad (S,) int32 (zeroed by the caller); scratch: T
// (S * NP / B * 256) and bounds (S * NP / B * 16) int32.  B divides NP and
// is a multiple of 16.
extern "C" int tpt_opt_v1_choice(const void* flen, const void* data,
                                 const void* npos, void* choice, void* cost0,
                                 void* bad, void* T, void* bounds, int S,
                                 int NP, int B, int window, int literal,
                                 void* stream) {
  constexpr int K = 16;
  const Cfg c = make_cfg(S, NP, B, window, literal);
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = S * c.n_b;
  pass1_regs<K, false><<<(nblk + 7) / 8, 8 * K, 0, st>>>(
      c, (const int32_t*)flen, (const uint8_t*)data, nullptr,
      (const int32_t*)npos, (int32_t*)T);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int rc = run_combine<K, 8>(c, 32, (const int32_t*)T, (int32_t*)bounds,
                             (int32_t*)cost0, st);
  if (rc != 0) return rc;
  pass2_regs<K, false, int32_t><<<(nblk + 63) / 64, 64, 0, st>>>(
      c, (const int32_t*)flen, (const uint8_t*)data, nullptr,
      (const int32_t*)npos, (const int32_t*)bounds, (int32_t*)choice,
      (int32_t*)bad);
  return (int)cudaGetLastError();
}

// X4.  packed (S, NP) int32, data (S, NP) uint8 or null (literal 8), npos
// (S,), cw (S, NP) int32 chain weights; out: choice (S, NP) uint8, cost0,
// bad (zeroed by the caller); scratch: T (S * NP / B * tsize(K)) and bounds
// (S * NP / B * K) int32, K = minp + 131.  B divides NP.
extern "C" int tpt_opt_ext_choice(const void* packed, const void* data,
                                  const void* npos, const void* cw,
                                  void* choice, void* cost0, void* bad,
                                  void* T, void* bounds, int S, int NP,
                                  int B, int window, int literal,
                                  void* stream) {
  const Cfg c = make_cfg(S, NP, B, window, literal);
  cudaStream_t st = (cudaStream_t)stream;
  auto* args = (const int32_t*)packed;
  if (c.minp == 2)
    return run_ext<133>(c, args, (const uint8_t*)data, (const int32_t*)npos,
                        (const int32_t*)cw, (uint8_t*)choice,
                        (int32_t*)cost0, (int32_t*)bad, (int32_t*)T,
                        (int32_t*)bounds, st);
  return run_ext<134>(c, args, (const uint8_t*)data, (const int32_t*)npos,
                      (const int32_t*)cw, (uint8_t*)choice, (int32_t*)cost0,
                      (int32_t*)bad, (int32_t*)T, (int32_t*)bounds, st);
}
