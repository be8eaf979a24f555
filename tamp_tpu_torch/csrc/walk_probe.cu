// Chain-floor probes for the serial walks of kernels B4, B3, B6, B7, B8 and
// X1, and the parts of the match-table scan of B5 (a measurement tool, not
// a kernel of any path; tools/torch_walk_probe.py builds and times it).
//
// Each probe walks the same chain as its kernel, in the first port's
// skeleton (one block per shard, thread 0 walks a shared-memory tile while
// warps 1..7 stage the next one, one barrier per tile), and does nothing
// else: no ring, no output, no bit packing.  Its time is what the chain
// alone costs in that skeleton, so a kernel's time minus its probe's is
// what the kernel spends on top of its chain.
//   - probe_decode_chain: c += delta over the fused parse words (B4's chain),
//     folding kind, cnt and idx into a checksum so they stay decoded;
//   - probe_fields_chain: t += adv over the planned fields (B3's chain) up to
//     the first t >= npos - 15 or an error field, folding A into a checksum;
//   - probe_lazy_chain: B6's hop over the packed tables P and the probe Q
//     with its lazy cache (the deferral decision and the excess-literal
//     stop included, no bits);
//   - probe_greedy_chain: B7's hop over the packed plane (and the probe
//     plane when lazy), no bitmap and no entries;
//   - probe_chase_chain: B8's hop c = nxt[c] until a hop reaches NBP or does
//     not advance, storing no start.
// Outputs per shard: steps and checksum (B4, B3), steps and the stop t
// (B6, B7), hops and the stop c (B8).
//
// probe_trunc_chain walks X1's fold (D += max(0, w - (W - ((s - D) mod
// W))), D reset where the segment changes) on one thread a shard over its
// three rows staged in shared memory TILE tokens at a time, and stores the
// deficits: the fold's chain floor.
//
// probe_read_plane reads an int32 plane once, coalesced (16 B a thread),
// folding it into one word a block: the bytes any design that looks at
// every bit of B8's nxt plane must read.
//
// probe_tables runs the first port's table skeleton (one block per 256
// positions, a thread a position over the slab C[t0 .. t0 + 256 + W + lrun)
// staged in shared memory; lrun is 16 for B5's raw shards, LEXT for B1's
// and B2's model history) with parts cut out, writing the same planes:
//   mode 0: the staging and the stores alone (each plane gets a byte of the
//           slab, so the staging stays);
//   mode 1: the scan of every slot with first-byte compares only: the
//           lowest slot whose first byte matches scores len 1, no extension;
//   mode 2: mode 1, also counting (position, slot) pairs of the main family
//           whose first byte matches and whose first two bytes match (the
//           glue included) into counts[0], counts[1], and extending each
//           two-byte match byte by byte (the glue included) up to
//           min(npos - t, lrun, W - x): the pairs that reach 16 bytes into
//           counts[2] and their lengths past 16 into counts[3] (64-bit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;

__global__ void __launch_bounds__(THREADS)
probe_decode_chain(const int32_t* __restrict__ pk, int32_t* __restrict__ res,
                   int NBP) {
  __shared__ int32_t tiles[2][TILE];
  const int s = blockIdx.x;
  const int32_t* row = pk + (size_t)s * NBP;
  const int n_tiles = (NBP + TILE - 1) / TILE;
  for (int i = threadIdx.x; i < TILE && i < NBP; i += THREADS)
    tiles[0][i] = row[i];
  __syncthreads();
  int c = 0, n = 0;
  uint32_t sum = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NBP;
           i += THREADS - 32)
        tiles[cur ^ 1][i] = row[base + i];
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, NBP);
      while (c < end) {
        const int32_t p = tiles[cur][c - base];
        const int delta = (p >> 11) & 63;
        if (delta == 0) {
          c = NBP;
          break;
        }
        sum = sum * 31u + (uint32_t)((p & 0x7FF) ^ (p >> 17));
        ++n;
        c += delta;
      }
    }
    if (__syncthreads_or(threadIdx.x == 0 && c >= NBP)) break;
  }
  if (threadIdx.x == 0) {
    res[2 * s] = n;
    res[2 * s + 1] = (int32_t)sum;
  }
}

__global__ void __launch_bounds__(THREADS)
probe_fields_chain(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                   const int32_t* __restrict__ npos_arr,
                   int32_t* __restrict__ res, int NP) {
  __shared__ int32_t sa[2][TILE];
  __shared__ int32_t sb[2][TILE];
  const int s = blockIdx.x;
  const int hard_stop = npos_arr[s] - 15;
  const int32_t* a_row = A + (size_t)s * NP;
  const int32_t* b_row = B + (size_t)s * NP;
  const int n_tiles = hard_stop > 0 ? (hard_stop + TILE - 1) / TILE : 0;
  if (n_tiles > 0) {
    for (int i = threadIdx.x; i < TILE && i < NP; i += THREADS) {
      sa[0][i] = a_row[i];
      sb[0][i] = b_row[i];
    }
  }
  __syncthreads();
  int t = 0, n = 0, stop = 0;
  uint32_t sum = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NP;
           i += THREADS - 32) {
        sa[cur ^ 1][i] = a_row[base + i];
        sb[cur ^ 1][i] = b_row[base + i];
      }
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, hard_stop);
      while (t < end) {
        const int32_t m = sb[cur][t - base];
        sum = sum * 31u + (uint32_t)sa[cur][t - base];
        ++n;
        const int adv = (m >> 6) & 255;
        if ((m & (1 << 14)) || adv == 0) {
          stop = 1;
          break;
        }
        t += adv;
      }
    }
    if (__syncthreads_or(threadIdx.x == 0 && (stop || t >= hard_stop)))
      break;
  }
  if (threadIdx.x == 0) {
    res[2 * s] = n;
    res[2 * s + 1] = (int32_t)sum;
  }
}

__global__ void __launch_bounds__(THREADS)
probe_lazy_chain(const int32_t* __restrict__ P, const int32_t* __restrict__ Q,
                 const int32_t* __restrict__ npos_arr,
                 int32_t* __restrict__ res, int NP, int wmask, int minp,
                 int lit_limit) {
  __shared__ int32_t sp[2][TILE];
  __shared__ int32_t sq[2][TILE];
  const int s = blockIdx.x;
  const int npos = npos_arr[s];
  const int hard_stop = min(npos - 15, NP);
  const int32_t* p_row = P + (size_t)s * NP;
  const int32_t* q_row = Q + (size_t)s * NP;
  const int n_tiles = hard_stop > 0 ? (hard_stop + TILE - 1) / TILE : 0;
  if (n_tiles > 0) {
    for (int i = threadIdx.x; i < TILE && i < NP; i += THREADS) {
      sp[0][i] = p_row[i];
      sq[0][i] = q_row[i];
    }
  }
  __syncthreads();
  int t = 0, n = 0, cached = 0, csz = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NP;
           i += THREADS - 32) {
        sp[cur ^ 1][i] = p_row[base + i];
        sq[cur ^ 1][i] = q_row[base + i];
      }
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, hard_stop);
      while (t < end) {
        const int32_t p = sp[cur][t - base];
        const int32_t q = sq[cur][t - base];
        const int size = cached ? csz : p >> 23;
        const int pix = q & 0x7FFF, psz = q >> 15, tau = t & wmask;
        const bool go_lazy = size >= minp && size <= 8 && psz > size &&
                             !(pix <= tau && tau < pix + psz);
        const bool is_match = size >= minp && !go_lazy;
        cached = go_lazy;
        csz = psz;
        ++n;
        if (!is_match && (p & 0xFF) >= lit_limit) {
          t = npos;
          break;
        }
        t += is_match ? size : 1;
      }
    }
    if (__syncthreads_or(threadIdx.x == 0 && t >= hard_stop)) break;
  }
  if (threadIdx.x == 0) {
    res[2 * s] = n;
    res[2 * s + 1] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
probe_greedy_chain(const int32_t* __restrict__ pk,
                   const int32_t* __restrict__ pp,
                   const int32_t* __restrict__ npos_arr,
                   int32_t* __restrict__ res, int NP, int wmask, int minp,
                   int lazy) {
  __shared__ int32_t sk[2][TILE];
  __shared__ int32_t sq[2][TILE];
  const int s = blockIdx.x;
  const int hard_stop = min(npos_arr[s] - 15, NP);
  const int32_t* k_row = pk + (size_t)s * NP;
  const int32_t* q_row = pp + (size_t)s * NP;
  const int n_tiles = hard_stop > 0 ? (hard_stop + TILE - 1) / TILE : 0;
  if (n_tiles > 0) {
    for (int i = threadIdx.x; i < TILE && i < NP; i += THREADS) {
      sk[0][i] = k_row[i];
      if (lazy) sq[0][i] = q_row[i];
    }
  }
  __syncthreads();
  int t = 0, n = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NP;
           i += THREADS - 32) {
        sk[cur ^ 1][i] = k_row[base + i];
        if (lazy) sq[cur ^ 1][i] = q_row[base + i];
      }
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, hard_stop);
      while (t < end) {
        const int32_t p = sk[cur][t - base];
        const int ln = (p >> 15) & 31, run = (p >> 20) & 255;
        const bool matchy = ln >= minp;
        const bool rle_go = run >= 2 && !(run <= 6 && ln > run);
        bool go_lazy = false;
        if (lazy) {
          const int32_t q = sq[cur][t - base];
          const int pix = q & 0x7FFF, psz = (q >> 15) & 15, tau = t & wmask;
          go_lazy = matchy && ln <= 8 && psz > ln && !rle_go &&
                    !(pix <= tau && tau < pix + psz);
        }
        ++n;
        t += rle_go ? min(run, 241) : ((matchy && !go_lazy) ? ln : 1);
      }
    }
    if (__syncthreads_or(threadIdx.x == 0 && t >= hard_stop)) break;
  }
  if (threadIdx.x == 0) {
    res[2 * s] = n;
    res[2 * s + 1] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
probe_chase_chain(const int32_t* __restrict__ nxt, int32_t* __restrict__ res,
                  int NBP) {
  __shared__ int32_t tiles[2][TILE];
  const int s = blockIdx.x;
  const int32_t* row = nxt + (size_t)s * NBP;
  const int n_tiles = (NBP + TILE - 1) / TILE;
  for (int i = threadIdx.x; i < TILE && i < NBP; i += THREADS)
    tiles[0][i] = row[i];
  __syncthreads();
  int c = 0, n = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NBP;
           i += THREADS - 32)
        tiles[cur ^ 1][i] = row[base + i];
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, NBP);
      while (c < end) {
        const int h = tiles[cur][c - base];
        if (h >= NBP || h <= c) {
          c = -c - 1;  // stopped at c
          break;
        }
        ++n;
        c = h;
      }
    }
    if (__syncthreads_or(threadIdx.x == 0 && c < 0)) break;
  }
  if (threadIdx.x == 0) {
    res[2 * s] = n;
    res[2 * s + 1] = c < 0 ? -c - 1 : c;
  }
}

__global__ void __launch_bounds__(THREADS)
probe_trunc_chain(const int32_t* __restrict__ seg,
                  const int32_t* __restrict__ s_c,
                  const int32_t* __restrict__ w_c,
                  const int32_t* __restrict__ n_tr,
                  int32_t* __restrict__ defs, int T_max, int W) {
  __shared__ int32_t rows[3][TILE];
  const size_t off = (size_t)blockIdx.x * T_max;
  const int n = n_tr[blockIdx.x];
  int D = 0, cur = 0;  // thread 0's
  for (int base = 0; base < n; base += TILE) {
    const int m = min(TILE, n - base);
    for (int i = threadIdx.x; i < m; i += THREADS) {
      rows[0][i] = seg[off + base + i];
      rows[1][i] = s_c[off + base + i];
      rows[2][i] = w_c[off + base + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < m; ++i) {
        const int sg = rows[0][i];
        if (sg != cur) D = 0;
        const int d = max(0, rows[2][i] - (W - ((rows[1][i] - D) & (W - 1))));
        D += d;
        cur = sg;
        rows[2][i] = d;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += THREADS)
      defs[off + base + i] = rows[2][i];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
probe_read_plane(const int4* __restrict__ p, size_t n4,
                 int32_t* __restrict__ res) {
  int32_t x = 0;
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * THREADS) {
    const int4 v = p[i];
    x ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, o);
  if ((threadIdx.x & 31) == 0) atomicXor(res + blockIdx.x, x);
}

constexpr int TB5 = 256;  // B5's first port: positions (threads) a block

template <int kMode>
__global__ void __launch_bounds__(TB5)
probe_tables(const uint8_t* __restrict__ row0,
             const int32_t* __restrict__ npos, const uint8_t* __restrict__ dict,
             int32_t* __restrict__ len_m, int32_t* __restrict__ idx_m,
             int32_t* __restrict__ len_p, int32_t* __restrict__ idx_p,
             unsigned long long* __restrict__ counts, int MP, int wbits,
             int probe, int lrun) {
  extern __shared__ uint8_t slab[];
  const int W = 1 << wbits;
  const int s = blockIdx.y;
  const int t0 = blockIdx.x * TB5;
  const int slab_len = TB5 + W + lrun;
  const uint8_t* row = row0 + (size_t)s * MP;
  for (int i = threadIdx.x; i < slab_len; i += TB5) {
    const int c = t0 + i;
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
  const int head = tl + W;
  const int tau = t & (W - 1);
  const int left = t < MP ? npos[s] - t : 0;
  int best_m = W - 1, best_p = W - 1;
  unsigned long long n1 = 0, n2 = 0, n16 = 0, past = 0;
  if (kMode == 0) {
    best_m = slab[head];
    best_p = slab[tl];
  } else if (left > 0) {
    const uint8_t c0 = slab[head], c1 = slab[head + 1];
    for (int j = 0; j < W; ++j) {
      const uint8_t v = slab[tl + j];
      const int sc = (1 << wbits) + (W - 1 - ((tau + j) & (W - 1)));
      if (v == c0) {
        best_m = sc > best_m ? sc : best_m;
        if (kMode == 2) {
          ++n1;
          int src = j == W - 1 ? tl : tl + j + 1;
          if (slab[src] == c1) {
            ++n2;
            const int l = min(min(left, lrun), W - ((tau + j) & (W - 1)));
            int k = 2;
            if (++src == head) src = tl;
            while (k < l && slab[src] == slab[head + k]) {
              ++k;
              if (++src == head) src = tl;
            }
            if (k >= 16) {
              ++n16;
              past += k - 16;
            }
          }
        }
      }
      if (probe && left > 1 && v == c1) best_p = sc > best_p ? sc : best_p;
    }
  }
  if (kMode == 2) {
    for (int o = 16; o > 0; o >>= 1) {
      n1 += __shfl_xor_sync(0xFFFFFFFFu, n1, o);
      n2 += __shfl_xor_sync(0xFFFFFFFFu, n2, o);
      n16 += __shfl_xor_sync(0xFFFFFFFFu, n16, o);
      past += __shfl_xor_sync(0xFFFFFFFFu, past, o);
    }
    if ((tl & 31) == 0) {
      atomicAdd(counts, n1);
      atomicAdd(counts + 1, n2);
      atomicAdd(counts + 2, n16);
      atomicAdd(counts + 3, past);
    }
  }
  if (t >= MP) return;
  const size_t o = (size_t)s * MP + t;
  len_m[o] = best_m >> wbits;
  idx_m[o] = (W - 1) - (best_m & (W - 1));
  if (probe) {
    len_p[o] = best_p >> wbits;
    idx_p[o] = (W - 1) - (best_p & (W - 1));
  }
}

}  // namespace

extern "C" int tpt_probe_lazy_chain(const void* P, const void* Q,
                                    const void* npos, void* res, int S,
                                    int NP, int window, int literal, int minp,
                                    void* stream) {
  probe_lazy_chain<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)P, (const int32_t*)Q, (const int32_t*)npos,
      (int32_t*)res, NP, (1 << window) - 1, minp,
      literal == 8 ? 256 : 1 << literal);
  return (int)cudaGetLastError();
}

extern "C" int tpt_probe_greedy_chain(const void* pk, const void* pp,
                                      const void* npos, void* res, int S,
                                      int NP, int window, int minp, int lazy,
                                      void* stream) {
  probe_greedy_chain<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pk, (const int32_t*)pp, (const int32_t*)npos,
      (int32_t*)res, NP, (1 << window) - 1, minp, lazy);
  return (int)cudaGetLastError();
}

extern "C" int tpt_probe_decode_chain(const void* pk, void* res, int S,
                                      int NBP, void* stream) {
  probe_decode_chain<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pk, (int32_t*)res, NBP);
  return (int)cudaGetLastError();
}

extern "C" int tpt_probe_fields_chain(const void* A, const void* B,
                                      const void* npos, void* res, int S,
                                      int NP, void* stream) {
  probe_fields_chain<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)A, (const int32_t*)B, (const int32_t*)npos,
      (int32_t*)res, NP);
  return (int)cudaGetLastError();
}

extern "C" int tpt_probe_chase_chain(const void* nxt, void* res, int S,
                                     int NBP, void* stream) {
  probe_chase_chain<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nxt, (int32_t*)res, NBP);
  return (int)cudaGetLastError();
}

// defs (S, T_max) zeroed by the caller
extern "C" int tpt_probe_trunc_chain(const void* seg, const void* s_c,
                                     const void* w_c, const void* n_tr,
                                     void* defs, int S, int T_max, int W,
                                     void* stream) {
  probe_trunc_chain<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)seg, (const int32_t*)s_c, (const int32_t*)w_c,
      (const int32_t*)n_tr, (int32_t*)defs, T_max, W);
  return (int)cudaGetLastError();
}

// res: `blocks` zeroed int32 words; n_words a multiple of 4
extern "C" int tpt_probe_read_plane(const void* p, void* res, int n_words,
                                    int blocks, void* stream) {
  probe_read_plane<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)p, (size_t)n_words / 4, (int32_t*)res);
  return (int)cudaGetLastError();
}

extern "C" int tpt_probe_tables(const void* data, const void* npos,
                                const void* dict, void* len_m, void* idx_m,
                                void* len_p, void* idx_p, void* counts, int S,
                                int MP, int wbits, int probe, int mode,
                                int lrun, void* stream) {
  const size_t smem = (size_t)TB5 + (1 << wbits) + lrun;
  auto kern = probe_tables<0>;
  if (mode == 1) kern = probe_tables<1>;
  if (mode == 2) kern = probe_tables<2>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((MP + TB5 - 1) / TB5, S);
  kern<<<grid, TB5, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)npos, (const uint8_t*)dict,
      (int32_t*)len_m, (int32_t*)idx_m, (int32_t*)len_p, (int32_t*)idx_p,
      (unsigned long long*)counts, MP, wbits, probe, lrun);
  return (int)cudaGetLastError();
}
