// Kernel X5: the speculative per-bit parse of the wavefront decode.
//
// Replaces the XLA ops of tamp_tpu/ops/decode_wavefront.py::_speculative_parse
// (the JAX package has no Pallas kernel there) and, in the port, the tensor
// ops of ops/decode_wavefront.speculative_parse (its plain version) and, in
// the fused form, ops/decode_commit.fuse_parse.  For every bit offset b of
// every payload, the token that would start at b: kind, count, index and
// the next token's bit offset nxt, NBP where the token is incomplete (it
// ends past nb_valid bits, a FLUSH whose code ends past them, or b at or
// past them).  Two output forms, one parse:
//   - fused (B4's input): pk[b] = kind | cnt << 3 | delta << 11 | idx << 17,
//     delta = 0 where nxt >= NBP, else min(nxt - b, 63); idx << 17 wraps
//     into the sign bit at window 15, as fuse_parse's int32 word does;
//   - pair (the chase and xla modes): nxt[b], and
//     packed[b] = kind | cnt << 3 | idx << 11.
//
// What bounds it on this card: bytes.  A payload byte read yields 32 bytes
// written (fused) or 64 (pair), so the writes set the pace: 268 MB for 8
// payloads of a 1 MiB bucket, ~0.08 ms at 3.35 TB/s.  The tensor ops ran
// about a hundred full-plane passes over int64 temporaries of 537 MB each
// there (~88 ms on an H100, ~232 B of device memory a bucket bit).
//
// Design: one thread a payload byte, so its eight bit offsets share one
// load.  A block's 256 bytes and the 16 after them are staged in shared
// memory with 16-byte loads (the caller pads each row with at least 8 zero
// bytes and makes its stride a multiple of 16).  A thread builds, for each
// bit phase r, the 64-bit big-endian window of bits [8i + r, 8i + r + 64);
// the longest token is 36 bits, so every field is a shift of that window.
// The two Huffman symbols come from a 256-entry (symbol | length << 4)
// table in shared memory indexed by the 8-bit peek (the wrapper builds it
// from the same loop as the plain version's _decode_symbol).  The rules are
// the plain version's, quirks included: a literal whose peek decodes as
// FLUSH is judged incomplete by the FLUSH rule.  Each thread's eight words
// go out in two 16-byte stores a plane, so a warp writes 1 KiB of a plane
// contiguously.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exit_maps.cuh"

namespace {

constexpr int THREADS = 256;  // payload bytes a block, one a table entry
constexpr int TILE = THREADS + 16;
constexpr int K_LIT = 0, K_MATCH = 1, K_RLE = 2, K_EXT = 3, K_FLUSH = 4;
constexpr int RLE_SYMBOL = 12, EXTENDED_MATCH_SYMBOL = 13, FLUSH_SYMBOL = 14;
constexpr int RLE_TRAILING_BITS = 4, EXTENDED_MATCH_TRAILING_BITS = 3;

static_assert(THREADS == 256, "each thread stages one symbol table entry");

struct Config {
  int window, literal, minp, extended;
};

// m (1..16) bits at bit k (0..32) of the big-endian window w
__device__ __forceinline__ int field(uint64_t w, int k, int m) {
  return (int)((w << k) >> (64 - m));
}

// The token that would start at bit b, whose window is w.
__device__ __forceinline__ void parse_bit(uint64_t w, int b, int nbv,
                                          int NBP, const Config& c,
                                          const uint8_t* sym, int& nxt,
                                          int& kind, int& cnt, int& idx) {
  const int t1 = sym[field(w, 1, 8)];
  const int s1 = t1 & 15, k1 = 1 + (t1 >> 4);
  const int t2 = sym[field(w, k1, 8)];
  const int s2 = t2 & 15, k2 = k1 + (t2 >> 4);
  const bool is_flush = s1 == FLUSH_SYMBOL;
  int end;
  if (w >> 63) {
    kind = K_LIT;
    end = b + 1 + c.literal;
    cnt = 1;
    idx = field(w, 1, c.literal);
  } else if (is_flush) {
    kind = K_FLUSH;
    end = (b + k1 + 7) & ~7;  // byte-align discard
    cnt = 0;
    idx = field(w, k1, c.window);  // as the JAX parse
  } else if (c.extended && s1 == RLE_SYMBOL) {
    kind = K_RLE;
    end = b + k2 + RLE_TRAILING_BITS;
    cnt = (s2 << RLE_TRAILING_BITS) + field(w, k2, RLE_TRAILING_BITS) + 2;
    idx = 0;
  } else if (c.extended && s1 == EXTENDED_MATCH_SYMBOL) {
    kind = K_EXT;
    end = b + k2 + EXTENDED_MATCH_TRAILING_BITS + c.window;
    cnt = (s2 << EXTENDED_MATCH_TRAILING_BITS)
          + field(w, k2, EXTENDED_MATCH_TRAILING_BITS) + c.minp + 12;
    idx = field(w, k2 + EXTENDED_MATCH_TRAILING_BITS, c.window);
  } else {
    kind = K_MATCH;
    end = b + k1 + c.window;
    cnt = s1 + c.minp;
    idx = field(w, k1, c.window);
  }
  const bool incomplete =
      (is_flush ? b + k1 > nbv : end > nbv) || b >= nbv;
  nxt = incomplete ? NBP : end;
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
parse_kernel(const uint8_t* __restrict__ blob,
             const int32_t* __restrict__ nbytes,
             const uint8_t* __restrict__ sym_g, int32_t* __restrict__ out0,
             int32_t* __restrict__ out1, int L, int row, Config c) {
  __shared__ __align__(16) uint8_t tile[TILE];
  __shared__ uint8_t sym[256];
  const ShardBlock sb = shard_block((L + THREADS - 1) / THREADS);
  const int s = sb.s, i0 = sb.b * THREADS;
  const uint8_t* src = blob + (size_t)s * row + i0;
  // row is a multiple of 16, so a 16-byte chunk lies in the row or past it
  if (threadIdx.x < TILE / 16 && i0 + 16 * (int)threadIdx.x < row)
    reinterpret_cast<uint4*>(tile)[threadIdx.x] =
        reinterpret_cast<const uint4*>(src)[threadIdx.x];
  sym[threadIdx.x] = sym_g[threadIdx.x];
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= L) return;
  const uint8_t* t = tile + threadIdx.x;
  uint64_t hi = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) hi = hi << 8 | t[k];
  const uint32_t next = t[8];
  const int NBP = 8 * L, nbv = 8 * nbytes[s];
  uint32_t a[8], p[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint64_t w = r ? hi << r | next >> (8 - r) : hi;
    const int b = 8 * i + r;
    int nxt, kind, cnt, idx;
    parse_bit(w, b, nbv, NBP, c, sym, nxt, kind, cnt, idx);
    if (FUSED) {
      const uint32_t delta = nxt >= NBP ? 0u : (uint32_t)min(nxt - b, 63);
      a[r] = (uint32_t)kind | (uint32_t)cnt << 3 | delta << 11
             | (uint32_t)idx << 17;
    } else {
      a[r] = (uint32_t)nxt;
      p[r] = (uint32_t)kind | (uint32_t)cnt << 3 | (uint32_t)idx << 11;
    }
  }
  const size_t o = (size_t)s * NBP + 8 * (size_t)i;
  uint4* d0 = reinterpret_cast<uint4*>(out0 + o);
  d0[0] = make_uint4(a[0], a[1], a[2], a[3]);
  d0[1] = make_uint4(a[4], a[5], a[6], a[7]);
  if (!FUSED) {
    uint4* d1 = reinterpret_cast<uint4*>(out1 + o);
    d1[0] = make_uint4(p[0], p[1], p[2], p[3]);
    d1[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

}  // namespace

// blob (S, row) uint8: payload bytes, row >= L + 8 a multiple of 16, zero
// past each payload; nbytes (S,) int32; sym (256,) uint8 the symbol table;
// out0 (S, 8L) int32 the fused words (fused) or nxt, out1 (S, 8L) int32
// packed (pair form; null when fused); 16-byte aligned.
extern "C" int tpt_parse_words(const void* blob, const void* nbytes,
                               const void* sym, void* out0, void* out1, int S,
                               int L, int row, int window, int literal,
                               int minp, int extended, int fused,
                               void* stream) {
  if (L <= 0 || row < L + 8 || row % 16 || (!fused && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Config c{window, literal, minp, extended};
  return (int)launch_shards(fused ? parse_kernel<true> : parse_kernel<false>,
                            S, (L + THREADS - 1) / THREADS, THREADS, 0,
                            (cudaStream_t)stream, blob, nbytes, sym, out0,
                            fused ? nullptr : out1, L, row, c);
}
