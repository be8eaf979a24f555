// Kernel X2: token-serial decode of Tamp payloads, one thread per shard.
//
// Replaces the vmapped token-serial lax.while_loop of
// tamp_tpu/ops/decode_jax.py::_decode_batch (algorithm="serial").  Per
// shard, from the payload's first bit (the host strips the header):
//   - a 64-bit accumulator refilled byte by byte; a token that the
//     remaining bits cannot complete ends the decode with no error (it is
//     dropped, as the reference decoders roll it back);
//   - literal: flag 1 + `literal` bits, to the output and the ring;
//   - flag 0 + Huffman symbol s1 (an 8-bit peek, zero-padded at the tail):
//     FLUSH drops bits % 8 (aligns the stream to a byte) and, on a `more`
//     stream, a second FLUSH in a row resets the ring to dict_reset and the
//     head to 0; in the extended format s1 = 12 is RLE (symbol s2, 4 trail
//     bits: count s2 << 4 + trail + 2 copies of the byte behind the head, at
//     most 8 of them to the ring, never wrapping) and s1 = 13 an extended
//     match (s2, 3 trail bits, window bits: size s2 << 3 + trail + minp + 12
//     at idx, the ring write stops at the ring end); otherwise a match of
//     s1 + minp bytes at the next window bits, written to the ring with
//     wrap.  A match's source bytes are read before it writes any.
//   - a match reading past the window is ERR_OOB and ends the decode;
//   - the decode stops before a token once max_out bytes are out (no
//     error; the output is cut at max_out).
// Output: bytes (S, max_out) (the wrapper zero-fills), lengths (<= max_out)
// and error codes (S,).
//
// What bounds it on this card: the dependence chain of the decode (each
// token's position comes from the previous token's length, each byte may
// read one just written), not bytes: one thread decodes a shard, so the
// kernel uses S SMs.
//
// Design: one block per shard; the ring (up to 32 KiB) and a 256-byte
// match snapshot live in shared memory, loaded by all threads, then thread
// 0 decodes.  The payload is read through the L1 cache a byte at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ERR_OOB = 2;
constexpr int FLUSH_SYM = 14, RLE_SYM = 12, EXT_SYM = 13;

// Huffman codes (flag bit excluded) and their lengths, symbols 0..14.
__constant__ uint8_t HCODE[15] = {0x00, 0x03, 0x08, 0x0B, 0x14, 0x24, 0x26,
                                  0x2B, 0x4B, 0x54, 0x94, 0x95, 0xAA, 0x27,
                                  0xAB};
__constant__ uint8_t HLEN[15] = {1, 2, 4, 4, 5, 6, 6, 6, 7, 7, 8, 8, 8, 6, 8};

// Symbol and code length of an 8-bit peek (the code is complete: exactly
// one codeword prefixes any peek).
__device__ __forceinline__ void decode_symbol(int pk, int* sym, int* len) {
  for (int s = 0; s < 15; ++s) {
    const int nb = HLEN[s];
    if ((pk >> (8 - nb)) == HCODE[s]) {
      *sym = s;
      *len = nb;
      return;
    }
  }
  *sym = 0;  // unreachable
  *len = 8;
}

__global__ void __launch_bounds__(THREADS)
serial_decode_kernel(const uint8_t* __restrict__ in,
                     const int32_t* __restrict__ nbytes, int Lp,
                     const uint8_t* __restrict__ dict_init,
                     const uint8_t* __restrict__ dict_reset,
                     uint8_t* __restrict__ out, int32_t* __restrict__ lens,
                     int32_t* __restrict__ errs, int wbits, int literal,
                     int extended, int more, int minp, int max_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W = 1 << wbits;
  const int wmask = W - 1;
  uint8_t* tmp = smem;        // 256 bytes
  uint8_t* ring = smem + 256;  // W bytes
  const int s = blockIdx.x;
  for (int i = threadIdx.x; i < W; i += THREADS) ring[i] = dict_init[i];
  __syncthreads();
  if (threadIdx.x != 0) return;

  const uint8_t* src = in + (size_t)s * Lp;
  uint8_t* o_row = out + (size_t)s * max_out;
  const int n = nbytes[s];
  uint64_t acc = 0;
  int bits = 0, ip = 0, o = 0, pos = 0, lwf = 0, err = 0;
  auto field = [&](int from, int nb) -> int {  // nb bits below `from`
    return (int)((acc >> (from - nb)) & ((1u << nb) - 1));
  };
  auto peek8 = [&](int from) -> int {  // 8 bits below `from`, zero-padded
    return from >= 8 ? (int)((acc >> (from - 8)) & 0xFF)
                     : (int)((acc << (8 - from)) & 0xFF);
  };
  while (o < max_out) {
    while (bits <= 56 && ip < n) {
      acc = (acc << 8) | __ldg(src + ip);
      ++ip;
      bits += 8;
    }
    if (bits < 1) break;
    if (field(bits, 1)) {  // literal
      if (bits < 1 + literal) break;
      const uint8_t v = (uint8_t)field(bits - 1, literal);
      bits -= 1 + literal;
      o_row[o++] = v;
      ring[pos] = v;
      pos = (pos + 1) & wmask;
      lwf = 0;
      continue;
    }
    const int b1 = bits - 1;
    if (b1 < 1) break;
    int s1, l1;
    decode_symbol(peek8(b1), &s1, &l1);
    if (l1 > b1) break;
    const int b2 = b1 - l1;
    if (s1 == FLUSH_SYM) {
      bits = b2 - (b2 & 7);
      if (more && lwf) {
        for (int i = 0; i < W; ++i) ring[i] = dict_reset[i];
        pos = 0;
      }
      lwf = 1;
      continue;
    }
    int cnt, idx = 0, kind;  // kind: 0 match, 1 RLE, 2 extended match
    if (extended && (s1 == RLE_SYM || s1 == EXT_SYM)) {
      if (b2 < 1) break;
      int s2, l2;
      decode_symbol(peek8(b2), &s2, &l2);
      if (l2 > b2) break;
      const int b3 = b2 - l2;
      if (s1 == RLE_SYM) {
        if (b3 < 4) break;
        cnt = (s2 << 4) + field(b3, 4) + 2;
        bits = b3 - 4;
        kind = 1;
      } else {
        if (b3 < 3 + wbits) break;
        cnt = (s2 << 3) + field(b3, 3) + minp + 12;
        idx = field(b3 - 3, wbits);
        bits = b3 - 3 - wbits;
        kind = 2;
      }
    } else {
      if (b2 < wbits) break;
      cnt = s1 + minp;
      idx = field(b2, wbits);
      bits = b2 - wbits;
      kind = 0;
    }
    if (kind != 1 && idx + cnt > W) {
      err = ERR_OOB;
      break;
    }
    lwf = 0;
    const int n_out = min(cnt, max_out - o);
    int wr;
    if (kind == 1) {
      const uint8_t b = ring[(pos - 1) & wmask];
      for (int j = 0; j < n_out; ++j) o_row[o + j] = b;
      wr = min(min(cnt, 8), W - pos);
      for (int j = 0; j < wr; ++j) ring[pos + j] = b;
    } else {
      for (int j = 0; j < cnt; ++j) tmp[j] = ring[idx + j];
      for (int j = 0; j < n_out; ++j) o_row[o + j] = tmp[j];
      wr = kind == 2 ? min(cnt, W - pos) : cnt;
      for (int j = 0; j < wr; ++j) ring[(pos + j) & wmask] = tmp[j];
    }
    pos = (pos + wr) & wmask;
    o += cnt;
  }
  lens[s] = min(o, max_out);
  errs[s] = err;
}

}  // namespace

extern "C" int tpt_serial_decode(const void* in, const void* nbytes,
                                 const void* dict_init,
                                 const void* dict_reset, void* out,
                                 void* lens, void* errs, int S, int Lp,
                                 int wbits, int literal, int extended,
                                 int more, int minp, int max_out,
                                 void* stream) {
  const size_t smem = 256 + ((size_t)1 << wbits);
  cudaError_t e = cudaFuncSetAttribute(
      serial_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  serial_decode_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const int32_t*)nbytes, Lp,
      (const uint8_t*)dict_init, (const uint8_t*)dict_reset, (uint8_t*)out,
      (int32_t*)lens, (int32_t*)errs, wbits, literal, extended, more, minp,
      max_out);
  return (int)cudaGetLastError();
}
