// Kernel B4: decode commit of parsed Tamp streams.
//
// Replaces the TPU kernel tamp_tpu/ops/decode_commit_pallas.py::_kernel (via
// commit_decode_batch), in its separate-ring form for every stream.  Per
// shard, a serial walk over the per-bit parse words
// pk[b] = kind(3) | cnt(8) << 3 | delta(6) << 11 | idx << 17 (delta = the
// token's bit length, 0 for a trailing incomplete token), from bit 0, that
// commits each token against a W-byte window ring:
//   - literal: one byte to the output and the ring;
//   - match: cnt bytes read from ring[idx ..] before the token writes
//     anything (snapshot), all written to the output and the ring with wrap;
//   - extended match: as a match, but the ring write stops at the ring end;
//   - RLE: cnt copies of the byte behind the head to the output, at most 8
//     to the ring, never wrapping;
//   - FLUSH: nothing; a second FLUSH in a row on a `more` stream resets the
//     ring to dict_reset and the head to 0.
// Errors end the walk: ERR_OOB (a match reads past the window), ERR_OVERFLOW
// (the output would pass max_out; checked after OOB and wins over it).  The
// output past out_len stays zero (the wrapper zero-fills it).
//
// What bounds it on this card: the dependence chain of the walk (each token
// start comes from the previous token's length, each byte may read one just
// written), not bytes: one thread walks a shard, so the kernel uses S SMs.
//
// Design: one block per shard; the ring lives in shared memory (up to
// 32 KiB, so every window uses this kernel).  Warp 0's lane 0 walks; warps
// 1..7 stage the next tile of parse words into the other half of a double
// buffer while the walker consumes the current one.  Output bytes go
// straight to the shard's output row.  The TPU kernel's unified
// output-as-ring mode and SMEM output chunks answer the TPU's SMEM size and
// DMA rules and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;  // parse words per staged tile
constexpr int ERR_OOB = 2, ERR_OVERFLOW = 3;
constexpr int K_LIT = 0, K_MATCH = 1, K_RLE = 2, K_EXT = 3, K_FLUSH = 4;

__global__ void __launch_bounds__(THREADS)
commit_decode_kernel(const int32_t* __restrict__ pk,
                     const uint8_t* __restrict__ dict_init,
                     const uint8_t* __restrict__ dict_reset,
                     uint8_t* __restrict__ out, int32_t* __restrict__ lens,
                     int32_t* __restrict__ errs, int NBP, int wbits,
                     int more, int max_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W = 1 << wbits;
  int32_t* tiles = reinterpret_cast<int32_t*>(smem);  // [2][TILE]
  uint8_t* tmp = smem + 2 * TILE * sizeof(int32_t);   // 256 bytes
  uint8_t* ring = tmp + 256;                          // W bytes
  const int s = blockIdx.x;
  const int32_t* row = pk + (size_t)s * NBP;
  uint8_t* o_row = out + (size_t)s * max_out;
  const int n_tiles = (NBP + TILE - 1) / TILE;

  for (int i = threadIdx.x; i < W; i += THREADS) ring[i] = dict_init[i];
  for (int i = threadIdx.x; i < TILE && i < NBP; i += THREADS)
    tiles[i] = row[i];
  __syncthreads();

  // walker state (meaningful in thread 0 only)
  int c = 0, out_pos = 0, pos = 0, lwf = 0, err = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      int32_t* dst = tiles + (cur ^ 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NBP;
           i += THREADS - 32)
        dst[i] = row[base + i];
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int32_t* src = tiles + cur * TILE;
      const int end = min(base + TILE, NBP);
      while (c < end) {
        const int32_t p = src[c - base];
        const int kind = p & 7;
        const int cnt = (p >> 3) & 0xFF;
        const int delta = (p >> 11) & 63;
        const int idx = (p >> 17) & (W - 1);
        if (delta == 0) {  // trailing incomplete token: drop and stop
          c = NBP;
          break;
        }
        const bool is_m = kind == K_MATCH || kind == K_EXT;
        if (is_m && idx + cnt > W) err = ERR_OOB;
        if (kind != K_FLUSH && out_pos + cnt > max_out) err = ERR_OVERFLOW;
        if (err != 0) {
          c = NBP;
          break;
        }
        if (kind == K_FLUSH) {
          if (more && lwf) {  // double FLUSH: reset the window in place
            for (int i = 0; i < W; ++i) ring[i] = dict_reset[i];
            pos = 0;
          }
          lwf = 1;
          c += delta;
          continue;
        }
        lwf = 0;
        int wr;
        if (kind == K_LIT) {
          o_row[out_pos] = (uint8_t)idx;
          ring[pos] = (uint8_t)idx;
          wr = 1;
        } else if (kind == K_RLE) {
          const uint8_t b = ring[pos == 0 ? W - 1 : pos - 1];
          for (int j = 0; j < cnt; ++j) o_row[out_pos + j] = b;
          wr = min(min(cnt, 8), W - pos);
          for (int j = 0; j < wr; ++j) ring[pos + j] = b;
        } else {
          for (int j = 0; j < cnt; ++j) tmp[j] = ring[idx + j];
          for (int j = 0; j < cnt; ++j) o_row[out_pos + j] = tmp[j];
          wr = kind == K_EXT ? min(cnt, W - pos) : cnt;
          for (int j = 0; j < wr; ++j) ring[(pos + j) & (W - 1)] = tmp[j];
        }
        pos = (pos + wr) & (W - 1);
        out_pos += cnt;
        c += delta;
      }
    }
    // barrier (the next tile is staged) and the walker's verdict in one
    if (__syncthreads_or(threadIdx.x == 0 && c >= NBP)) break;
  }
  if (threadIdx.x == 0) {
    lens[s] = out_pos;
    errs[s] = err;
  }
}

}  // namespace

extern "C" int tpt_commit_decode(const void* pk, const void* dict_init,
                                 const void* dict_reset, void* out,
                                 void* lens, void* errs, int S, int NBP,
                                 int wbits, int more, int max_out,
                                 void* stream) {
  const size_t smem = 2 * TILE * sizeof(int32_t) + 256 + ((size_t)1 << wbits);
  cudaError_t e = cudaFuncSetAttribute(
      commit_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  commit_decode_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pk, (const uint8_t*)dict_init,
      (const uint8_t*)dict_reset, (uint8_t*)out, (int32_t*)lens,
      (int32_t*)errs, NBP, wbits, more, max_out);
  return (int)cudaGetLastError();
}
