// Streaming Tamp handles: incremental compress and decompress on the host.
//
// A copy of the native engine's streaming handles (the JAX package's
// tamp_tpu/_native/tampnative.cpp: StreamComp and StreamDecomp, the
// tampn_comp_* and tampn_dec_* entries and their set_callback entries),
// renamed tpt_stream_*, kept here so the port builds and links nothing of
// tamp_tpu.  The compressor runs the Committer of greedy_commit.cpp (the
// reference encoder's greedy walk, table-less, extended or v1) over a
// growing input buffer; the decompressor is the native token decoder with
// token-atomic resume.  The reference's contract (tamp/_c_src/tamp/
// compressor.h tamp_compressor_*, decompressor.h): write / flush /
// reset_dictionary; chunked feed / read; append mode.
//
// Progress callback (the reference's tamp_callback_t,
// tamp/_c_src/tamp/common.h:184-210): fired at token boundaries, every 256
// tokens while compressing and every 1024 while decoding, with cumulative
// (bytes_in, bytes_out).  Return 0 to continue; any nonzero return stops
// the call in flight and becomes its return code (use |v| >= 100 to keep
// clear of the statuses 0, 1, -2 ... -5).  The state stays token-atomic
// across a stop, so the call may be issued again to resume.
//
// Host code by design, in both packages: a mid-stream flush pads to a byte
// and leaves a window state that no device encoder models, and a write of
// a few bytes is work a kernel launch could only slow.
//
// Build: c++ -O3 -std=c++17 -shared -fPIC (ops/_build.py); the build hash
// covers greedy_commit.cpp too.

#include "greedy_commit.cpp"

namespace {

const int FLUSH_SYM = 14;

// Huffman decode tables indexed by the next 8 bits (flag excluded):
// symbol (0xFF: none) and code length.
struct HuffTables {
  uint8_t sym[256], len[256];
  HuffTables() {
    std::memset(sym, 0xFF, 256);
    std::memset(len, 0, 256);
    for (int s = 0; s < 15; s++) {
      int nb = HUFF_BITS[s] - 1;
      uint32_t code = HUFF_CODE[s];
      for (uint32_t j = 0; j < (1u << (8 - nb)); j++) {
        sym[(code << (8 - nb)) | j] = (uint8_t)s;
        len[(code << (8 - nb)) | j] = (uint8_t)nb;
      }
    }
  }
};
const HuffTables HT;
const uint8_t* const SYM_TAB = HT.sym;
const uint8_t* const LEN_TAB = HT.len;

// The default dictionary: xorshift32 draws over a 16-character table (spec
// "Dictionary Initialization"; dictionary.py's dictionary_array).
void init_dictionary(uint8_t* buf, int64_t size, int literal) {
  static const uint8_t common[16] = {' ', 'e', 't', 'a', 'o', 'i', 'n', 's',
                                     'h', 'r', 'd', 'l', 'c', 'u', 'm', 'w'};
  static const uint8_t chars8[16] = {' ', 0, '0', 'e', 'i', '>', 't', 'o',
                                     '<', 'a', 'n', 's', '\n', 'r', '/', '.'};
  uint8_t chars[16];
  if (literal <= 6) {
    uint8_t mask = (uint8_t)((1u << literal) - 1);
    for (int i = 0; i < 16; i++) chars[i] = common[i] & mask;
  } else {
    std::memcpy(chars, chars8, 16);
  }
  uint32_t s = 3758097560u;
  int64_t words = size >> 3;
  uint8_t* p = buf;
  for (int64_t i = 0; i < words; i++) {
    s ^= s << 13; s ^= s >> 17; s ^= s << 5;
    uint32_t v = s;
    for (int k = 0; k < 8; k++) { *p++ = chars[v & 0xF]; v >>= 4; }
  }
  if ((size & 7) != 0) std::memset(buf + words * 8, 0, size & 7);
}

typedef int (*tpt_cb_t)(void* user, int64_t bytes_in, int64_t bytes_out);

struct StreamComp {
  Committer c;
  std::vector<uint8_t> buf;   // unconsumed + look-ahead input (c.data aims here)
  uint64_t acc = 0;           // bit-writer state kept between calls (< 8
  int bits = 0;               // bits, except for the queued header)
  bool last_was_flush = false;
  bool dictionary_reset = false;
  bool excess = false;
  tpt_cb_t cb = nullptr;      // optional progress/abort callback
  void* cb_user = nullptr;
  uint32_t cb_ctr = 0;
  int64_t in_total = 0;       // bytes ever accepted by write
  int64_t out_total = 0;      // bytes ever emitted

  void sync_data() {
    c.data = buf.data();
    c.N = (int64_t)buf.size();
  }
  void compact() {
    int64_t keep_from = c.t;
    if (c.rle_count && c.rle_start < keep_from) keep_from = c.rle_start;
    if (c.ext_count && c.ext_start < keep_from) keep_from = c.ext_start;
    if (keep_from > (1 << 20)) {
      buf.erase(buf.begin(), buf.begin() + keep_from);
      c.t -= keep_from;
      c.rle_start -= keep_from;  // only read while a run is held
      c.ext_start -= keep_from;
      sync_data();
    }
  }
  int poll_cb(int64_t out_now) {
    if (cb && ((++cb_ctr & 255u) == 0))
      return cb(cb_user, in_total - (c.N - c.t), out_total + out_now);
    return 0;
  }
  // Steps while a full look-ahead is pending (the reference emits tokens
  // only with its 16-byte input buffer full).
  int run_held(BitWriter& bw) {
    c.bw = &bw;
    sync_data();
    while (c.N - c.t >= LOOKAHEAD) {
      if (bw.n > bw.cap - 64) return 1;  // output nearly full
      c.step();
      if (c.excess_bits) { excess = true; return -2; }
      if (int rc = poll_cb(bw.n)) return rc;
    }
    compact();
    return 0;
  }
  int drain(BitWriter& bw) {  // consume everything (flush)
    c.bw = &bw;
    sync_data();
    while (true) {
      while (c.t < c.N) {
        if (bw.n > bw.cap - 64) return 1;
        c.step();
        if (c.excess_bits) { excess = true; return -2; }
        if (int rc = poll_cb(bw.n)) return rc;
      }
      if (c.extended && c.rle_count) c.emit_rle();
      if (c.extended && c.ext_count) c.emit_ext_match();
      if (c.excess_bits) { excess = true; return -2; }
      if (c.t >= c.N) break;
    }
    c.cached_idx = -1;
    buf.clear();
    c.t = 0;
    sync_data();
    return 0;
  }
};

void stream_comp_init_state(StreamComp* s, const uint8_t* dict) {
  Committer& c = s->c;
  c.ring.assign((size_t)c.W, 0);
  if (dict) std::memcpy(c.ring.data(), dict, (size_t)c.W);
  else init_dictionary(c.ring.data(), c.W, c.extended ? c.literal : 8);
  c.pos = 0;
  c.seed_chains();
  c.t = 0; c.rle_count = 0; c.ext_count = 0; c.ext_pos = 0;
  c.cached_idx = -1; c.excess_bits = false;
  s->buf.clear();
  c.data = nullptr; c.N = 0;
}

struct StreamDecomp {
  std::vector<uint8_t> ring;
  std::vector<uint8_t> inbuf;
  std::vector<uint8_t> dict;   // caller-supplied custom dictionary
  std::vector<uint8_t> spill;  // decoded bytes not yet handed to the caller
  size_t spill_off = 0;
  int64_t in_pos = 0;
  uint64_t acc = 0;
  int bits = 0;
  int W = 0, wmask = 0, pos = 0, window = 0, literal = 0, minp = 0;
  bool extended = false, more = false, custom = false;
  bool configured = false, have_first = false;
  bool last_was_flush = false, bad = false;
  uint8_t first_byte = 0;
  tpt_cb_t cb = nullptr;       // optional progress/abort callback
  void* cb_user = nullptr;
  uint32_t cb_ctr = 0;
  int64_t in_base = 0;         // input consumed before the current inbuf
  int64_t out_total = 0;       // bytes ever handed to the caller
};

}  // namespace

extern "C" {

// ---- streaming compressor --------------------------------------------------
// Statuses: 0 ok, 1 output full (call again with a fresh buffer), -2 excess
// bits, -5 invalid use; a callback's nonzero return as it is.

// dict: a custom window of 1 << window bytes, or null for the default one.
void* tpt_stream_comp_new(int window, int literal, int extended, int lazy,
                          const uint8_t* dict, int dictionary_reset,
                          int append) {
  auto* s = new StreamComp();
  Committer& c = s->c;
  c.W = 1 << window; c.wmask = c.W - 1; c.wbits = window; c.literal = literal;
  c.minp = min_pattern_size(window, literal);
  c.maxpat = extended ? c.minp + 131 : c.minp + 13;
  c.extended = extended != 0; c.lazy = lazy != 0;
  c.full_cap = (LOOKAHEAD < c.maxpat) ? LOOKAHEAD : c.maxpat;
  s->dictionary_reset = dictionary_reset != 0;
  stream_comp_init_state(s, dict);
  if (append) {
    // An append stream begins with a byte-aligned FLUSH instead of a
    // header; with the earlier stream's trailing FLUSH it forms the
    // double-FLUSH dictionary reset.
    s->acc = 0x0ABu << 7;  // 9-bit FLUSH code + zero pad
    s->bits = 16;
    s->last_was_flush = true;
  } else {
    uint32_t h = (uint32_t)(((window - 8) << 5) | ((literal - 5) << 3) |
                            ((dict ? 1 : 0) << 2) | ((extended ? 1 : 0) << 1) |
                            (dictionary_reset ? 1 : 0));
    s->acc = h;
    s->bits = 8;
    if (dictionary_reset) {  // reserved second header byte
      s->acc <<= 8;
      s->bits = 16;
    }
  }
  return s;
}

void tpt_stream_comp_free(void* h) { delete (StreamComp*)h; }

int tpt_stream_comp_write(void* h, const uint8_t* in, int64_t in_len,
                          uint8_t* out, int64_t out_cap, int64_t* written) {
  auto* s = (StreamComp*)h;
  *written = 0;
  if (s->excess) return -2;
  if (in_len > 0) {
    s->buf.insert(s->buf.end(), in, in + in_len);
    s->in_total += in_len;
  }
  BitWriter bw(out, out_cap);
  bw.acc = s->acc; bw.bits = s->bits;
  int64_t emitted_before = bw.bits;
  int rc = s->run_held(bw);
  if (bw.n * 8 + bw.bits != emitted_before) s->last_was_flush = false;
  s->acc = bw.acc; s->bits = bw.bits;
  *written = bw.n;
  s->out_total += bw.n;
  return rc;
}

int tpt_stream_comp_flush(void* h, int write_token, uint8_t* out,
                          int64_t out_cap, int64_t* written) {
  auto* s = (StreamComp*)h;
  *written = 0;
  if (s->excess) return -2;
  BitWriter bw(out, out_cap);
  bw.acc = s->acc; bw.bits = s->bits;
  int64_t emitted_before = bw.n * 8 + bw.bits;
  int rc = s->drain(bw);
  if (rc) {  // output full (or a callback stop) mid-drain: save and report
    s->acc = bw.acc; s->bits = bw.bits;
    *written = bw.n;
    s->out_total += bw.n;
    return rc;
  }
  if (bw.n * 8 + bw.bits != emitted_before) s->last_was_flush = false;
  bw.put(0, 0);  // drain any whole bytes (e.g. the queued header)
  bool emit = write_token && !s->last_was_flush;
  bool token_written = false;
  if (emit && (bw.bits > 0 || s->dictionary_reset)) {
    bw.put(0xAB, 9);
    token_written = true;
  }
  bw.pad();
  if (bw.overflow) return 1;
  if (token_written) s->last_was_flush = true;
  s->acc = 0; s->bits = 0;
  *written = bw.n;
  s->out_total += bw.n;
  return 0;
}

int tpt_stream_comp_reset_dictionary(void* h, uint8_t* out, int64_t out_cap,
                                     int64_t* written) {
  auto* s = (StreamComp*)h;
  *written = 0;
  if (!s->dictionary_reset) return -5;
  int64_t total = 0;
  for (int i = 0; i < 2; i++) {
    s->last_was_flush = false;  // deliberately bypass the suppression
    int64_t w = 0;
    int rc = tpt_stream_comp_flush(h, 1, out + total, out_cap - total, &w);
    total += w;
    if (rc) { *written = total; return rc; }
  }
  stream_comp_init_state(s, nullptr);
  s->last_was_flush = false;
  s->acc = 0; s->bits = 0;
  *written = total;
  return 0;
}

// ---- streaming decompressor ------------------------------------------------

void* tpt_stream_dec_new(const uint8_t* dict, int64_t dict_len) {
  auto* s = new StreamDecomp();
  if (dict && dict_len > 0) s->dict.assign(dict, dict + dict_len);
  return s;
}

void tpt_stream_dec_free(void* h) { delete (StreamDecomp*)h; }

int tpt_stream_dec_feed(void* h, const uint8_t* in, int64_t in_len) {
  auto* s = (StreamDecomp*)h;
  if (in_len > 0) s->inbuf.insert(s->inbuf.end(), in, in + in_len);
  return 0;
}

// Decode as much as fits.  Returns 0 (call again after feeding more input
// if *written < out_cap), -3 invalid stream, -4 a reference outside the
// window, or a callback's nonzero return.
int tpt_stream_dec_read(void* h, uint8_t* out, int64_t out_cap,
                        int64_t* written) {
  auto* s = (StreamDecomp*)h;
  int64_t o = 0;
  *written = 0;
  if (s->bad) return -3;

  // Serve spilled bytes first.
  while (s->spill_off < s->spill.size() && o < out_cap)
    out[o++] = s->spill[s->spill_off++];
  if (s->spill_off >= s->spill.size()) { s->spill.clear(); s->spill_off = 0; }

  const uint8_t* in = s->inbuf.data();
  int64_t n = (int64_t)s->inbuf.size();

  if (!s->configured) {
    if (!s->have_first) {
      if (s->in_pos >= n) { *written = o; return 0; }
      s->first_byte = in[s->in_pos++];
      s->have_first = true;
    }
    uint8_t hb = s->first_byte;
    s->window = (hb >> 5) + 8;
    s->literal = ((hb >> 3) & 3) + 5;
    s->custom = (hb >> 2) & 1;
    s->extended = (hb >> 1) & 1;
    s->more = hb & 1;
    if (s->more) {
      if (s->in_pos >= n) { *written = o; return 0; }
      if (in[s->in_pos++] != 0) { s->bad = true; return -3; }
    }
    s->W = 1 << s->window;
    s->wmask = s->W - 1;
    s->minp = min_pattern_size(s->window, s->literal);
    if (s->custom && (int64_t)s->dict.size() < s->W) { s->bad = true; return -3; }
    s->ring.assign((size_t)s->W, 0);
    if (s->custom) std::memcpy(s->ring.data(), s->dict.data(), (size_t)s->W);
    else init_dictionary(s->ring.data(), s->W, s->extended ? s->literal : 8);
    s->pos = 0;
    s->configured = true;
  }

  uint64_t acc = s->acc;
  int bits = s->bits;
  int64_t pos_in = s->in_pos;
  int pos = s->pos;
  uint8_t* ring = s->ring.data();
  const int W = s->W, wmask = s->wmask, minp = s->minp, literal = s->literal;

  auto refill = [&](int need) -> bool {
    while (bits < need) {
      if (pos_in >= n) return false;
      acc = (acc << 8) | in[pos_in++];
      bits += 8;
    }
    return true;
  };
  auto take = [&](int nb) -> uint32_t {
    uint32_t v = (uint32_t)((acc >> (bits - nb)) & ((1ull << nb) - 1));
    bits -= nb;
    return v;
  };
  bool bad = false;
  auto read_sym = [&]() -> int {
    while (bits < 8 && pos_in < n) { acc = (acc << 8) | in[pos_in++]; bits += 8; }
    if (bits >= 8) {
      uint32_t peek = (uint32_t)(acc >> (bits - 8)) & 0xFF;
      int sym = SYM_TAB[peek];
      if (sym == 0xFF) { bad = true; return -1; }
      bits -= LEN_TAB[peek];
      return sym;
    }
    uint32_t key = 1;
    for (int i = 0; i < 8; i++) {
      if (!refill(1)) return -1;
      key = (key << 1) | take(1);
      for (int sym = 0; sym < 15; sym++)
        if (key == ((1u << (HUFF_BITS[sym] - 1)) | HUFF_CODE[sym])) return sym;
    }
    bad = true;
    return -1;
  };
  // Emit decoded bytes: straight to out, the rest to the spill.
  auto emit = [&](const uint8_t* src, int count) {
    int direct = (int)((out_cap - o) < count ? (out_cap - o) : count);
    if (direct > 0) { std::memcpy(out + o, src, (size_t)direct); o += direct; }
    if (direct < count)
      s->spill.insert(s->spill.end(), src + direct, src + count);
  };
  uint8_t tmp[256];

  // Progress callback, polled every 1024 tokens at a token boundary; a
  // nonzero return stops the call with the state saved as on a normal
  // return, so another read resumes.
  int cb_rc = 0;
  auto poll_cb = [&]() -> bool {
    if (__builtin_expect(s->cb != nullptr, 0) && ((++s->cb_ctr & 1023u) == 0)) {
      cb_rc = s->cb(s->cb_user, s->in_base + pos_in, s->out_total + o);
      return cb_rc != 0;
    }
    return false;
  };

  // Fast path: with >= 8 loadable input bytes and >= 256 bytes of output
  // room no token needs refill checks, rollback, bounds checks or the spill.
  if (s->spill.empty()) {
    const int64_t in_guard = n - 8;
    const int64_t out_guard = out_cap - 256;
    const uint32_t lit_mask = (1u << literal) - 1;
    const int window = s->window;
    const bool extended = s->extended, more = s->more;
    bool last_was_flush = s->last_was_flush;
    while (pos_in <= in_guard && o <= out_guard) {
      if (poll_cb()) break;
      int nb = (63 - bits) >> 3;
      if (nb) {
        uint64_t chunk;
        std::memcpy(&chunk, in + pos_in, 8);
        chunk = __builtin_bswap64(chunk);
        acc = (acc << (nb * 8)) | (chunk >> (64 - nb * 8));
        pos_in += nb;
        bits += nb * 8;
      }
      if ((acc >> (bits - 1)) & 1) {  // literal
        bits -= 1 + literal;
        uint8_t b = (uint8_t)((acc >> bits) & lit_mask);
        last_was_flush = false;
        out[o++] = b;
        ring[pos] = b;
        pos = (pos + 1) & wmask;
        continue;
      }
      bits -= 1;
      uint32_t peek = (uint32_t)(acc >> (bits - 8)) & 0xFF;
      int sym = SYM_TAB[peek];
      if (sym == 0xFF) { s->bad = true; return -3; }
      bits -= LEN_TAB[peek];
      if (sym == FLUSH_SYM) {
        bits &= ~7;  // discard the padding to the byte boundary
        if (more && last_was_flush) {
          init_dictionary(ring, W, extended ? literal : 8);
          pos = 0;
        }
        last_was_flush = true;
        continue;
      }
      last_was_flush = false;
      if (extended && sym > 11) {
        peek = (uint32_t)(acc >> (bits - 8)) & 0xFF;
        int s2 = SYM_TAB[peek];
        if (s2 == 0xFF) { s->bad = true; return -3; }
        bits -= LEN_TAB[peek];
        if (sym == RLE_SYM) {
          bits -= RLE_TRAIL;
          int count = (s2 << RLE_TRAIL) +
                      (int)((acc >> bits) & ((1u << RLE_TRAIL) - 1)) + 2;
          uint8_t b = ring[(pos - 1) & wmask];
          std::memset(out + o, b, (size_t)count);
          o += count;
          int wr = count < RLE_MAX_WIN ? count : RLE_MAX_WIN;
          if (wr > W - pos) wr = W - pos;
          std::memset(&ring[pos], b, (size_t)wr);
          pos = (pos + wr) & wmask;
        } else {  // extended match (never wraps on its window write)
          bits -= EXT_TRAIL;
          int size = (s2 << EXT_TRAIL) +
                     (int)((acc >> bits) & ((1u << EXT_TRAIL) - 1)) + minp + 12;
          bits -= window;
          int index = (int)((acc >> bits) & (uint32_t)wmask);
          if (index + size > W) { s->bad = true; return -4; }
          std::memcpy(out + o, ring + index, (size_t)size);
          int wr = size < (W - pos) ? size : (W - pos);
          std::memcpy(ring + pos, out + o, (size_t)wr);
          pos = (pos + wr) & wmask;
          o += size;
        }
      } else {  // basic match, size <= minp + 13 <= 16
        int size = sym + minp;
        bits -= window;
        int index = (int)((acc >> bits) & (uint32_t)wmask);
        if (index + size > W) { s->bad = true; return -4; }
        if (index + 16 <= W)
          std::memcpy(out + o, ring + index, 16);
        else
          std::memcpy(out + o, ring + index, (size_t)size);
        if (pos + size <= W) {
          std::memcpy(ring + pos, out + o, (size_t)size);
          pos = (pos + size) & wmask;
        } else {
          for (int i = 0; i < size; i++) {
            ring[pos] = out[o + i];
            pos = (pos + 1) & wmask;
          }
        }
        o += size;
      }
    }
    s->last_was_flush = last_was_flush;
  }

  while (!cb_rc && s->spill.empty()) {
    if (poll_cb()) break;
    if (!refill(1)) break;
    uint64_t s_acc = acc; int s_bits = bits; int64_t s_pos = pos_in;

    if (take(1)) {  // literal
      if (!refill(literal)) { acc = s_acc; bits = s_bits; pos_in = s_pos; break; }
      uint8_t b = (uint8_t)take(literal);
      s->last_was_flush = false;
      emit(&b, 1);
      ring[pos] = b; if (++pos == W) pos = 0;
      continue;
    }
    int sym = read_sym();
    if (bad) { s->bad = true; return -3; }
    if (sym < 0) { acc = s_acc; bits = s_bits; pos_in = s_pos; break; }
    if (sym == FLUSH_SYM) {
      bits &= ~7;  // discard the padding to the byte boundary
      if (s->more && s->last_was_flush) {
        init_dictionary(ring, W, s->extended ? literal : 8);
        pos = 0;
      }
      s->last_was_flush = true;
      continue;
    }
    if (s->extended && sym > 11) {
      int s2 = read_sym();
      if (bad) { s->bad = true; return -3; }
      if (s2 < 0) { acc = s_acc; bits = s_bits; pos_in = s_pos; break; }
      if (sym == RLE_SYM) {
        if (!refill(RLE_TRAIL)) { acc = s_acc; bits = s_bits; pos_in = s_pos; break; }
        s->last_was_flush = false;
        int count = (s2 << RLE_TRAIL) + (int)take(RLE_TRAIL) + 2;
        uint8_t b = ring[pos == 0 ? W - 1 : pos - 1];
        std::memset(tmp, b, (size_t)count);
        emit(tmp, count);
        int wr = count < RLE_MAX_WIN ? count : RLE_MAX_WIN;
        if (wr > W - pos) wr = W - pos;
        for (int i = 0; i < wr; i++) { ring[pos] = b; if (++pos == W) pos = 0; }
        continue;
      }
      // extended match
      if (!refill(EXT_TRAIL + s->window)) { acc = s_acc; bits = s_bits; pos_in = s_pos; break; }
      s->last_was_flush = false;
      int size = (s2 << EXT_TRAIL) + (int)take(EXT_TRAIL) + minp + 12;
      int index = (int)take(s->window);
      if (index + size > W) { s->bad = true; return -4; }
      std::memcpy(tmp, ring + index, (size_t)size);
      int wr = size < (W - pos) ? size : (W - pos);
      std::memcpy(ring + pos, tmp, (size_t)wr);
      pos += wr; if (pos == W) pos = 0;
      emit(tmp, size);
      continue;
    }
    // basic match
    if (!refill(s->window)) { acc = s_acc; bits = s_bits; pos_in = s_pos; break; }
    s->last_was_flush = false;
    int size = sym + minp;
    int index = (int)take(s->window);
    if (index + size > W) { s->bad = true; return -4; }
    std::memcpy(tmp, ring + index, (size_t)size);
    for (int i = 0; i < size; i++) { ring[pos] = tmp[i]; if (++pos == W) pos = 0; }
    emit(tmp, size);
  }

  s->acc = acc; s->bits = bits; s->in_pos = pos_in; s->pos = pos;
  if (s->in_pos > (1 << 20)) {  // compact the consumed input
    s->in_base += s->in_pos;
    s->inbuf.erase(s->inbuf.begin(), s->inbuf.begin() + s->in_pos);
    s->in_pos = 0;
  }
  *written = o;
  s->out_total += o;
  return cb_rc;
}

void tpt_stream_comp_set_callback(void* h, tpt_cb_t cb, void* user) {
  auto* s = (StreamComp*)h;
  s->cb = cb; s->cb_user = user; s->cb_ctr = 0;
}

void tpt_stream_dec_set_callback(void* h, tpt_cb_t cb, void* user) {
  auto* s = (StreamDecomp*)h;
  s->cb = cb; s->cb_user = user; s->cb_ctr = 0;
}

}  // extern "C"
