// rANS range coder (64-bit state, 32-bit word renormalization) with
// CompressAI-compatible stream layout, re-implemented from the public
// rANS/CompressAI specification for the TPU build.
//
// The reference consumes this codec through compressai.ans.RansEncoder /
// RansDecoder (ref: src/models/comp_model/hyperprior_dc_vic_model.py:314-319
// and src/models/subnet/context_model/minnen20_charm_context_model.py:179-203).
// Here it is a small C library driven from Python via ctypes; symbols and CDF
// indexes are produced on-device (JAX) and only compact int planes cross the
// host<->device boundary.
//
// Performance notes (single host core is the budget):
//   * Tables are "prepared" once into a handle holding, per CDF row, a dense
//     2^16 cum -> symbol lookup (O(1) decode, no per-symbol scan).
//   * Encoding runs as a single direct reverse pass over the symbols — no
//     intermediate (start, range) buffering.
//
// Stream format:
//   * 16-bit probability precision; quantized CDFs sum to 1<<16.
//   * Per-index CDF rows; the last bin (symbol cdf_length-2) is the escape
//     slot: out-of-range values are coded as escape + variable-length 4-bit
//     bypass chunks (count coded first, saturating at 15 per chunk).
//   * Decoder reads symbols in forward order; the encoder therefore walks
//     the symbol sequence (and each escape's chunk sequence) backwards.
//   * Final state flushed as two little-endian 32-bit words (low, high).

#include <cassert>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using Rans64State = uint64_t;

constexpr uint64_t kRansL = 1ull << 31;
constexpr int kPrecision = 16;
constexpr int kBypassPrecision = 4;
constexpr uint32_t kMaxBypassVal = (1u << kBypassPrecision) - 1;

inline void rans_enc_put(Rans64State *r, uint32_t **pptr, uint32_t start,
                         uint32_t freq, uint32_t scale_bits) {
  uint64_t x = *r;
  const uint64_t x_max = ((kRansL >> scale_bits) << 32) * freq;
  if (x >= x_max) {
    *pptr -= 1;
    **pptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  *r = ((x / freq) << scale_bits) + (x % freq) + start;
}

inline void rans_enc_put_bits(Rans64State *r, uint32_t **pptr, uint32_t val,
                              uint32_t nbits) {
  uint64_t x = *r;
  const uint32_t freq = 1u << (kPrecision - nbits);
  const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    *pptr -= 1;
    **pptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  *r = (x << nbits) | val;
}

inline void rans_enc_flush(Rans64State *r, uint32_t **pptr) {
  const uint64_t x = *r;
  *pptr -= 2;
  (*pptr)[0] = static_cast<uint32_t>(x);
  (*pptr)[1] = static_cast<uint32_t>(x >> 32);
}

inline void rans_dec_init(Rans64State *r, uint32_t **pptr) {
  *r = static_cast<uint64_t>((*pptr)[0]) |
       (static_cast<uint64_t>((*pptr)[1]) << 32);
  *pptr += 2;
}

inline uint32_t rans_dec_get(const Rans64State *r, uint32_t scale_bits) {
  return static_cast<uint32_t>(*r & ((1ull << scale_bits) - 1));
}

inline void rans_dec_advance(Rans64State *r, uint32_t **pptr,
                             const uint32_t *end, uint32_t start,
                             uint32_t freq, uint32_t scale_bits) {
  const uint64_t mask = (1ull << scale_bits) - 1;
  uint64_t x = *r;
  x = freq * (x >> scale_bits) + (x & mask) - start;
  if (x < kRansL && *pptr < end) {
    x = (x << 32) | **pptr;
    *pptr += 1;
  }
  *r = x;
}

inline uint32_t rans_dec_get_bits(Rans64State *r, uint32_t **pptr,
                                  const uint32_t *end, uint32_t nbits) {
  uint64_t x = *r;
  const uint32_t val = static_cast<uint32_t>(x & ((1ull << nbits) - 1));
  x >>= nbits;
  if (x < kRansL && *pptr < end) {
    x = (x << 32) | **pptr;
    *pptr += 1;
  }
  *r = x;
  return val;
}

// Prepared CDF table: raw rows + dense decode LUTs.
struct Table {
  int rows;
  int cols;
  std::vector<int32_t> cdfs;         // [rows, cols]
  std::vector<int32_t> cdf_lengths;  // [rows]
  std::vector<int32_t> offsets;      // [rows]
  std::vector<uint16_t> lut;         // [rows, 1<<precision] cum -> symbol

  const int32_t *row(int i) const { return cdfs.data() + (int64_t)i * cols; }
  const uint16_t *lut_row(int i) const {
    return lut.data() + ((int64_t)i << kPrecision);
  }
};

// Count 4-bit chunks of v (0 for v == 0). The shift runs in 64-bit: for
// v >= 2^28 the count reaches 8 and a 32-bit shift-by-32 is UB (x86 wraps
// the count mod 32, looping forever — found by the adversarial spec fuzz
// in tests/test_rans_spec.py; escape raws reach 2^29+ for deep escapes).
inline int32_t n_chunks(uint32_t v) {
  int32_t n = 0;
  uint64_t x = v;
  while ((x >> (n * kBypassPrecision)) != 0) ++n;
  return n;
}

// Reverse-order encode of one (symbol, index) pair.
inline void encode_one_reverse(Rans64State *r, uint32_t **pptr,
                               int32_t symbol, int32_t index,
                               const Table &t) {
  const int32_t *cdf = t.row(index);
  const int32_t max_value = t.cdf_lengths[index] - 2;
  int32_t value = symbol - t.offsets[index];

  uint32_t raw_val = 0;
  bool escape = false;
  if (value < 0) {
    raw_val = static_cast<uint32_t>(-2 * value - 1);
    value = max_value;
    escape = true;
  } else if (value >= max_value) {
    raw_val = static_cast<uint32_t>(2 * (value - max_value));
    value = max_value;
    escape = true;
  }

  if (escape) {
    // Decoder reads: chunk-count chunks, then raw chunks LSB-first. The
    // reverse encoder emits raw chunks MSB-first, then the count encoding
    // backwards (count tail chunk first, then saturating 15s).
    const int32_t nb = n_chunks(raw_val);
    for (int32_t j = nb - 1; j >= 0; --j) {
      rans_enc_put_bits(r, pptr,
                        (raw_val >> (j * kBypassPrecision)) & kMaxBypassVal,
                        kBypassPrecision);
    }
    int32_t v = nb;
    int32_t n15 = 0;
    while (v >= static_cast<int32_t>(kMaxBypassVal)) {
      v -= kMaxBypassVal;
      ++n15;
    }
    rans_enc_put_bits(r, pptr, static_cast<uint32_t>(v), kBypassPrecision);
    for (int32_t j = 0; j < n15; ++j) {
      rans_enc_put_bits(r, pptr, kMaxBypassVal, kBypassPrecision);
    }
  }

  rans_enc_put(r, pptr, static_cast<uint32_t>(cdf[value]),
               static_cast<uint32_t>(cdf[value + 1] - cdf[value]), kPrecision);
}

struct Decoder {
  std::vector<uint32_t> words;
  uint32_t *ptr;
  uint32_t *end;
  Rans64State rans;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- tables
void *dcvic_rans_table_new(const int32_t *cdfs, int rows, int cols,
                           const int32_t *cdf_lengths,
                           const int32_t *offsets) {
  auto *t = new Table();
  t->rows = rows;
  t->cols = cols;
  t->cdfs.assign(cdfs, cdfs + (int64_t)rows * cols);
  t->cdf_lengths.assign(cdf_lengths, cdf_lengths + rows);
  t->offsets.assign(offsets, offsets + rows);
  t->lut.resize((int64_t)rows << kPrecision);
  for (int i = 0; i < rows; ++i) {
    const int32_t *cdf = t->row(i);
    uint16_t *lut = t->lut.data() + ((int64_t)i << kPrecision);
    const int32_t n = t->cdf_lengths[i] - 1;  // number of symbols in row
    for (int32_t s = 0; s < n; ++s) {
      for (int32_t c = cdf[s]; c < cdf[s + 1]; ++c) {
        lut[c] = static_cast<uint16_t>(s);
      }
    }
  }
  return t;
}

void dcvic_rans_table_free(void *handle) {
  delete static_cast<Table *>(handle);
}

// ---------------------------------------------------------------- encode
// One-shot encode: symbols[i] coded against cdf row indexes[i].
// Returns bytes written, or negative required size if capacity insufficient.
int dcvic_rans_encode_with_indexes(const int32_t *symbols,
                                   const int32_t *indexes, int n,
                                   const void *table, uint8_t *out,
                                   int out_capacity) {
  const Table &t = *static_cast<const Table *>(table);
  // Worst case: per symbol, 1 word (renorm) + escape chunks; bound loosely.
  const size_t cap_words = static_cast<size_t>(n) * 12 + 4;
  std::vector<uint32_t> buf(cap_words);
  uint32_t *ptr = buf.data() + cap_words;

  Rans64State rans = kRansL;
  for (int i = n - 1; i >= 0; --i) {
    encode_one_reverse(&rans, &ptr, symbols[i], indexes[i], t);
  }
  rans_enc_flush(&rans, &ptr);

  const int nbytes =
      static_cast<int>((buf.data() + cap_words - ptr) * sizeof(uint32_t));
  if (nbytes > out_capacity) return -nbytes;
  std::memcpy(out, ptr, nbytes);
  return nbytes;
}

// ---------------------------------------------------------------- decode
void *dcvic_rans_decoder_new(const uint8_t *stream, int stream_len) {
  auto *dec = new Decoder();
  const size_t n_words = (static_cast<size_t>(stream_len) + 3) / 4;
  dec->words.assign(n_words, 0);
  std::memcpy(dec->words.data(), stream, stream_len);
  dec->ptr = dec->words.data();
  dec->end = dec->words.data() + n_words;
  rans_dec_init(&dec->rans, &dec->ptr);
  return dec;
}

void dcvic_rans_decoder_free(void *handle) {
  delete static_cast<Decoder *>(handle);
}

// Decode n symbols against cdf rows indexes[i]; forward order.
void dcvic_rans_decode_stream(void *handle, const int32_t *indexes, int n,
                              const void *table, int32_t *out_symbols) {
  const Table &t = *static_cast<const Table *>(table);
  auto *dec = static_cast<Decoder *>(handle);
  for (int i = 0; i < n; ++i) {
    const int32_t index = indexes[i];
    const int32_t *cdf = t.row(index);
    const uint16_t *lut = t.lut_row(index);
    const int32_t max_value = t.cdf_lengths[index] - 2;

    const uint32_t cum = rans_dec_get(&dec->rans, kPrecision);
    const int32_t s = lut[cum];

    rans_dec_advance(&dec->rans, &dec->ptr, dec->end,
                     static_cast<uint32_t>(cdf[s]),
                     static_cast<uint32_t>(cdf[s + 1] - cdf[s]), kPrecision);

    int32_t value = s;
    if (value == max_value) {
      // Bypass-decode the escape value.
      int32_t n_bypass = 0;
      uint32_t val = rans_dec_get_bits(&dec->rans, &dec->ptr, dec->end,
                                       kBypassPrecision);
      n_bypass += static_cast<int32_t>(val);
      while (val == kMaxBypassVal) {
        val = rans_dec_get_bits(&dec->rans, &dec->ptr, dec->end,
                                kBypassPrecision);
        n_bypass += static_cast<int32_t>(val);
      }
      uint32_t raw_val = 0;
      for (int32_t j = 0; j < n_bypass; ++j) {
        val = rans_dec_get_bits(&dec->rans, &dec->ptr, dec->end,
                                kBypassPrecision);
        // guard the shift: a corrupt stream can claim n_bypass > 8, and a
        // shift by >= 32 is UB (same class as the n_chunks fix). Excess
        // chunks are still consumed (stream position semantics) but fall
        // off the top of the 32-bit raw.
        if (j * kBypassPrecision < 32) {
          raw_val |= val << (j * kBypassPrecision);
        }
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    out_symbols[i] = value + t.offsets[index];
  }
}

// One-shot decode convenience wrapper.
void dcvic_rans_decode_with_indexes(const uint8_t *stream, int stream_len,
                                    const int32_t *indexes, int n,
                                    const void *table, int32_t *out_symbols) {
  void *dec = dcvic_rans_decoder_new(stream, stream_len);
  dcvic_rans_decode_stream(dec, indexes, n, table, out_symbols);
  dcvic_rans_decoder_free(dec);
}

}  // extern "C"

// --------------------------------------------------------------------------
// TPU interleaved-lane stream format (host-side coder).
//
// Byte-identical to the device coder in ops/rans_device.py: 32-bit state,
// 16-bit renorm words, L lockstep lanes sharing one word stream in canonical
// (step, lane) order; 2 little-endian flush words per lane at stream start;
// escape raw payloads in a plain side channel after the rANS words (tier-1:
// one word per escape, 0xFFFF marker spills to two tier-2 words). The host
// encoder runs OFF the device critical path in the codec pipeline; the
// device decodes the same stream in-graph.

namespace {
constexpr uint32_t kTpuL = 1u << 16;
constexpr uint32_t kTier1Marker = 0xFFFFu;
constexpr int32_t kEscHasTier2 = 1 << 28;  // esc_max_out flag bit
}  // namespace

extern "C" {

// sym/idx: [sum(sec_n)*L], step-major within each section (symbol (t, lane)
// of section s at sec_base[s] + t*L + lane), sections concatenated in
// DECODE order. Lane states CHAIN across sections: the reverse rANS pass
// runs over sections last-to-first carrying the states through, so the
// stream pays exactly ONE 2L-word flush (the per-section flush of the v2
// format was a 5-20% rate tax at low bpp with production lane counts).
// Layout: [2L flush][sec0 renorm|tier-1|tier-2][sec1 renorm|...]...
// Returns words written, or a negative number if cap is insufficient.
// esc_max_out (nullable): receives the max per-section escape count, which
// the driver compares against ops/rans_device.esc_cap() to decide whether
// the device decoder's sparse escape epilogue is exact for this stream
// (container header dense-escape flag). Bit 28 (kEscHasTier2) is set when
// ANY tier-2 word was emitted — its absence lets the driver write the
// container's tier-2-free guarantee bit, which deletes the tier-2
// resolution from the device decode epilogue (ops/rans_device.py
// decode_section tier2=False).
int dcvic_tpu_encode_stream(const int32_t *sym, const int32_t *idx,
                            const int32_t *sec_n, int n_sections, int L,
                            const void *table, uint16_t *out, int cap,
                            int32_t *esc_max_out) {
  const Table &t = *static_cast<const Table *>(table);
  int64_t total_steps = 0;
  std::vector<int64_t> sec_base(n_sections);
  for (int s = 0; s < n_sections; ++s) {
    sec_base[s] = total_steps * L;
    total_steps += sec_n[s];
  }
  const size_t NE = static_cast<size_t>(total_steps) * L;
  std::vector<uint16_t> w(NE);
  std::vector<uint8_t> m(NE, 0);
  std::vector<std::vector<uint16_t>> tier1(n_sections), tier2(n_sections);

  // forward pass collects each section's side channel in (step, lane) order
  for (int s = 0; s < n_sections; ++s) {
    const int64_t lo = sec_base[s];
    const int64_t hi = lo + static_cast<int64_t>(sec_n[s]) * L;
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t index = idx[i];
      const int32_t maxv = t.cdf_lengths[index] - 2;
      const int32_t value = sym[i] - t.offsets[index];
      if (value >= 0 && value < maxv) continue;
      // zigzag in int64: -2*value-1 / 2*(value-maxv) would be signed int32
      // overflow (UB) for |value| near 2^31; the result always fits uint32
      // for any int32 input (max is 2^32-1 at value = INT32_MIN).
      const int64_t v64 = static_cast<int64_t>(value);
      const uint32_t raw = value < 0
          ? static_cast<uint32_t>(-2 * v64 - 1)
          : static_cast<uint32_t>(2 * (v64 - maxv));
      if (raw >= kTier1Marker) {
        tier1[s].push_back(static_cast<uint16_t>(kTier1Marker));
        tier2[s].push_back(static_cast<uint16_t>(raw & 0xFFFF));
        tier2[s].push_back(static_cast<uint16_t>(raw >> 16));
      } else {
        tier1[s].push_back(static_cast<uint16_t>(raw));
      }
    }
  }
  if (esc_max_out != nullptr) {
    int32_t esc_max = 0;
    bool has_t2 = false;
    for (int s = 0; s < n_sections; ++s) {
      const size_t n1 = tier1[s].size();
      if (static_cast<int32_t>(n1) > esc_max)
        esc_max = static_cast<int32_t>(n1);
      has_t2 |= !tier2[s].empty();
    }
    *esc_max_out = esc_max | (has_t2 ? kEscHasTier2 : 0);
  }

  // reverse rANS pass, chained lane states (escape bins, no bypass words)
  std::vector<uint32_t> x(L, kTpuL);
  for (int s = n_sections - 1; s >= 0; --s) {
    for (int step = sec_n[s] - 1; step >= 0; --step) {
      for (int l = 0; l < L; ++l) {
        const size_t pos = static_cast<size_t>(sec_base[s]) +
                           static_cast<size_t>(step) * L + l;
        const int32_t index = idx[pos];
        const int32_t *cdf = t.row(index);
        const int32_t maxv = t.cdf_lengths[index] - 2;
        int32_t value = sym[pos] - t.offsets[index];
        if (value < 0 || value >= maxv) value = maxv;
        const uint32_t start = static_cast<uint32_t>(cdf[value]);
        const uint32_t freq =
            static_cast<uint32_t>(cdf[value + 1] - cdf[value]);
        uint32_t xs = x[l];
        if (xs >= (freq << 16)) {
          w[pos] = static_cast<uint16_t>(xs);
          m[pos] = 1;
          xs >>= 16;
        }
        xs = ((xs / freq) << 16) | ((xs % freq) + start);
        x[l] = xs;
      }
    }
  }

  int64_t need = 2 * L;
  for (size_t i = 0; i < m.size(); ++i) need += m[i];
  for (int s = 0; s < n_sections; ++s)
    need += static_cast<int64_t>(tier1[s].size() + tier2[s].size());
  if (need > cap) return -static_cast<int>(need);

  int k = 0;
  for (int l = 0; l < L; ++l) {
    out[k++] = static_cast<uint16_t>(x[l] & 0xFFFF);
    out[k++] = static_cast<uint16_t>(x[l] >> 16);
  }
  for (int s = 0; s < n_sections; ++s) {
    const int64_t lo = sec_base[s];
    const int64_t hi = lo + static_cast<int64_t>(sec_n[s]) * L;
    for (int64_t i = lo; i < hi; ++i)
      if (m[i]) out[k++] = w[i];
    for (uint16_t v : tier1[s]) out[k++] = v;
    for (uint16_t v : tier2[s]) out[k++] = v;
  }
  return k;
}

// Decode a whole chained stream (all sections); returns words consumed.
int dcvic_tpu_decode_stream(const uint16_t *words, int avail,
                            const int32_t *idx, const int32_t *sec_n,
                            int n_sections, int L, const void *table,
                            int32_t *out_sym) {
  const Table &t = *static_cast<const Table *>(table);
  std::vector<uint32_t> x(L);
  int cur = 0;
  const auto rd = [&]() -> uint32_t {
    return (cur < avail) ? words[cur++] : 0u;
  };
  for (int l = 0; l < L; ++l) {
    const uint32_t lo = rd();
    const uint32_t hi = rd();
    x[l] = lo | (hi << 16);
  }
  int64_t base = 0;
  for (int s = 0; s < n_sections; ++s) {
    std::vector<int64_t> esc_pos;  // flat positions of escapes, in order
    for (int step = 0; step < sec_n[s]; ++step) {
      for (int l = 0; l < L; ++l) {
        const int64_t i = base + static_cast<int64_t>(step) * L + l;
        const int32_t index = idx[i];
        const uint16_t *lut = t.lut_row(index);
        const int32_t *cdf = t.row(index);
        const uint32_t cum = x[l] & 0xFFFF;
        const int32_t sv = lut[cum];
        const uint32_t start = static_cast<uint32_t>(cdf[sv]);
        const uint32_t freq = static_cast<uint32_t>(cdf[sv + 1] - cdf[sv]);
        uint32_t xs = freq * (x[l] >> 16) + cum - start;
        if (xs < kTpuL) xs = (xs << 16) | rd();
        x[l] = xs;
        if (sv == t.cdf_lengths[index] - 2) {
          esc_pos.push_back(i);
        } else {
          out_sym[i] = sv + t.offsets[index];
        }
      }
    }
    // this section's side channel: tier-1 words, then tier-2 pairs
    const int n_esc = static_cast<int>(esc_pos.size());
    int t2 = cur + n_esc;
    for (int e = 0; e < n_esc; ++e) {
      const int64_t i = esc_pos[e];
      const int32_t index = idx[i];
      const int32_t maxv = t.cdf_lengths[index] - 2;
      uint32_t raw = (cur + e < avail) ? words[cur + e] : 0u;
      if (raw == kTier1Marker) {
        const uint32_t lo = (t2 < avail) ? words[t2++] : 0u;
        const uint32_t hi = (t2 < avail) ? words[t2++] : 0u;
        raw = lo | (hi << 16);
      }
      const int32_t v = (raw & 1) ? -static_cast<int32_t>(raw >> 1) - 1
                                  : static_cast<int32_t>(raw >> 1) + maxv;
      out_sym[i] = v + t.offsets[index];
    }
    cur = t2;
    base += static_cast<int64_t>(sec_n[s]) * L;
  }
  return cur;
}


}  // extern "C"
