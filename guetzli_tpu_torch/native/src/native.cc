// Native host kernels for guetzli-tpu: JPEG entropy-coded scan
// serialization and Huffman-decode of input scans.
//
// These are the host-side hot paths the reference also keeps in native
// code (guetzli/jpeg_data_writer.cc EncodeScan + jpeg_bit_writer.h,
// guetzli/jpeg_data_reader.cc ProcessScan + jpeg_huffman_decode.cc). The
// bit-level semantics mirror the reference exactly so outputs stay
// byte-identical with the Python/numpy fallback implementations.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------
// Bit writer with 0xFF stuffing (guetzli/jpeg_bit_writer.h:40-86).
// ---------------------------------------------------------------------
struct BitWriter {
  uint8_t* data;
  int64_t pos;
  int64_t cap;
  uint64_t put_buffer = 0;
  int put_bits = 64;
  bool overflow = false;

  BitWriter(uint8_t* out, int64_t out_cap)
      : data(out), pos(0), cap(out_cap) {}

  inline void emit(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    data[pos++] = b;
  }

  inline void write_bits(int nbits, uint64_t bits) {
    put_bits -= nbits;
    put_buffer |= (bits << put_bits);
    while (put_bits <= 16) {
      uint8_t c = (put_buffer >> 56) & 0xFF;
      emit(c);
      if (c == 0xFF) emit(0);
      put_buffer <<= 8;
      put_bits += 8;
    }
  }

  inline void jump_to_byte_boundary() {
    int pad = put_bits & 7;
    if (pad) write_bits(pad, (1ull << pad) - 1);
    // Flush remaining whole bytes.
    while (put_bits < 64) {
      uint8_t c = (put_buffer >> 56) & 0xFF;
      emit(c);
      if (c == 0xFF) emit(0);
      put_buffer <<= 8;
      put_bits += 8;
    }
  }
};

inline int log2_floor_nonzero(uint32_t v) {
  return 31 - __builtin_clz(v);
}

const int kNat[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct CodeTable {
  const uint8_t* depth;   // [257]
  const int32_t* code;    // [257]
};

// EncodeDCTBlockSequential (jpeg_data_writer.cc:455-500).
inline void encode_block(const int16_t* coeffs, const CodeTable& dc,
                         const CodeTable& ac, int16_t* last_dc,
                         BitWriter* bw) {
  int temp2 = coeffs[0];
  int temp = temp2 - *last_dc;
  *last_dc = coeffs[0];
  temp2 = temp;
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = (temp == 0) ? 0 : (log2_floor_nonzero((uint32_t)temp) + 1);
  bw->write_bits(dc.depth[nbits], (uint64_t)dc.code[nbits]);
  if (nbits > 0) bw->write_bits(nbits, temp2 & ((1 << nbits) - 1));

  int r = 0;
  for (int k = 1; k < 64; ++k) {
    int16_t coeff = coeffs[kNat[k]];
    if (coeff == 0) { r++; continue; }
    while (r > 15) {
      bw->write_bits(ac.depth[0xf0], (uint64_t)ac.code[0xf0]);
      r -= 16;
    }
    int t = coeff, t2 = coeff;
    if (t < 0) { t = -t; t2--; }
    int nb = log2_floor_nonzero((uint32_t)t) + 1;
    int symbol = (r << 4) + nb;
    bw->write_bits(ac.depth[symbol], (uint64_t)ac.code[symbol]);
    bw->write_bits(nb, t2 & ((1 << nb) - 1));
    r = 0;
  }
  if (r > 0) bw->write_bits(ac.depth[0], (uint64_t)ac.code[0]);
}

}  // namespace

extern "C" {

// Serialize the interleaved baseline scan; returns byte count or -1 on
// overflow. Component c's coefficients are [hib[c]*wib[c], 64] int16 in
// block raster order; tables are [ncomp][257] row-major.
int64_t gt_encode_scan(const int16_t* const* comp_coeffs, const int* wib,
                       const int* hib, const int* hs, const int* vs,
                       int ncomp, int mcu_rows, int mcu_cols,
                       const uint8_t* dc_depth, const int32_t* dc_code,
                       const uint8_t* ac_depth, const int32_t* ac_code,
                       uint8_t* out, int64_t out_cap) {
  BitWriter bw(out, out_cap);
  int16_t last_dc[4] = {0, 0, 0, 0};
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      for (int c = 0; c < ncomp; ++c) {
        CodeTable dc{dc_depth + c * 257, dc_code + c * 257};
        CodeTable ac{ac_depth + c * 257, ac_code + c * 257};
        for (int iy = 0; iy < vs[c]; ++iy) {
          for (int ix = 0; ix < hs[c]; ++ix) {
            int by = my * vs[c] + iy;
            int bx = mx * hs[c] + ix;
            const int16_t* block =
                comp_coeffs[c] + ((int64_t)by * wib[c] + bx) * 64;
            encode_block(block, dc, ac, &last_dc[c], &bw);
          }
        }
      }
    }
  }
  bw.jump_to_byte_boundary();
  return bw.overflow ? -1 : bw.pos;
}

// ---------------------------------------------------------------------
// Huffman scan decoding (jpeg_data_reader.cc:422-909).
// ---------------------------------------------------------------------

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos;       // next byte
  int bitpos;        // bits consumed of current byte
  bool overread;

  void reset(int64_t p) { pos = p; bitpos = 0; overread = false; }

  inline int read_bit() {
    if (pos >= len) { overread = true; return 0; }
    uint8_t byte = data[pos];
    if (byte == 0xFF) {
      uint8_t nxt = (pos + 1 < len) ? data[pos + 1] : 0xD9;
      if (nxt != 0x00) return 0;  // at a marker: zero-pad
    }
    int bit = (byte >> (7 - bitpos)) & 1;
    if (++bitpos == 8) {
      bitpos = 0;
      pos += (byte == 0xFF) ? 2 : 1;
    }
    return bit;
  }

  inline int read_bits(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  // Byte position after discarding the partial byte; -1 on overread.
  int64_t finish() {
    if (bitpos > 0) {
      uint8_t byte = data[pos];
      bitpos = 0;
      pos += (byte == 0xFF) ? 2 : 1;
    }
    return overread ? -1 : pos;
  }
};

struct HuffTable {
  int mincode[17];
  int maxcode[17];
  int valptr[17];
  const int32_t* values;
  int nvalues;

  void build(const int32_t* counts) {
    int code = 0, k = 0;
    for (int ln = 1; ln <= 16; ++ln) {
      valptr[ln] = k;
      mincode[ln] = code;
      code += counts[ln];
      k += counts[ln];
      maxcode[ln] = code - 1;
      code <<= 1;
    }
  }

  inline int decode(BitReader* br, bool* err) {
    int code = br->read_bit();
    int ln = 1;
    while (code > maxcode[ln]) {
      if (ln >= 16) { *err = true; return 0; }
      code = (code << 1) | br->read_bit();
      ln++;
    }
    int idx = valptr[ln] + code - mincode[ln];
    if (idx >= nvalues) { *err = true; return 0; }
    return values[idx];
  }
};

inline int huff_extend(int r, int s) {
  return (r < (1 << (s - 1))) ? r - (1 << s) + 1 : r;
}

}  // namespace

// Decode one scan. Returns the byte position after the scan, or a negative
// error code. Tables: per slot 0..3, counts int32[17] + values int32[256];
// table_present bitmasks say which slots are defined.
//
// comp arrays are indexed per scan component.
int64_t gt_decode_scan(
    const uint8_t* data, int64_t len, int64_t pos,
    int ncomp_scan, const int* comp_idx_unused, const int* dc_tbl,
    const int* ac_tbl, const int* wib, const int* hib, const int* hsamp,
    const int* vsamp, int16_t* const* coeffs,
    int mcu_rows, int mcu_cols, int restart_interval,
    int ss, int se, int ah, int al,
    const int32_t* dc_counts, const int32_t* dc_values,
    const int32_t* ac_counts, const int32_t* ac_values,
    int dc_present, int ac_present) {
  HuffTable dc_tables[4], ac_tables[4];
  for (int i = 0; i < 4; ++i) {
    dc_tables[i].build(dc_counts + i * 17);
    dc_tables[i].values = dc_values + i * 256;
    int n = 0;
    for (int ln = 1; ln <= 16; ++ln) n += dc_counts[i * 17 + ln];
    dc_tables[i].nvalues = n;
    ac_tables[i].build(ac_counts + i * 17);
    ac_tables[i].values = ac_values + i * 256;
    n = 0;
    for (int ln = 1; ln <= 16; ++ln) n += ac_counts[i * 17 + ln];
    ac_tables[i].nvalues = n;
  }

  BitReader br{data, len, 0, 0, false};
  br.reset(pos);
  int eobrun = 0;
  int16_t last_dc[4] = {0, 0, 0, 0};
  int next_restart = 0;
  int restart_to_go = restart_interval;
  bool herr = false;

  // The caller passes the scan grid: the MCU grid for interleaved scans,
  // or DivCeil(width*h_samp, 8*max_h) x DivCeil(height*v_samp, 8*max_v)
  // for non-interleaved scans (jpeg_data_reader.cc:770-778). wib[c]
  // remains the coefficient-storage row stride in both cases.
  int rows = mcu_rows, cols = mcu_cols;

  for (int my = 0; my < rows; ++my) {
    for (int mx = 0; mx < cols; ++mx) {
      if (restart_interval && restart_to_go == 0) {
        int64_t p = br.finish();
        if (p < 0) return -2;
        if (p + 1 >= len || data[p] != 0xFF ||
            data[p + 1] != 0xD0 + next_restart)
          return -3;
        br.reset(p + 2);
        next_restart = (next_restart + 1) & 7;
        restart_to_go = restart_interval;
        eobrun = 0;
        memset(last_dc, 0, sizeof(last_dc));
      }
      for (int c = 0; c < ncomp_scan; ++c) {
        int nby = (ncomp_scan == 1) ? 1 : vsamp[c];
        int nbx = (ncomp_scan == 1) ? 1 : hsamp[c];
        for (int iy = 0; iy < nby; ++iy) {
          for (int ix = 0; ix < nbx; ++ix) {
            int by = my * nby + iy;
            int bx = mx * nbx + ix;
            int16_t* block = coeffs[c] + ((int64_t)by * wib[c] + bx) * 64;
            if (ah == 0) {
              // First (or sequential) scan.
              int k0 = ss;
              if (ss == 0) {
                if (!((dc_present >> dc_tbl[c]) & 1)) return -4;
                int s = dc_tables[dc_tbl[c]].decode(&br, &herr);
                if (herr || s >= 12) return -5;
                if (s > 0) s = huff_extend(br.read_bits(s), s);
                s += last_dc[c];
                int dc_coeff = s < 0 ? -((-s) << al) : (s << al);
                if (dc_coeff < -32768 || dc_coeff > 32767) return -6;
                block[0] = (int16_t)dc_coeff;
                last_dc[c] = (int16_t)s;
                k0 = 1;
              }
              if (k0 > se) continue;
              if (eobrun > 0) { eobrun--; continue; }
              if (!((ac_present >> ac_tbl[c]) & 1)) return -7;
              HuffTable& ac = ac_tables[ac_tbl[c]];
              int k = k0;
              for (; k <= se; ++k) {
                int s = ac.decode(&br, &herr);
                if (herr) return -8;
                int r = s >> 4;
                s &= 15;
                if (s > 0) {
                  k += r;
                  if (k > se) return -9;
                  if (s + al >= 12) return -10;
                  s = huff_extend(br.read_bits(s), s);
                  int v = s < 0 ? -((-s) << al) : (s << al);
                  block[kNat[k]] = (int16_t)v;
                } else if (r == 15) {
                  k += 15;
                } else {
                  eobrun = 1 << r;
                  if (r > 0) {
                    if (ss == 0) return -11;
                    eobrun += br.read_bits(r);
                  }
                  break;
                }
              }
              eobrun--;
            } else {
              // Refinement scan (jpeg_data_reader.cc:617-729).
              int k = ss;
              if (ss == 0) {
                int s = br.read_bit();
                block[0] = (int16_t)(block[0] | (s << al));
                k = 1;
              }
              if (k > se) continue;
              int p1 = 1 << al, m1 = -(1 << al);
              bool in_zero_run = false;
              if (eobrun <= 0) {
                if (!((ac_present >> ac_tbl[c]) & 1)) return -7;
                HuffTable& ac = ac_tables[ac_tbl[c]];
                for (; k <= se; ++k) {
                  int s = ac.decode(&br, &herr);
                  if (herr) return -8;
                  int r = s >> 4;
                  s &= 15;
                  if (s) {
                    if (s != 1) return -12;
                    s = br.read_bit() ? p1 : m1;
                    in_zero_run = false;
                  } else {
                    if (r != 15) {
                      eobrun = 1 << r;
                      if (r > 0) {
                        if (ss == 0) return -11;
                        eobrun += br.read_bits(r);
                      }
                      break;
                    }
                    in_zero_run = true;
                  }
                  while (k <= se) {
                    int16_t thiscoef = block[kNat[k]];
                    if (thiscoef != 0) {
                      if (br.read_bit()) {
                        if ((thiscoef & p1) == 0)
                          thiscoef += (thiscoef >= 0) ? p1 : m1;
                      }
                      block[kNat[k]] = thiscoef;
                    } else {
                      if (--r < 0) break;
                    }
                    k++;
                  }
                  if (s) {
                    if (k > se) return -9;
                    block[kNat[k]] = (int16_t)s;
                  }
                }
                if (in_zero_run) return -13;
              }
              if (eobrun > 0) {
                for (; k <= se; ++k) {
                  int16_t thiscoef = block[kNat[k]];
                  if (thiscoef != 0) {
                    if (br.read_bit()) {
                      if ((thiscoef & p1) == 0)
                        thiscoef += (thiscoef >= 0) ? p1 : m1;
                    }
                    block[kNat[k]] = thiscoef;
                  }
                }
              }
              eobrun--;  // unconditional (jpeg_data_reader.cc:729)
            }
          }
        }
      }
      restart_to_go--;
    }
  }
  if (eobrun > 0) return -14;
  int64_t p = br.finish();
  if (p < 0) return -2;
  // Skip to the next marker like the Python reader.
  while (p < len && data[p] != 0xFF) p++;
  while (p + 1 < len && data[p] == 0xFF && data[p + 1] == 0x00) {
    p += 2;
    while (p < len && data[p] != 0xFF) p++;
  }
  return p;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Back-end coefficient flip loop (processor.cc:854-889) with the entropy
// machinery it drives: incremental AC histograms (:491-515), histogram
// clustering + length-limited Huffman codes (jpeg_data_writer.cc:295-342,
// entropy_encode.cc), and entropy-size estimation (:211-232).
// ---------------------------------------------------------------------

#include <algorithm>
#include <vector>

namespace {

constexpr int kHSize = 257;

int64_t histogram_header_cost(const int64_t* h) {
  int64_t bits = 17 * 8;
  for (int i = 0; i + 1 < kHSize; ++i)
    if (h[i] > 0) bits += 8;
  return bits;
}

int64_t histogram_entropy_cost(const int64_t* h, const uint8_t* depths) {
  int64_t bits = 0;
  for (int i = 0; i + 1 < kHSize; ++i)
    bits += (h[i] / 2) * (depths[i] + (i & 0xf));
  bits += (bits * 3 + 512) >> 10;
  return bits;
}

// Exact port of codec/huffman.py create_huffman_tree (two-queue Huffman
// with (count asc, symbol desc) leaf order and doubling count floor).
void create_huffman_tree(const int64_t* counts, int length, int tree_limit,
                         uint8_t* depth) {
  memset(depth, 0, length);
  int64_t count_limit = 1;
  for (;;) {
    struct Leaf { int64_t cnt; int sym; };
    std::vector<Leaf> leaves;
    for (int s = length - 1; s >= 0; --s)
      if (counts[s]) leaves.push_back({std::max(counts[s], count_limit), s});
    int n = (int)leaves.size();
    if (n == 0) return;
    if (n == 1) { depth[leaves[0].sym] = 1; return; }
    std::stable_sort(leaves.begin(), leaves.end(),
                     [](const Leaf& a, const Leaf& b) {
                       return a.cnt != b.cnt ? a.cnt < b.cnt
                                             : a.sym > b.sym;
                     });
    // Two-queue merge; picks reference leaves by index, internals by index.
    struct Node { int64_t cnt; int kind0, idx0, kind1, idx1; };
    std::vector<Node> internal;
    internal.reserve(n);
    int i = 0, j = 0;
    for (int m = 0; m < n - 1; ++m) {
      int kinds[2], idxs[2];
      int64_t c = 0;
      for (int p = 0; p < 2; ++p) {
        int64_t ic = i < n ? leaves[i].cnt : INT64_MAX;
        int64_t jc = j < (int)internal.size() ? internal[j].cnt : INT64_MAX;
        if (ic <= jc) { kinds[p] = 0; idxs[p] = i; c += leaves[i].cnt; i++; }
        else { kinds[p] = 1; idxs[p] = j; c += internal[j].cnt; j++; }
      }
      internal.push_back({c, kinds[0], idxs[0], kinds[1], idxs[1]});
    }
    bool ok = true;
    std::vector<std::pair<int, int>> stack;  // (node, level)
    stack.push_back({(int)internal.size() - 1, 0});
    while (!stack.empty()) {
      auto [node, level] = stack.back();
      stack.pop_back();
      if (level + 1 > tree_limit) { ok = false; break; }
      const Node& nd = internal[node];
      if (nd.kind0 == 0) depth[leaves[nd.idx0].sym] = (uint8_t)(level + 1);
      else stack.push_back({nd.idx0, level + 1});
      if (nd.kind1 == 0) depth[leaves[nd.idx1].sym] = (uint8_t)(level + 1);
      else stack.push_back({nd.idx1, level + 1});
    }
    if (ok) return;
    count_limit *= 2;
  }
}

// codec/histograms.py cluster_histograms / compute_entropy_codes: returns
// the header size (bytes); fills per-input depths [ncomp][257].
int64_t compute_entropy_codes(const int64_t* histos, int ncomp,
                              uint8_t* out_depths) {
  std::vector<int64_t> h(histos, histos + ncomp * kHSize);
  std::vector<uint8_t> depths(ncomp * kHSize, 0);
  std::vector<int64_t> costs(ncomp);
  std::vector<int> indexes(ncomp);
  for (int i = 0; i < ncomp; ++i) {
    indexes[i] = i;
    create_huffman_tree(&h[i * kHSize], kHSize, 16, &depths[i * kHSize]);
    costs[i] = histogram_header_cost(&h[i * kHSize]) +
               histogram_entropy_cost(&h[i * kHSize], &depths[i * kHSize]);
  }
  int num = ncomp;
  while (num > 1) {
    int last = num - 1, second = num - 2;
    std::vector<int64_t> combined(h.begin() + second * kHSize,
                                  h.begin() + (second + 1) * kHSize);
    for (int i = 0; i + 1 < kHSize; ++i) combined[i] += h[last * kHSize + i];
    combined[kHSize - 1] = 1;
    uint8_t d[kHSize];
    create_huffman_tree(combined.data(), kHSize, 16, d);
    int64_t cost = histogram_header_cost(combined.data()) +
                   histogram_entropy_cost(combined.data(), d);
    if (cost < costs[last] + costs[second]) {
      memcpy(&h[second * kHSize], combined.data(),
             kHSize * sizeof(int64_t));
      memset(&h[last * kHSize], 0, kHSize * sizeof(int64_t));
      h[last * kHSize + kHSize - 1] = 1;
      costs[second] = cost;
      memcpy(&depths[second * kHSize], d, kHSize);
      for (int i = 0; i < ncomp; ++i)
        if (indexes[i] == last) indexes[i] = second;
      num--;
    } else {
      break;
    }
  }
  int64_t hdr = 0;
  for (int i = 0; i < num; ++i)
    hdr += histogram_header_cost(&h[i * kHSize]) / 8;
  for (int i = 0; i < ncomp; ++i)
    memcpy(out_depths + i * kHSize, &depths[indexes[i] * kHSize], kHSize);
  return hdr;
}

int64_t entropy_coded_data_size(const int64_t* histos,
                                const uint8_t* depths, int ncomp) {
  int64_t bits = 0;
  for (int i = 0; i < ncomp; ++i)
    bits += histogram_entropy_cost(histos + i * kHSize,
                                   depths + i * kHSize);
  return (bits + 7) / 8;
}

// processor.cc:491-515 on dequantized coefficients.
void update_ac_histogram(int weight, const int32_t* coeffs64,
                         const int32_t* quant64, int64_t* hist) {
  int r = 0;
  int w2 = 2 * weight;
  for (int k = 1; k < 64; ++k) {
    int knat = kNat[k];
    int32_t coeff = coeffs64[knat];
    if (coeff == 0) { r++; continue; }
    while (r > 15) { hist[0xf0] += w2; r -= 16; }
    int v = std::abs(coeff / quant64[knat]);
    int nbits = log2_floor_nonzero((uint32_t)v) + 1;
    hist[(r << 4) + nbits] += w2;
    r = 0;
  }
  if (r > 0) hist[0] += w2;
}

inline int32_t quantize_val(int32_t raw, int32_t quant) {
  int r = raw % quant;
  int32_t delta = 2 * r > quant ? quant - r
                 : (-2) * r > quant ? -quant - r : -r;
  return raw + delta;
}

}  // namespace

extern "C" {

// Run the per-iteration flip loop (processor.cc:854-889). Mutates
// comp_coeffs / last_indexes / ac_histograms / ac_depths in place.
// Returns est_jpg_size; outputs via pointers.
//
// out_flip_{b,idx,val} (capacity order_n each) receive the exact
// (block, c*64+k, new value) triplet of every flip, in flip order --
// the device-side sparse-scatter upload consumes these directly, which
// replaces the caller's numpy reconstruction from last_indexes deltas
// (~0.3-0.5 s/iteration of backend_dispatch at 8 MPix).
//
// The entropy codes are rebuilt (every 10th flip) and the size estimated
// only where a value read later depends on them; *out_rebuilds receives
// the number of rebuilds run.
int64_t gt_backend_flips(
    int32_t* const* comp_coeffs, const int32_t* quant,
    const int16_t* const* jpg_coeffs, const int32_t* jpg_quant,
    const int* jpg_wib, int grid_bw,
    const int64_t* offsets, const int32_t* cand_idx, const float* cand_err,
    int64_t ncand_total, int64_t* last_indexes,
    const int32_t* order_blocks, const float* order_vals, int64_t order_n,
    int direction, int64_t min_coeffs_to_change, double min_size_delta,
    int64_t prev_size, int64_t jpg_header_size, int64_t dc_size,
    int64_t* ac_histograms, uint8_t* ac_depths,
    int64_t* ac_histogram_size, int ncomp, int64_t nb,
    int64_t* out_changed_coeffs, double* out_val_threshold,
    int64_t* out_changed_blocks,
    int32_t* out_flip_b, int32_t* out_flip_idx, int32_t* out_flip_val,
    int64_t* out_rebuilds) {
  std::vector<uint8_t> changed(nb, 0);
  int64_t changed_blocks = 0;
  int64_t changed_coeffs = 0;
  int64_t rebuilds = 0;
  double val_threshold = 0.0;
  int64_t est = prev_size;
  for (int64_t i = 0; i < order_n; ++i) {
    int64_t b = order_blocks[i];
    int64_t last_idx = last_indexes[b];
    int64_t off = std::max<int64_t>(
        0, std::min<int64_t>(offsets[b], ncand_total - 1));
    int idx = cand_idx[off + last_idx + std::min(direction, 0)];
    int c = idx / 64;
    int k = idx % 64;
    const int32_t* qc = quant + c * 64;
    int64_t jpg_block_ix = (b / grid_bw) * jpg_wib[c] + (b % grid_bw);
    int32_t newval;
    if (direction > 0) {
      newval = 0;
    } else {
      int32_t raw = (int32_t)jpg_coeffs[c][jpg_block_ix * 64 + k] *
                    jpg_quant[c * 64 + k];
      newval = quantize_val(raw, qc[k]);
    }
    int32_t* block = comp_coeffs[c] + b * 64;
    update_ac_histogram(-1, block, qc, ac_histograms + c * kHSize);
    block[k] = newval;
    update_ac_histogram(1, block, qc, ac_histograms + c * kHSize);
    last_indexes[b] += direction;
    if (out_flip_b) {
      out_flip_b[changed_coeffs] = (int32_t)b;
      out_flip_idx[changed_coeffs] = idx;
      out_flip_val[changed_coeffs] = newval;
    }
    if (!changed[b]) { changed[b] = 1; changed_blocks++; }
    val_threshold = order_vals[i];
    changed_coeffs++;
    // The stop test reads est only once changed_coeffs (i + 1) passes
    // min_coeffs_to_change, and est is returned after the last flip
    // (i + 1 == order_n). A rebuild at i is read by the flips i..i+9
    // until the next one: the test reads it if i + 9 >= min (i + 10 >
    // min), the caller keeps it if the order ends first (i + 10 >=
    // order_n). The loop stops at a flip the test reads or at the last,
    // so every rebuild whose codes reach an output still runs, on the
    // same histograms.
    if (i % 10 == 0 &&
        (i + 10 > min_coeffs_to_change || i + 10 >= order_n)) {
      *ac_histogram_size =
          compute_entropy_codes(ac_histograms, ncomp, ac_depths);
      rebuilds++;
    }
    if (changed_coeffs > min_coeffs_to_change || i + 1 == order_n) {
      est = jpg_header_size + dc_size + *ac_histogram_size +
            entropy_coded_data_size(ac_histograms, ac_depths, ncomp);
    }
    if (changed_coeffs > min_coeffs_to_change &&
        std::llabs(est - prev_size) > (int64_t)min_size_delta) {
      break;
    }
  }
  *out_rebuilds = rebuilds;
  *out_changed_coeffs = changed_coeffs;
  *out_val_threshold = val_threshold;
  *out_changed_blocks = changed_blocks;
  return est;
}

// search/state.quantize (guetzli/quantize.h): round every coefficient of
// [nb, 64] blocks to the nearest multiple of quant[64], C truncation.
// In place; the numpy form costs ~0.1 s/MPix per accepted quant trial.
int64_t gt_quantize_blocks(int32_t* coeffs, const int32_t* quant,
                           int64_t nb) {
  for (int64_t b = 0; b < nb; ++b) {
    int32_t* c = coeffs + b * 64;
    for (int k = 0; k < 64; ++k) c[k] = quantize_val(c[k], quant[k]);
  }
  return 0;
}

// codec/histograms.build_ac_histogram on already-quantized natural-order
// [nb, 64] int16 blocks (UpdateACHistogramForDCTBlock,
// jpeg_data_writer.cc:188-209): symbols double-counted into hist[257].
int64_t gt_ac_histogram(const int16_t* coeffs, int64_t nb, int64_t* hist) {
  for (int64_t b = 0; b < nb; ++b) {
    const int16_t* c = coeffs + b * 64;
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      int32_t v = c[kNat[k]];
      if (v == 0) { r++; continue; }
      while (r > 15) { hist[0xf0] += 2; r -= 16; }
      int nbits = log2_floor_nonzero((uint32_t)std::abs(v)) + 1;
      hist[(r << 4) + nbits] += 2;
      r = 0;
    }
    if (r > 0) hist[0] += 2;
  }
  return 0;
}

}  // extern "C"
