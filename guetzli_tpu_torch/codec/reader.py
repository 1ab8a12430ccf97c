"""JPEG parser: bytes -> JpegData with DCT coefficients.

Mirrors guetzli/jpeg_data_reader.cc (baseline + progressive including
spectral selection, successive approximation and refinement scans, restart
markers, 8/16-bit DQT, multi-table DHT) with the same validation rules, so
inputs the reference accepts/rejects are accepted/rejected identically.
Serial Huffman decoding lives in _decode_scan; a native C++ fast path can
replace it transparently (same contract). A copy of
guetzli_tpu/codec/reader.py: the port imports nothing of that package.
"""

import numpy as np

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.codec import jpeg_data as jd

_NAT = consts.JPEG_NATURAL_ORDER

K_MAX_COMPONENTS = 4
K_DC_ALPHABET = 12
K_MAX_QUANT_TABLES = 4
K_MAX_HUFFMAN_TABLES = 4


class JpegError(ValueError):
    pass


class _BitReaderPos:
    """Bit reader that tracks exact byte positions (including unstuffing)
    so restart markers and scan ends can be located."""

    def __init__(self, data, pos):
        self.data = data
        self.n = len(data)
        self.reset(pos)

    def reset(self, pos):
        self.pos = pos          # next byte to consume
        self.bitpos = 0         # bits consumed from current byte
        self.cur = self.data[self.pos] if self.pos < self.n else 0
        self.overread = False

    def _advance_byte(self):
        p = self.pos
        if p < self.n and self.data[p] == 0xFF:
            nxt = self.data[p + 1] if p + 1 < self.n else 0xD9
            if nxt == 0:
                self.pos = p + 2
            else:
                # At a marker: stay, deliver zero bits.
                self.pos = p
                self.cur = None
                return
        else:
            self.pos = p + 1
        self.cur = self.data[self.pos] if self.pos < self.n else None

    def read_bit(self):
        if self.pos >= self.n:
            self.overread = True
            return 0
        byte = self.data[self.pos]
        if byte == 0xFF:
            nxt = self.data[self.pos + 1] if self.pos + 1 < self.n else 0xD9
            if nxt != 0x00:
                # Hitting a marker: zero-pad (reference behavior).
                return 0
        bit = (byte >> (7 - self.bitpos)) & 1
        self.bitpos += 1
        if self.bitpos == 8:
            self.bitpos = 0
            if byte == 0xFF:
                self.pos += 2   # skip the stuffed 0x00
            else:
                self.pos += 1
        return bit

    def read_bits(self, nbits):
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.read_bit()
        return v

    def finish_stream(self):
        """Skip to the next byte boundary; returns byte position."""
        if self.bitpos > 0:
            byte = self.data[self.pos]
            self.bitpos = 0
            if byte == 0xFF:
                self.pos += 2
            else:
                self.pos += 1
        if self.overread:
            raise JpegError("unexpected end of scan data")
        return self.pos


class _HuffTable:
    """Canonical Huffman decoder (mincode/maxcode/valptr)."""

    def __init__(self, counts, values):
        self.counts = counts
        self.values = values
        code = 0
        k = 0
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        for ln in range(1, 17):
            self.valptr[ln] = k
            self.mincode[ln] = code
            code += counts[ln]
            k += counts[ln]
            self.maxcode[ln] = code - 1
            code <<= 1

    def decode(self, br):
        code = br.read_bit()
        ln = 1
        while code > self.maxcode[ln]:
            if ln >= 16:
                raise JpegError("invalid Huffman code")
            code = (code << 1) | br.read_bit()
            ln += 1
        idx = self.valptr[ln] + code - self.mincode[ln]
        if idx >= len(self.values):
            raise JpegError("invalid Huffman code index")
        return self.values[idx]


def _huff_extend(r, s):
    if r < (1 << (s - 1)):
        return r - (1 << s) + 1
    return r


def peek_dimensions(data: bytes):
    """(width, height) from the SOF header without decoding scans
    (the reference's JPEG_READ_HEADER mode used by the memory guard,
    guetzli.cc:329-339). Returns None if no SOF is found."""
    data = bytes(data)
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    pos = 2
    while pos + 3 < n:
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        pos += 2
        if 0xC0 <= marker <= 0xC2:
            if pos + 7 >= n:
                return None
            h = (data[pos + 3] << 8) | data[pos + 4]
            w = (data[pos + 5] << 8) | data[pos + 6]
            return w, h
        if marker == 0xD9 or marker == 0xDA:
            return None
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        ln = (data[pos] << 8) | data[pos + 1]
        pos += max(ln, 2)
    return None


def read_jpeg(data: bytes) -> jd.JpegData:
    """ReadJpeg(..., JPEG_READ_ALL) (jpeg_data_reader.cc:931-1080). Raises
    JpegError for data it cannot read, a truncated marker segment among
    them (the JAX package's reader raises IndexError there)."""
    try:
        return _read_jpeg(data)
    except IndexError:
        raise JpegError("truncated JPEG data") from None


def _read_jpeg(data: bytes) -> jd.JpegData:
    data = bytes(data)
    n = len(data)
    if n < 2 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("no SOI marker")

    jpg = jd.JpegData()
    pos = 2
    dc_tables = {}
    ac_tables = {}
    found_sof = False
    found_eoi = False
    scan_progression = None

    while pos < n:
        if data[pos] != 0xFF:
            raise JpegError("expected marker at %d" % pos)
        marker = data[pos + 1]
        pos += 2

        if marker == 0xD9:                 # EOI
            jpg.marker_order.append(marker)
            found_eoi = True
            jpg.tail_data = data[pos:]
            break
        elif 0xC0 <= marker <= 0xC2:       # SOF0/1/2
            jpg.marker_order.append(marker)
            if found_sof:
                raise JpegError("duplicate SOF")
            found_sof = True
            pos = _process_sof(data, pos, marker, jpg)
            scan_progression = np.zeros((len(jpg.components), 64),
                                        dtype=np.uint16)
        elif marker == 0xC4:               # DHT
            jpg.marker_order.append(marker)
            pos = _process_dht(data, pos, jpg, dc_tables, ac_tables)
        elif marker == 0xDB:               # DQT
            jpg.marker_order.append(marker)
            pos = _process_dqt(data, pos, jpg)
        elif marker == 0xDD:               # DRI
            jpg.marker_order.append(marker)
            ln = (data[pos] << 8) | data[pos + 1]
            if ln != 4:
                raise JpegError("invalid DRI length")
            jpg.restart_interval = (data[pos + 2] << 8) | data[pos + 3]
            pos += 4
        elif marker == 0xDA:               # SOS
            jpg.marker_order.append(marker)
            pos = _process_sos(data, pos, jpg, dc_tables, ac_tables,
                               scan_progression)
        elif 0xE0 <= marker <= 0xEF:       # APPn
            jpg.marker_order.append(marker)
            ln = (data[pos] << 8) | data[pos + 1]
            jpg.app_data.append(bytes([marker]) + data[pos:pos + ln])
            pos += ln
        elif marker == 0xFE:               # COM
            jpg.marker_order.append(marker)
            ln = (data[pos] << 8) | data[pos + 1]
            jpg.com_data.append(data[pos:pos + ln])
            pos += ln
        elif marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pass                           # standalone markers
        else:
            # Unknown marker with payload: skip (reference logs + errors on
            # truly invalid ones; be tolerant like FindNextMarker).
            ln = (data[pos] << 8) | data[pos + 1]
            jpg.inter_marker_data.append(data[pos:pos + ln])
            pos += ln

    if not found_sof:
        raise JpegError("no SOF marker")
    if not found_eoi:
        raise JpegError("no EOI marker")

    # Dequantization sanity limit is the caller's job (CheckJpegSanity).
    return jpg


def _process_sof(data, pos, marker, jpg):
    """jpeg_data_reader.cc:87-167."""
    ln = (data[pos] << 8) | data[pos + 1]
    precision = data[pos + 2]
    if precision != 8:
        raise JpegError("only 8-bit precision supported")
    jpg.height = (data[pos + 3] << 8) | data[pos + 4]
    jpg.width = (data[pos + 5] << 8) | data[pos + 6]
    ncomp = data[pos + 7]
    if jpg.height == 0 or jpg.width == 0:
        raise JpegError("empty image")
    if ncomp == 0 or ncomp > K_MAX_COMPONENTS:
        raise JpegError("bad component count")
    p = pos + 8
    max_h = max_v = 1
    ids = set()
    for _ in range(ncomp):
        comp = jd.Component()
        comp.id = data[p]
        if comp.id in ids:
            raise JpegError("duplicate component id")
        ids.add(comp.id)
        comp.h_samp_factor = data[p + 1] >> 4
        comp.v_samp_factor = data[p + 1] & 0xF
        if not (1 <= comp.h_samp_factor <= 15) or \
                not (1 <= comp.v_samp_factor <= 15):
            raise JpegError("bad sampling factor")
        comp.quant_idx = data[p + 2]
        if comp.quant_idx >= K_MAX_QUANT_TABLES:
            raise JpegError("bad quant table index")
        max_h = max(max_h, comp.h_samp_factor)
        max_v = max(max_v, comp.v_samp_factor)
        jpg.components.append(comp)
        p += 3
    jpg.max_h_samp_factor = max_h
    jpg.max_v_samp_factor = max_v
    jpg.MCU_rows = -(-jpg.height // (8 * max_v))
    jpg.MCU_cols = -(-jpg.width // (8 * max_h))
    for comp in jpg.components:
        if max_h % comp.h_samp_factor or max_v % comp.v_samp_factor:
            raise JpegError("non-integral subsampling ratio")
        comp.width_in_blocks = jpg.MCU_cols * comp.h_samp_factor
        comp.height_in_blocks = jpg.MCU_rows * comp.v_samp_factor
        if comp.width_in_blocks * comp.height_in_blocks > (1 << 21):
            pass  # reference guards 1<<21 blocks via uint64 check
        comp.coeffs = np.zeros((comp.width_in_blocks
                                * comp.height_in_blocks, 64), dtype=np.int16)
    # Map quant table ids to indexes into jpg.quant.
    for comp in jpg.components:
        found = False
        for i, q in enumerate(jpg.quant):
            if q.index == comp.quant_idx:
                comp.quant_idx = i
                found = True
                break
        if not found:
            raise JpegError("quant table not found for component")
    return pos + ln


def _process_dqt(data, pos, jpg):
    """jpeg_data_reader.cc:344-377."""
    ln = (data[pos] << 8) | data[pos + 1]
    end = pos + ln
    p = pos + 2
    while p < end:
        pq_tq = data[p]
        p += 1
        precision = pq_tq >> 4
        index = pq_tq & 0xF
        if precision > 1 or index >= K_MAX_QUANT_TABLES:
            raise JpegError("bad DQT")
        values = np.zeros(64, dtype=np.int32)
        for k in range(64):
            if precision:
                v = (data[p] << 8) | data[p + 1]
                p += 2
            else:
                v = data[p]
                p += 1
            if v == 0:
                raise JpegError("zero quant value")
            values[_NAT[k]] = v
        table = jd.QuantTable(values, precision=precision, index=index,
                              is_last=(p >= end))
        jpg.quant.append(table)
    return end


def _process_dht(data, pos, jpg, dc_tables, ac_tables):
    """jpeg_data_reader.cc:251-342."""
    ln = (data[pos] << 8) | data[pos + 1]
    end = pos + ln
    p = pos + 2
    if p == end:
        raise JpegError("empty DHT")
    while p < end:
        slot_id = data[p]
        p += 1
        is_ac = slot_id & 0x10
        idx = slot_id & 0xF
        if idx >= K_MAX_HUFFMAN_TABLES:
            raise JpegError("bad huffman slot")
        counts = np.zeros(17, dtype=np.int32)
        total = 0
        space = 65536
        max_len = 0
        for i in range(1, 17):
            c = data[p]
            p += 1
            if c:
                max_len = i
            counts[i] = c
            total += c
            space -= c * (1 << (16 - i))
        if not is_ac and total > K_DC_ALPHABET:
            raise JpegError("DC alphabet too large")
        values = np.zeros(total, dtype=np.int32)
        seen = set()
        for i in range(total):
            v = data[p]
            p += 1
            if not is_ac and v >= K_DC_ALPHABET:
                raise JpegError("bad DC huffman value")
            if v in seen:
                raise JpegError("duplicate huffman value")
            seen.add(v)
            values[i] = v
        if total and space < 0:
            raise JpegError("overpopulated huffman code")
        table = _HuffTable(counts.tolist(), values.tolist())
        if is_ac:
            ac_tables[idx] = table
        else:
            dc_tables[idx] = table
        jpg.huffman_code.append(jd.HuffmanCode(
            counts=counts, values=values, slot_id=slot_id,
            is_last=(p >= end)))
    return end


def _process_sos(data, pos, jpg, dc_tables, ac_tables, scan_progression):
    """jpeg_data_reader.cc:169-249 + ProcessScan :755-909."""
    ln = (data[pos] << 8) | data[pos + 1]
    ncomp_scan = data[pos + 2]
    if ncomp_scan == 0 or ncomp_scan > len(jpg.components):
        raise JpegError("bad scan component count")
    p = pos + 3
    scan = jd.ScanInfo()
    for _ in range(ncomp_scan):
        comp_id = data[p]
        table = data[p + 1]
        p += 2
        comp_idx = None
        for i, c in enumerate(jpg.components):
            if c.id == comp_id:
                comp_idx = i
        if comp_idx is None:
            raise JpegError("scan references unknown component")
        if (table >> 4) >= K_MAX_HUFFMAN_TABLES or \
                (table & 0xF) >= K_MAX_HUFFMAN_TABLES:
            raise JpegError("bad Huffman table index in scan")
        scan.components.append(jd.ScanComponentInfo(
            comp_idx=comp_idx, dc_tbl_idx=table >> 4,
            ac_tbl_idx=table & 0xF))
    scan.Ss = data[p]
    scan.Se = data[p + 1]
    ah_al = data[p + 2]
    scan.Ah = ah_al >> 4
    scan.Al = ah_al & 0xF
    p += 3
    jpg.scan_info.append(scan)

    is_progressive = 0xC2 in jpg.marker_order
    if not (0 <= scan.Ss <= 63 and scan.Ss <= scan.Se <= 63):
        raise JpegError("bad spectral band")
    if scan.Ah not in range(14) or scan.Al not in range(14):
        raise JpegError("bad successive approximation")

    # Update scan progression (jpeg_data_reader.cc:793-830).
    for si in scan.components:
        for k in range(scan.Ss, scan.Se + 1):
            word = int(scan_progression[si.comp_idx][k])
            if scan.Ah == 0:
                if word & ((1 << 16) >> 1):
                    raise JpegError("duplicate first scan for coefficient")
                scan_progression[si.comp_idx][k] = \
                    (word | (1 << 15) | (((1 << scan.Al) - 1) & 0xFFFF)) \
                    & 0xFFFF
            else:
                refinement = word & 0xFFF
                if refinement != (1 << scan.Ah) - 1:
                    raise JpegError("refinement scan out of order")
                scan_progression[si.comp_idx][k] = \
                    (word & ~(1 << scan.Al)) & 0xFFFF

    # jpeg_data_reader.cc:811-815: Al > 10 would make the shifted AC
    # coefficients non-representable in guetzli's coeff_t.
    if is_progressive and scan.Al > 10:
        raise JpegError("scan parameter Al is not supported in guetzli")

    return _decode_scan(data, p, jpg, scan, dc_tables, ac_tables,
                        is_progressive)


def _single_scan_grid(jpg, comp):
    """Scan grid for a non-interleaved (single-component) scan.

    jpeg_data_reader.cc:770-778: DivCeil(width*h_samp, 8*max_h) columns by
    DivCeil(height*v_samp, 8*max_v) rows. Differs from the MCU-padded
    width_in_blocks grid whenever width or height mod (8*max/samp) leaves a
    partial MCU (e.g. 4:2:0 luma with width mod 16 in 1..8).
    """
    cols = -(-(jpg.width * comp.h_samp_factor) //
             (8 * jpg.max_h_samp_factor))
    rows = -(-(jpg.height * comp.v_samp_factor) //
             (8 * jpg.max_v_samp_factor))
    return cols, rows


def _decode_scan_native(data, pos, jpg, scan, dc_tables, ac_tables,
                        is_progressive):
    """C++ fast path for the scan decode; None if unavailable."""
    import ctypes

    from guetzli_tpu_torch import native
    lib = native.get_lib()
    if lib is None:
        return None
    if is_progressive:
        ss, se, ah, al = scan.Ss, scan.Se, scan.Ah, scan.Al
    else:
        ss, se, ah, al = 0, 63, 0, 0
    n = len(scan.components)
    dc_counts = np.zeros((4, 17), dtype=np.int32)
    dc_values = np.zeros((4, 256), dtype=np.int32)
    ac_counts = np.zeros((4, 17), dtype=np.int32)
    ac_values = np.zeros((4, 256), dtype=np.int32)
    dc_present = ac_present = 0
    for idx, t in dc_tables.items():
        dc_counts[idx] = t.counts
        dc_values[idx, :len(t.values)] = t.values
        dc_present |= 1 << idx
    for idx, t in ac_tables.items():
        ac_counts[idx] = t.counts
        ac_values[idx, :len(t.values)] = t.values
        ac_present |= 1 << idx

    dc_tbl = (ctypes.c_int * n)()
    ac_tbl = (ctypes.c_int * n)()
    wib = (ctypes.c_int * n)()
    hib = (ctypes.c_int * n)()
    hsamp = (ctypes.c_int * n)()
    vsamp = (ctypes.c_int * n)()
    ptrs = (ctypes.POINTER(ctypes.c_int16) * n)()
    bufs = []
    for i, si in enumerate(scan.components):
        comp = jpg.components[si.comp_idx]
        dc_tbl[i] = si.dc_tbl_idx
        ac_tbl[i] = si.ac_tbl_idx
        wib[i] = comp.width_in_blocks
        hib[i] = comp.height_in_blocks
        hsamp[i] = comp.h_samp_factor
        vsamp[i] = comp.v_samp_factor
        buf = np.ascontiguousarray(comp.coeffs, dtype=np.int16)
        bufs.append((si.comp_idx, buf))
        ptrs[i] = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
    if n == 1:
        scan_cols, scan_rows = _single_scan_grid(
            jpg, jpg.components[scan.components[0].comp_idx])
    else:
        scan_rows, scan_cols = jpg.MCU_rows, jpg.MCU_cols
    arr = np.frombuffer(data, dtype=np.uint8)
    res = lib.gt_decode_scan(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(data)), ctypes.c_int64(pos),
        ctypes.c_int(n), None, dc_tbl, ac_tbl, wib, hib, hsamp, vsamp,
        ptrs, ctypes.c_int(scan_rows), ctypes.c_int(scan_cols),
        ctypes.c_int(jpg.restart_interval),
        ctypes.c_int(ss), ctypes.c_int(se), ctypes.c_int(ah),
        ctypes.c_int(al),
        dc_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dc_values.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ac_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ac_values.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(dc_present), ctypes.c_int(ac_present))
    if res < 0:
        raise JpegError("scan decode failed (native code %d)" % res)
    for comp_idx, buf in bufs:
        jpg.components[comp_idx].coeffs = buf
    return int(res)


def _decode_scan(data, pos, jpg, scan, dc_tables, ac_tables,
                 is_progressive):
    """The MCU/Huffman-decode loop (ProcessScan, jpeg_data_reader.cc:755)."""
    res = _decode_scan_native(data, pos, jpg, scan, dc_tables, ac_tables,
                              is_progressive)
    if res is not None:
        return res
    if is_progressive:
        ss, se, ah, al = scan.Ss, scan.Se, scan.Ah, scan.Al
    else:
        ss, se, ah, al = 0, 63, 0, 0
    br = _BitReaderPos(data, pos)
    eobrun = [0]
    last_dc = [0] * len(scan.components)
    next_restart = 0
    restart_to_go = jpg.restart_interval

    if len(scan.components) == 1:
        si = scan.components[0]
        comp = jpg.components[si.comp_idx]
        # Non-interleaved: MCU = one block of this component, but the scan
        # grid is DivCeil(width*h_samp, 8*max_h) x DivCeil(height*v_samp,
        # 8*max_v) (jpeg_data_reader.cc:770-778) — NOT the MCU-padded
        # width_in_blocks grid; width_in_blocks stays the storage stride.
        mcu_cols, mcu_rows = _single_scan_grid(jpg, comp)
        blocks_per_mcu = [(si, 0, 0, 1)]
    else:
        mcu_cols = jpg.MCU_cols
        mcu_rows = jpg.MCU_rows
        blocks_per_mcu = None

    def decode_block(si, by, bx):
        comp = jpg.components[si.comp_idx]
        block_ix = by * comp.width_in_blocks + bx
        coeffs = comp.coeffs[block_ix]
        if ah == 0:
            dc = dc_tables.get(si.dc_tbl_idx)
            ac = ac_tables.get(si.ac_tbl_idx)
            # The DC table is unused for Ss>0 AC scans and the AC table for
            # pure-DC scans; only demand what the scan actually reads
            # (jpeg_data_reader.cc:841-849 indexes the LUT lazily).
            if ss == 0 and dc is None:
                raise JpegError("scan references undefined DC table")
            if se > 0 and ss <= se and ac is None:
                raise JpegError("scan references undefined AC table")
            _decode_dct_block(dc, ac, ss, se, al, eobrun, br,
                              last_dc, scan.components.index(si), coeffs)
        else:
            ac = ac_tables.get(si.ac_tbl_idx)
            if se > 0 and ac is None:
                raise JpegError("scan references undefined AC table")
            _refine_dct_block(ac, ss, se, al, eobrun, br, coeffs)

    for my in range(mcu_rows):
        for mx in range(mcu_cols):
            if jpg.restart_interval and restart_to_go == 0:
                p = br.finish_stream()
                if p + 1 >= len(data) or data[p] != 0xFF or \
                        data[p + 1] != 0xD0 + next_restart:
                    raise JpegError("missing restart marker")
                br.reset(p + 2)
                next_restart = (next_restart + 1) & 7
                restart_to_go = jpg.restart_interval
                eobrun[0] = 0
                for i in range(len(last_dc)):
                    last_dc[i] = 0
            if len(scan.components) == 1:
                decode_block(scan.components[0], my, mx)
            else:
                for si in scan.components:
                    comp = jpg.components[si.comp_idx]
                    for iy in range(comp.v_samp_factor):
                        for ix in range(comp.h_samp_factor):
                            by = my * comp.v_samp_factor + iy
                            bx = mx * comp.h_samp_factor + ix
                            decode_block(si, by, bx)
            restart_to_go -= 1

    if eobrun[0] > 0:
        raise JpegError("unfinished end-of-block run")
    p = br.finish_stream()
    # Skip up to the next marker.
    while p < len(data) and data[p] != 0xFF:
        p += 1
    while p + 1 < len(data) and data[p] == 0xFF and data[p + 1] == 0x00:
        p += 2
        while p < len(data) and data[p] != 0xFF:
            p += 1
    return p


def _decode_dct_block(dc_huff, ac_huff, ss, se, al, eobrun, br,
                      last_dc, comp_pos, coeffs):
    """jpeg_data_reader.cc:531-615."""
    eobrun_allowed = ss > 0
    k0 = ss
    if ss == 0:
        s = dc_huff.decode(br)
        if s >= K_DC_ALPHABET:
            raise JpegError("invalid DC symbol")
        if s > 0:
            r = br.read_bits(s)
            s = _huff_extend(r, s)
        s += last_dc[comp_pos]
        dc_coeff = s << al if s >= 0 else -((-s) << al)
        if not (-32768 <= dc_coeff <= 32767):
            raise JpegError("non-representable DC coefficient")
        coeffs[0] = dc_coeff
        last_dc[comp_pos] = s
        k0 = 1
    if k0 > se:
        return
    if eobrun[0] > 0:
        eobrun[0] -= 1
        return
    k = k0
    while k <= se:
        s = ac_huff.decode(br)
        r = s >> 4
        s &= 15
        if s > 0:
            k += r
            if k > se:
                raise JpegError("out-of-band coefficient")
            if s + al >= K_DC_ALPHABET:
                raise JpegError("out-of-range AC value")
            rr = br.read_bits(s)
            s = _huff_extend(rr, s)
            v = s << al if s >= 0 else -((-s) << al)
            coeffs[_NAT[k]] = v
        elif r == 15:
            k += 15
        else:
            eobrun[0] = 1 << r
            if r > 0:
                if not eobrun_allowed:
                    raise JpegError("EOB run crossing DC")
                eobrun[0] += br.read_bits(r)
            break
        k += 1
    eobrun[0] -= 1


def _refine_dct_block(ac_huff, ss, se, al, eobrun, br, coeffs):
    """jpeg_data_reader.cc:617-729."""
    eobrun_allowed = ss > 0
    k = ss
    if ss == 0:
        s = br.read_bits(1)
        coeffs[0] = np.int16(coeffs[0] | (s << al))
        k = 1
    if k > se:
        return
    p1 = 1 << al
    m1 = -(1 << al)
    in_zero_run = False
    if eobrun[0] <= 0:
        while k <= se:
            s = ac_huff.decode(br)
            r = s >> 4
            s &= 15
            if s:
                if s != 1:
                    raise JpegError("invalid refinement symbol")
                s = p1 if br.read_bits(1) else m1
                in_zero_run = False
            else:
                if r != 15:
                    eobrun[0] = 1 << r
                    if r > 0:
                        if not eobrun_allowed:
                            raise JpegError("EOB run crossing DC")
                        eobrun[0] += br.read_bits(r)
                    break
                in_zero_run = True
            while k <= se:
                nat = _NAT[k]
                thiscoef = int(coeffs[nat])
                if thiscoef != 0:
                    if br.read_bits(1):
                        if (thiscoef & p1) == 0:
                            thiscoef += p1 if thiscoef >= 0 else m1
                    coeffs[nat] = thiscoef
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > se:
                    raise JpegError("out-of-band coefficient")
                coeffs[_NAT[k]] = s
            k += 1
        if in_zero_run:
            raise JpegError("extra zero run before end-of-block")
    if eobrun[0] > 0:
        while k <= se:
            nat = _NAT[k]
            thiscoef = int(coeffs[nat])
            if thiscoef != 0:
                if br.read_bits(1):
                    if (thiscoef & p1) == 0:
                        thiscoef += p1 if thiscoef >= 0 else m1
                coeffs[nat] = thiscoef
            k += 1
    eobrun[0] -= 1


def has_ycbcr_colorspace(jpg) -> bool:
    """jpeg_data_decoder.cc:26-43 colorspace heuristic (libjpeg mimic).

    Exact mirror of the reference: any APP0 segment => YCbCr immediately;
    any APP14 of size >= 15 latches the Adobe transform at fixed offset
    app[14] (no 'Adobe' string check); otherwise fall through to the
    R/G/B component-id check.
    """
    has_adobe = False
    transform = 0
    for app in jpg.app_data:
        if app[0] == 0xE0:
            return True
        if app[0] == 0xEE and len(app) >= 15:
            has_adobe = True
            transform = app[14]
    if has_adobe:
        return transform != 0
    ids = [c.id for c in jpg.components[:3]]
    return ids != [ord('R'), ord('G'), ord('B')]


def check_jpeg_sanity(jpg) -> bool:
    """processor.cc:118-131: |coeff * quant| <= 4096."""
    for comp in jpg.components:
        q = jpg.quant[comp.quant_idx].values.astype(np.int64)
        prod = comp.coeffs.astype(np.int64) * q[None, :]
        if np.abs(prod).max(initial=0) > 4096:
            return False
    return True
