"""BAM container parsing/writing and the columnar record batch model.

The reference streams one `bam1_t` at a time through htslib
(src/gencore.cpp:205). This engine instead decodes the BAM payload
into a columnar struct-of-arrays batch (`RecordBatch`) so that clustering
becomes sort-by-key and the consensus kernels see dense tensors. Raw record
blobs are retained so output records can be re-emitted byte-faithfully with
only the reference's edits applied (seq/qual rewrite, NM adjust, qname copy,
FR/RR append — src/group.cpp:503-573, src/bamutil.cpp:338-366,
src/pair.cpp:54-68).

Fast path: native/gcio.cpp (C++, zlib, threaded). This module is the
pure-Python spec implementation and fallback.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from gencore_tpu.io import bgzf

BAM_MAGIC = b"BAM\x01"

# flag bits (SAM spec; reference src/bamutil.cpp:368-377)
FPAIRED = 1
FPROPER_PAIR = 2
FUNMAP = 4
FMUNMAP = 8
FREVERSE = 16
FMREVERSE = 32
FREAD1 = 64
FREAD2 = 128
FSECONDARY = 256
FQCFAIL = 512
FDUP = 1024
FSUPPLEMENTARY = 2048

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
_BASE_TO_NT16 = {c: i for i, c in enumerate(SEQ_NT16_STR)}
_BASE_TO_NT16["N"] = 15


def padded_qname_len(qname_len: int) -> int:
    """htslib in-memory l_qname (name + NUL + extranul padding to 4 bytes).

    The reference compares qname lengths via bam1_t.core.l_qname which
    includes this padding (src/group.cpp:94,114-123); we reproduce it for
    tie-break fidelity.
    """
    return ((qname_len + 4) // 4) * 4


@dataclass
class BamHeader:
    text: bytes = b""
    names: list = field(default_factory=list)     # contig names (str)
    lengths: list = field(default_factory=list)   # contig lengths (int)

    @property
    def n_targets(self) -> int:
        return len(self.names)

    def encode(self) -> bytes:
        out = [BAM_MAGIC, struct.pack("<i", len(self.text)), self.text,
               struct.pack("<i", len(self.names))]
        for name, ln in zip(self.names, self.lengths):
            nb = name.encode() + b"\x00"
            out.append(struct.pack("<i", len(nb)))
            out.append(nb)
            out.append(struct.pack("<i", ln))
        return b"".join(out)


class RecordBatch:
    """Columnar view over a buffer of BAM alignment records.

    `data` is either the raw decompressed payload (records in place, each
    preceded by its 4-byte block_size — the zero-copy native path) or a
    concatenated bodies buffer; `off[i]`/`end[i]` delimit record i's body
    (32 fixed bytes + variable part). Fixed fields are decoded as
    vectorized numpy gathers.
    """

    FIXED = 32

    def __init__(self, data: np.ndarray, off: np.ndarray, end: np.ndarray = None):
        self.data = data          # uint8[total]
        if end is None:
            # concatenated form: off is int64[n+1]
            end = off[1:]
            off = off[:-1]
        self.off = off            # int64[n] body starts
        self.end = end            # int64[n] body ends
        self.n = len(off)
        o = off
        self.tid = self._i32(o, 0)
        self.pos = self._i32(o, 4)
        l_read_name = self._u8(o, 8).astype(np.int32)
        self.mapq = self._u8(o, 9)
        self.bin = self._u16(o, 10)
        self.n_cigar = self._u16(o, 12).astype(np.int32)
        self.flag = self._u16(o, 14)
        self.l_qseq = self._i32(o, 16)
        self.mtid = self._i32(o, 20)
        self.mpos = self._i32(o, 24)
        self.isize = self._i32(o, 28)
        self.l_read_name = l_read_name
        # derived offsets within each record body
        self.qname_off = o + self.FIXED
        self.cigar_off = self.qname_off + l_read_name
        self.seq_off = self.cigar_off + 4 * self.n_cigar
        self.qual_off = self.seq_off + ((self.l_qseq + 1) >> 1)
        self.aux_off = self.qual_off + self.l_qseq

    # --- vectorized field gathers ---
    def _u8(self, o, d):
        return self.data[o + d]

    def _u16(self, o, d):
        return (self.data[o + d].astype(np.uint16)
                | (self.data[o + d + 1].astype(np.uint16) << 8))

    def _i32(self, o, d):
        v = (self.data[o + d].astype(np.uint32)
             | (self.data[o + d + 1].astype(np.uint32) << 8)
             | (self.data[o + d + 2].astype(np.uint32) << 16)
             | (self.data[o + d + 3].astype(np.uint32) << 24))
        return v.astype(np.int32)

    # --- per-record accessors (python-level; used on small sets) ---
    def record_bytes(self, i: int) -> bytes:
        return self.data[self.off[i]:self.end[i]].tobytes()

    def qname(self, i: int) -> bytes:
        raw = self.data[self.qname_off[i]:self.cigar_off[i]].tobytes()
        return raw.split(b"\x00", 1)[0]

    def cigar(self, i: int) -> np.ndarray:
        return self.data[self.cigar_off[i]:self.seq_off[i]].view(np.uint32)

    def seq_packed(self, i: int) -> np.ndarray:
        return self.data[self.seq_off[i]:self.qual_off[i]]

    def seq_codes(self, i: int) -> np.ndarray:
        """Per-base 4-bit codes unpacked to uint8[l_qseq]."""
        packed = self.seq_packed(i)
        n = int(self.l_qseq[i])
        out = np.empty(n, dtype=np.uint8)
        out[0::2] = packed[: (n + 1) // 2] >> 4
        out[1::2] = packed[: n // 2] & 0xF
        return out

    def qual(self, i: int) -> np.ndarray:
        return self.data[self.qual_off[i]:self.aux_off[i]]

    def aux(self, i: int) -> np.ndarray:
        return self.data[self.aux_off[i]:self.end[i]]

    def qnames_all(self) -> list:
        """All qnames as a list of bytes (vector-friendly packing later)."""
        return [self.qname(i) for i in range(self.n)]

    def seq_matrix(self, idx: np.ndarray, max_len: int) -> np.ndarray:
        """Gather unpacked seq codes for records idx into [len(idx), max_len]
        (0-padded). Native threaded unpack when available."""
        idx = np.asarray(idx)
        from gencore_tpu.io import native
        if native.get_lib() is not None and self.data.flags.c_contiguous:
            out = native.unpack_seq_rows(self.data, self.seq_off[idx],
                                         self.l_qseq[idx], max_len)
            if out is not None:
                return out
        k = len(idx)
        nbytes = (max_len + 1) // 2
        cols = np.arange(nbytes, dtype=np.int64)
        gidx = self.seq_off[idx][:, None] + cols[None, :]
        # clamp gathers beyond each record's seq bytes; mask after
        np.minimum(gidx, len(self.data) - 1, out=gidx)
        packed = self.data[gidx]
        out = np.empty((k, nbytes * 2), dtype=np.uint8)
        out[:, 0::2] = packed >> 4
        out[:, 1::2] = packed & 0xF
        out = out[:, :max_len]
        lens = self.l_qseq[idx]
        mask = np.arange(max_len)[None, :] < lens[:, None]
        out[~mask] = 0
        return out

    def qual_matrix(self, idx: np.ndarray, max_len: int) -> np.ndarray:
        idx = np.asarray(idx)
        from gencore_tpu.io import native
        if native.get_lib() is not None and self.data.flags.c_contiguous:
            out = native.copy_rows(self.data, self.qual_off[idx],
                                   self.l_qseq[idx], max_len)
            if out is not None:
                return out
        cols = np.arange(max_len, dtype=np.int64)
        gidx = self.qual_off[idx][:, None] + cols[None, :]
        np.minimum(gidx, len(self.data) - 1, out=gidx)
        out = self.data[gidx].copy()
        lens = self.l_qseq[idx]
        mask = cols[None, :] < lens[:, None]
        out[~mask] = 0
        return out

    # --- aux tag scan ---
    def find_tag(self, i: int, tag: bytes):
        """Locate tag in record i's aux data.

        Returns (value_offset_into_data, type_char) or (None, None).
        Mirrors htslib bam_aux_get walk (used at src/bamutil.cpp:26,126).
        """
        a = int(self.aux_off[i])
        end = int(self.end[i])
        data = self.data
        while a + 3 <= end:
            t0, t1, typ = data[a], data[a + 1], chr(data[a + 2])
            val_off = a + 3
            if bytes((t0, t1)) == tag:
                return val_off, typ
            a = val_off + _aux_value_size(data, val_off, typ)
        return None, None

    def get_int_tag(self, i: int, tag: bytes, default: int = 0) -> int:
        off, typ = self.find_tag(i, tag)
        if off is None:
            return default
        return _aux_to_int(self.data, off, typ, default)

    def get_str_tag(self, i: int, tag: bytes):
        off, typ = self.find_tag(i, tag)
        if off is None or typ != "Z":
            return None
        end = int(self.end[i])
        j = off
        while j < end and self.data[j] != 0:
            j += 1
        return self.data[off:j].tobytes().decode("latin-1")


def _aux_value_size(data: np.ndarray, off: int, typ: str) -> int:
    if typ in "cC":
        return 1
    if typ in "sS":
        return 2
    if typ in "iIf":
        return 4
    if typ == "d":
        return 8
    if typ in "ZH":
        j = off
        while data[j] != 0:
            j += 1
        return j - off + 1
    if typ == "B":
        sub = chr(data[off])
        cnt = int(data[off + 1]) | (int(data[off + 2]) << 8) | (int(data[off + 3]) << 16) | (int(data[off + 4]) << 24)
        return 5 + cnt * _aux_value_size(data, off + 5, sub)
    if typ == "A":
        return 1
    raise ValueError(f"unknown aux type {typ!r}")


def _aux_to_int(data: np.ndarray, off: int, typ: str, default: int = 0) -> int:
    b = data[off:off + 8]
    if typ == "C":
        return int(b[0])
    if typ == "c":
        return int(np.int8(b[0]))
    if typ == "S":
        return int(b[0]) | (int(b[1]) << 8)
    if typ == "s":
        return int(np.frombuffer(b[:2].tobytes(), dtype=np.int16)[0])
    if typ == "I":
        return int(np.frombuffer(b[:4].tobytes(), dtype=np.uint32)[0])
    if typ == "i":
        return int(np.frombuffer(b[:4].tobytes(), dtype=np.int32)[0])
    return default


class BamReader:
    """Whole-file BAM reader: threaded native BGZF+scan when available,
    pure-Python fallback otherwise."""

    def __init__(self, path: str):
        from gencore_tpu.io import native
        if path == "-":
            # stdin: spool to a temp file in bounded chunks so the native
            # threaded reader works without holding the pipe in RAM
            import shutil
            import sys
            import tempfile
            tf = tempfile.NamedTemporaryFile(delete=False, suffix=".bam")
            shutil.copyfileobj(sys.stdin.buffer, tf, length=8 << 20)
            tf.close()
            path = tf.name
        self._payload_arr = native.bgzf_read(path)
        if self._payload_arr is not None:
            payload = self._payload_arr.tobytes() if False else None
            buf = self._payload_arr
            if buf[:4].tobytes() != BAM_MAGIC:
                raise ValueError("not a BAM file")
            l_text = int(buf[4:8].view(np.int32)[0])
            p = 8 + l_text
            text = buf[8:p].tobytes()
            n_ref = int(buf[p:p + 4].view(np.int32)[0])
            p += 4
            names, lengths = [], []
            for _ in range(n_ref):
                l_name = int(buf[p:p + 4].view(np.int32)[0])
                p += 4
                names.append(buf[p:p + l_name - 1].tobytes().decode())
                p += l_name
                lengths.append(int(buf[p:p + 4].view(np.int32)[0]))
                p += 4
            self.header = BamHeader(text, names, lengths)
            self._body_start = p
            self._payload = None
            return
        payload = bgzf.decompress_file(path)
        if payload[:4] != BAM_MAGIC:
            raise ValueError("not a BAM file")
        l_text = struct.unpack_from("<i", payload, 4)[0]
        p = 8 + l_text
        text = payload[8:p]
        n_ref = struct.unpack_from("<i", payload, p)[0]
        p += 4
        names, lengths = [], []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", payload, p)[0]
            p += 4
            names.append(payload[p:p + l_name - 1].decode())
            p += l_name
            lengths.append(struct.unpack_from("<i", payload, p)[0])
            p += 4
        self.header = BamHeader(text, names, lengths)
        self._payload = payload
        self._body_start = p

    def read_all(self) -> RecordBatch:
        if self._payload_arr is not None:
            from gencore_tpu.io import native
            bounds = native.bam_scan(self._payload_arr, self._body_start)
            if bounds is not None:
                n = len(bounds) - 1
                off = bounds[:n]
                end = np.empty(n, dtype=np.int64)
                end[:-1] = bounds[1:n] - 4
                if n:
                    end[-1] = bounds[n]
                return RecordBatch(self._payload_arr, off, end)
            # fall through to python scan on the native-decompressed buffer
            self._payload = self._payload_arr.tobytes()
            self._payload_arr = None
        payload = self._payload
        p = self._body_start
        n = len(payload)
        # scan block sizes to build offsets
        offs = []
        bodies = []
        while p + 4 <= n:
            bs = struct.unpack_from("<i", payload, p)[0]
            bodies.append(payload[p + 4:p + 4 + bs])
            p += 4 + bs
        data = np.frombuffer(b"".join(bodies), dtype=np.uint8)
        off = np.zeros(len(bodies) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in bodies], out=off[1:])
        return RecordBatch(data, off)


class BamWriter:
    """Collects record bodies and writes a BGZF BAM file."""

    def __init__(self, path: str, header: BamHeader, level: int = 6):
        self.path = path
        self.header = header
        self.level = level
        self._chunks = [header.encode()]

    def write_record(self, body: bytes):
        self._chunks.append(struct.pack("<i", len(body)) + body)

    def write_table(self, table):
        """Append a core.output.OutputTable's prebuilt payload."""
        self._chunks.append(table.build_payload().tobytes())

    def write_payload(self, payload: np.ndarray):
        """Append a prebuilt block_size-prefixed record stream
        (parallel.pipeline.merged_payload)."""
        self._chunks.append(payload.tobytes())

    def close(self):
        from gencore_tpu.io import native
        payload = b"".join(self._chunks)
        if self.path == "-":
            # BAM to stdout: the reference opens stdout in BAM mode for
            # `-o -` (only names ending in "sam" get text mode,
            # gencore.cpp:170-173)
            import sys
            out = sys.stdout.buffer
            for i in range(0, len(payload), bgzf.MAX_BLOCK_INPUT):
                out.write(bgzf.compress_block(
                    payload[i:i + bgzf.MAX_BLOCK_INPUT], self.level))
            out.write(bgzf.BGZF_EOF)
            out.flush()
            return
        arr = np.frombuffer(payload, dtype=np.uint8)
        if native.bgzf_write(self.path, arr, self.level):
            return
        bgzf.compress_to_file(self.path, payload, self.level)


def encode_record(tid: int, pos: int, qname: bytes, flag: int, mapq: int,
                  cigar: np.ndarray, mtid: int, mpos: int, isize: int,
                  seq_codes: np.ndarray, qual: np.ndarray,
                  aux: bytes = b"", bin_: int = 0) -> bytes:
    """Build a BAM record body from parts (inverse of RecordBatch views)."""
    l_qseq = len(seq_codes)
    qname_nul = bytes(qname) + b"\x00"
    packed = pack_seq(seq_codes)
    fixed = struct.pack(
        "<iiBBHHHiiii", tid, pos, len(qname_nul), mapq, bin_,
        len(cigar), flag, l_qseq, mtid, mpos, isize)
    return (fixed + qname_nul + np.asarray(cigar, dtype=np.uint32).tobytes()
            + packed.tobytes() + np.asarray(qual, dtype=np.uint8).tobytes() + aux)


def pack_seq(codes: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    nb = (n + 1) // 2
    padded = np.zeros(nb * 2, dtype=np.uint8)
    padded[:n] = codes
    return (padded[0::2] << 4) | padded[1::2]


def seq_str_to_codes(s: str) -> np.ndarray:
    return np.array([_BASE_TO_NT16.get(c.upper(), 15) for c in s], dtype=np.uint8)


def codes_to_seq_str(codes: np.ndarray) -> str:
    return "".join(SEQ_NT16_STR[c] for c in codes)
