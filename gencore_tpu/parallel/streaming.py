"""Bounded-memory streaming over coordinate windows.

The reference streams one record at a time at O(window) memory
(gencore.cpp:205). The batch engine holds the whole decompressed payload;
this module bounds residency for ultra-deep real-world BAMs (README.md:22)
with a two-pass design over the BGZF block table:

  pass 1 (index): decode the file chunk-by-chunk (native threaded
    inflate of block ranges), scan record boundaries, keep only the
    ~44 bytes/record of columns the window planner and pre-stats need
    (tid/pos/mtid/mpos/isize/flag + uncompressed offsets), then drop the
    chunk payload;
  pass 2 (process): for each coordinate window, decode just the block
    range covering its records, run the engine (dispatch/collect pipeline
    as in parallel.pipeline), and append the window's output through the
    incremental BGZF writer, holding back only the records that may
    interleave with the next window (cluster outputs can trail past the
    window edge by up to the pair-gap bound, gencore.cpp:300).

Peak residency = one window's payload + work arrays + the per-record
index — not the file. Output is byte-identical to the in-memory pipeline
(tests/test_streaming.py).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from gencore_tpu.engine import VectorEngine
from gencore_tpu.io import bam as bamio
from gencore_tpu.io import native
from gencore_tpu.options import Options
from gencore_tpu.stats import Stats
from gencore_tpu.parallel.pipeline import (plan_windows, _merge_window_stats,
                                           flush_ready, _get_alive,
                                           _put_alive,
                                           window_flush_boundaries)
from gencore_tpu.parallel.windows import (global_checkpoint,
                                          global_watermark)


# Auto-streaming size threshold (bytes of compressed BAM): above this the
# CLI/bench run the two-pass windowed pipeline. With the fused native
# pass-1 (gc_bam_index) the index costs ~25ms per 100MB, and streaming
# overlaps pass-2 decode with device compute, so only toy inputs are
# better off in-memory. GENCORE_STREAM_THRESHOLD overrides.
DEFAULT_STREAM_THRESHOLD = 1 << 20


class _IndexColumns:
    """Duck-typed RecordBatch surface for the window planner (only the
    fixed fields cluster_left_keys/global_checkpoint touch)."""

    def __init__(self, tid, pos, mtid, mpos, isize, flag, l_qseq,
                 ustart, uend):
        self.tid = tid
        self.pos = pos
        self.mtid = mtid
        self.mpos = mpos
        self.isize = isize
        self.flag = flag
        self.l_qseq = l_qseq
        self.ustart = ustart    # abs uncompressed offset of block_size prefix
        self.uend = uend        # abs uncompressed end of record body
        self.n = len(tid)

    def qname(self, i):  # UMI-prefix auto-detect probe only
        return b""


class StreamingBam:
    """Index + ranged-decode access to a BGZF BAM file."""

    def __init__(self, path: str, chunk_bytes: int = 24 << 20):
        # 24MB chunks: enough chunks that the pass-1 prefetch pipeline
        # (inflate || scan/extract) actually overlaps, while the carry
        # concatenate stays cheap
        if native.get_lib() is None:
            raise RuntimeError("streaming mode requires the native core")
        bt = native.bgzf_block_table(path)
        if bt is None:
            raise ValueError(f"not a BGZF file: {path}")
        import os
        self.path = path
        self.block_table, self.total = bt
        self.out_offs = np.append(self.block_table[:, 1], self.total)
        # file offsets of block starts (+ file size sentinel) for ranged
        # preads: I/O per span is O(span bytes), not O(file)
        self.file_offs = np.append(self.block_table[:, 0],
                                   os.path.getsize(path))
        self.chunk_bytes = chunk_bytes
        self.header = None
        self._body_start = None

    def _read_span(self, lo: int, hi: int):
        """Decompressed bytes [lo, hi) (block-aligned decode). Returns
        (buf, base) with buf covering [base, base+len)."""
        bl = int(np.searchsorted(self.out_offs, lo, side="right")) - 1
        bh = int(np.searchsorted(self.out_offs, max(hi, lo + 1) - 1,
                                 side="right"))
        bl = max(bl, 0)
        base = int(self.out_offs[bl])
        out_len = int(self.out_offs[bh]) - base
        buf = native.bgzf_read_span(self.path, int(self.file_offs[bl]),
                                    int(self.file_offs[bh]), out_len)
        if buf is None:  # older libgcio without the span reader
            buf = native.bgzf_read_blocks(self.path, bl, bh, out_len)
        if buf is None:
            raise IOError("BGZF ranged decode failed")
        return buf, base

    def _parse_header(self, buf):
        import struct
        if buf[:4].tobytes() != bamio.BAM_MAGIC:
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
        self.header = bamio.BamHeader(text, names, lengths)
        self._body_start = p

    def build_index(self, per_chunk=None, per_chunk_cols=None) -> _IndexColumns:
        """Pass 1: chunked decode + record scan; keeps index columns only.
        The fused native pass (gc_bam_index) scans boundaries and extracts
        the index columns + NM values in ONE threaded walk over the chunk;
        per_chunk_cols(cols) receives its int32 column dict (pre-stats).
        Without the native pass, per_chunk(batch) gets a RecordBatch as
        before. The next chunk's threaded inflate runs on a prefetch
        thread (the native call releases the GIL) while this thread
        scans/extracts the current one."""
        cols = {k: [] for k in ("tid", "pos", "mtid", "mpos", "isize",
                                "flag", "l_qseq", "ustart", "uend")}
        spans = []
        p0 = 0
        while p0 < self.total:
            spans.append((p0, min(p0 + self.chunk_bytes, self.total)))
            p0 = spans[-1][1]

        import concurrent.futures as _fut
        pool = _fut.ThreadPoolExecutor(max_workers=1)
        futs = [None] * len(spans)

        def _fetch(i):
            lo, hi = spans[i]
            return self._read_span(lo, hi)

        pos = 0
        carry = np.zeros(0, dtype=np.uint8)
        carry_base = 0
        first = True
        try:
            for ci, (pos, hi) in enumerate(spans):
                if futs[ci] is None:
                    futs[ci] = pool.submit(_fetch, ci)
                if ci + 1 < len(spans):
                    futs[ci + 1] = pool.submit(_fetch, ci + 1)
                buf, base = futs[ci].result()
                futs[ci] = None
                self._index_chunk(buf, base, pos, hi, cols, per_chunk,
                                  first, carry, carry_base,
                                  per_chunk_cols=per_chunk_cols)
                carry, carry_base, first = self._chunk_state
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        if len(carry) not in (0,):
            raise ValueError("truncated BAM payload")
        cat = {k: (np.concatenate(v) if v else np.zeros(0, dtype=np.int64))
               for k, v in cols.items()}
        return _IndexColumns(**cat)

    def _index_chunk(self, buf, base, pos, hi, cols, per_chunk, first,
                     carry, carry_base, per_chunk_cols=None):
        """Scan one decoded chunk into the index columns; sets
        self._chunk_state = (carry, carry_base, first) for the caller."""
        # the decode is block-aligned and can extend past hi; trim to
        # [pos, hi) so the carry never duplicates bytes
        end_in_buf = min(hi, self.total) - base
        if first:
            self._parse_header(buf)
            start_in_buf = self._body_start
            first = False
        else:
            start_in_buf = pos - base
        if len(carry):
            buf = np.concatenate([carry, buf[start_in_buf:end_in_buf]])
            buf_base = carry_base
        else:
            buf = buf[start_in_buf:end_in_buf]
            buf_base = base + start_in_buf
        n = len(buf)
        if per_chunk_cols is not None:
            # fused native pass: boundaries + columns + NM in one walk
            bi = native.bam_index(buf, 0)
            if bi is not None:
                bounds, ncols = bi
                nrec = len(bounds) - 1
                p = int(bounds[-1])
                if nrec:
                    off_a = bounds[:nrec]
                    end_a = np.empty(nrec, dtype=np.int64)
                    end_a[:-1] = bounds[1:nrec] - 4
                    end_a[-1] = p
                    for k in ("tid", "pos", "mtid", "mpos", "isize",
                              "flag", "l_qseq"):
                        cols[k].append(ncols[k].astype(np.int64))
                    cols["ustart"].append(off_a - 4 + buf_base)
                    cols["uend"].append(end_a + buf_base)
                    per_chunk_cols(ncols)
                self._chunk_state = (buf[p:].copy(), buf_base + p, first)
                return
        # scan complete records in buf (native partial scan; python
        # per-record loop only as fallback — at 100GB+ scale the index
        # pass must not crawl at interpreter speed)
        sp = native.bam_scan_partial(buf, 0)
        if sp is not None:
            bounds, p = sp
            nrec = len(bounds) - 1
            off_a = bounds[:nrec]
            end_a = np.empty(nrec, dtype=np.int64)
            if nrec:
                end_a[:-1] = bounds[1:nrec] - 4
                end_a[-1] = p
        else:
            p = 0
            offs = []
            ends = []
            while p + 4 <= n:
                bs = int(buf[p]) | (int(buf[p + 1]) << 8) | \
                    (int(buf[p + 2]) << 16) | (int(buf[p + 3]) << 24)
                if p + 4 + bs > n:
                    break
                offs.append(p + 4)
                ends.append(p + 4 + bs)
                p += 4 + bs
            off_a = np.asarray(offs, dtype=np.int64)
            end_a = np.asarray(ends, dtype=np.int64)
            nrec = len(off_a)
        if nrec:
            batch = bamio.RecordBatch(buf, off_a, end_a)
            for k in ("tid", "pos", "mtid", "mpos", "isize", "flag",
                      "l_qseq"):
                cols[k].append(np.array(getattr(batch, k)))
            cols["ustart"].append(off_a - 4 + buf_base)
            cols["uend"].append(end_a + buf_base)
            if per_chunk is not None:
                per_chunk(batch)
        self._chunk_state = (buf[p:].copy(), buf_base + p, first)

    def window_batch(self, index: _IndexColumns, idx: np.ndarray):
        """Pass 2: decode the block span covering records `idx` and build
        a RecordBatch of exactly those records."""
        lo = int(index.ustart[idx].min())
        hi = int(index.uend[idx].max())
        buf, base = self._read_span(lo, hi)
        return bamio.RecordBatch(buf, index.ustart[idx] - base + 4,
                                 index.uend[idx] - base)


class StreamingBamWriter:
    """Incremental BGZF writer: header + window payloads are treated as one
    continuous byte stream chunked at the standard 65280-byte BGZF block
    size — sub-block tails carry over to the next write — so the file is
    byte-identical (framing included) to compressing the concatenated
    payload in one shot (io.bam.BamWriter)."""

    _CHUNK = 65280

    def __init__(self, path: str, header: bamio.BamHeader, level: int = 6):
        self.path = path
        self.level = level
        self._carry = np.frombuffer(header.encode(), dtype=np.uint8)
        self._opened = False
        if native.get_lib() is None:
            raise IOError("native BGZF writer unavailable")
        # create/truncate the file now so close() on an empty run works
        if not native.bgzf_write_ex(path, np.zeros(0, dtype=np.uint8),
                                    level, append=False, write_eof=False):
            raise IOError("native BGZF writer unavailable")

    def write_payload(self, payload: np.ndarray):
        if len(payload) == 0:
            return
        buf = (np.concatenate([self._carry, payload]) if len(self._carry)
               else np.asarray(payload, dtype=np.uint8))
        cut = (len(buf) // self._CHUNK) * self._CHUNK
        if cut:
            if not native.bgzf_write_ex(self.path, buf[:cut], self.level,
                                        append=True, write_eof=False):
                raise IOError("BGZF append failed")
        self._carry = buf[cut:]

    def close(self):
        native.bgzf_write_ex(self.path, self._carry, self.level,
                             append=True, write_eof=True)
        self._carry = np.zeros(0, dtype=np.uint8)


# shared with the in-memory pipeline
_flush_ready = flush_ready


def run_streaming(opt: Options, path: str, out_path: str,
                  fasta=None, bed=None, n_windows: int = 0,
                  chunk_bytes: int = 24 << 20, devices=None,
                  warm_only: bool = False, stage_totals: dict = None):
    """Bounded-memory end-to-end run: returns (header, pre, post) after
    writing the output BAM incrementally. Output bytes are identical to
    the in-memory pipeline path. This is the DEFAULT engine path for
    file->file BAM runs (cli.py): window k's BGZF inflate runs on the
    dispatch thread while earlier windows vote/download on the collector,
    so there is no serial whole-file decode prefix and peak residency is
    O(window), matching the reference's only mode (gencore.cpp:205).

    devices round-robins windows over chips (as parallel.pipeline);
    warm_only dispatches+compiles without downloads; stage_totals
    accumulates per-window stage timers."""
    assert opt.max_contig == 0, \
        "streaming does not combine with --quit_after_contig"
    import jax
    devs = list(devices) if devices else [None]
    sbam = StreamingBam(path, chunk_bytes=chunk_bytes)

    pre = None
    post = None
    probe = None
    chunks_stats = []

    def per_chunk(batch):
        nm, _ = probe._extract_nm(batch, batch.n)
        chunks_stats.append((batch.tid.astype(np.int64),
                             batch.pos.astype(np.int64),
                             batch.l_qseq.astype(np.int64), nm))

    def per_chunk_cols(c):
        # fused native index already extracted NM with the same walk
        chunks_stats.append((c["tid"].astype(np.int64),
                             c["pos"].astype(np.int64),
                             c["l_qseq"].astype(np.int64),
                             c["nm"].astype(np.int64)))

    # need the header before building Stats: peek via first span
    buf0, _ = sbam._read_span(0, min(1 << 20, sbam.total))
    sbam._parse_header(buf0)
    header = sbam.header
    probe = VectorEngine(opt, header, fasta=None)
    import time as _time
    _ti0 = _time.perf_counter()
    index = sbam.build_index(per_chunk=per_chunk,
                             per_chunk_cols=per_chunk_cols)
    if stage_totals is not None:
        stage_totals["index"] = (stage_totals.get("index", 0.0)
                                 + _time.perf_counter() - _ti0)

    pre = Stats(opt.coverage_step, header.names, header.lengths,
                bed_stats=bed, is_post=False)
    post = Stats(opt.coverage_step, header.names, header.lengths,
                 bed_stats=bed.copy_structure() if bed is not None else None,
                 is_post=True)
    for t, p, l, nm in chunks_stats:
        pre.add_reads_vectorized(t, p, l, nm)

    if opt.umi_prefix == "auto":
        # auto-detect from the first record (gencore.cpp:206-221)
        if index.n:
            b0 = sbam.window_batch(index, np.array([0]))
            qn0 = b0.qname(0).decode("latin-1")
        else:
            qn0 = ""
        if "umi_" in qn0:
            opt.umi_prefix = "umi"
        elif "UMI_" in qn0:
            opt.umi_prefix = "UMI"
        else:
            opt.umi_prefix = ""

    if n_windows <= 0:
        n_windows = max(2, min(64, index.n // 40_000))
    ck = global_checkpoint(index)
    wm = global_watermark(index, header.lengths)
    wins = plan_windows(index, header.lengths, n_windows)

    # per-window safe flush boundaries for the ordered-emission holdback
    bounds = window_flush_boundaries(index, wins)

    writer = None if warm_only else StreamingBamWriter(out_path, header)
    pending: list = []

    def mkopt():
        return Options(**{f.name: getattr(opt, f.name)
                          for f in opt.__dataclass_fields__.values()})

    # 3 windows in flight: the collector's blocking D2H window overlaps
    # both the next window's host prep AND the one after's decode
    done_q: "queue.Queue" = queue.Queue(maxsize=3)
    err: list = []
    stats_engines: list = []

    def collector():
        w = 0
        while True:
            item = _get_alive(done_q, err)
            if item is None:
                return
            w, eng, st, dev = item
            try:
                if dev is not None:
                    with jax.default_device(dev):
                        table = eng.run_collect(st)
                else:
                    table = eng.run_collect(st)
                stats_engines.append(eng)
                if warm_only:
                    continue
                if len(table):
                    pay = table.build_payload()
                    pending.append((table.record_keys(),
                                    table._doff[:-1] + 0,
                                    np.diff(table._doff), pay))
                    writer.records_written = (
                        getattr(writer, "records_written", 0) + len(table))
                flush_ready(pending, bounds[w], writer)
                eng.release_run_state()
            except BaseException as e:
                err.append(e)
                return

    # window decode prefetch: the ranged BGZF inflate of window k+1 runs
    # on its own thread (the native codec releases the GIL) while the dispatch
    # thread does window k's host prep
    dec_q: "queue.Queue" = queue.Queue(maxsize=2)

    def decoder():
        try:
            for w, idx in enumerate(wins):
                if err:
                    return
                if not _put_alive(dec_q, (w, sbam.window_batch(index, idx)),
                                  err):
                    return
        except BaseException as e:
            err.append(e)
        finally:
            _put_alive(dec_q, None, err)

    dth = threading.Thread(target=decoder, daemon=True)
    dth.start()

    th = threading.Thread(target=collector, daemon=True)
    th.start()
    try:
        for w, idx in enumerate(wins):
            if err:
                break
            item = _get_alive(dec_q, err)
            if item is None:
                break
            w_dec, batch = item
            assert w_dec == w
            eng = VectorEngine(mkopt(), header, fasta=fasta,
                               bed=bed.copy_structure() if bed is not None
                               else None)
            eng._suppress_contig_dbg = True
            dev = devs[w % len(devs)]
            if dev is not None:
                with jax.default_device(dev):
                    st = eng.run_dispatch(batch, checkpoint=ck, watermark=wm,
                                          count_pre_reads=False,
                                          warm_only=warm_only)
            else:
                st = eng.run_dispatch(batch, checkpoint=ck, watermark=wm,
                                      count_pre_reads=False,
                                      warm_only=warm_only)
            if not _put_alive(done_q, (w, eng, st, dev), err):
                break
    except BaseException as e:
        # record before the finally joins: the decoder/collector loops
        # exit as soon as err is non-empty
        err.append(e)
    finally:
        _put_alive(done_q, None, err)
        th.join()
        while True:  # unblock a decoder mid-put, then reap it
            try:
                dec_q.get_nowait()
            except queue.Empty:
                break
        dth.join(timeout=30)
    if err:
        raise err[0]
    if warm_only:
        return header, pre, post
    flush_ready(pending, None, writer)
    writer.close()
    for eng in stats_engines:
        _merge_window_stats(pre, post, eng)
        if stage_totals is not None:
            for k, v in eng.timer.totals.items():
                stage_totals[k] = stage_totals.get(k, 0.0) + v
    if stage_totals is not None:
        stage_totals["out.records"] = (stage_totals.get("out.records", 0)
                                       + getattr(writer, "records_written", 0))
    return header, pre, post
