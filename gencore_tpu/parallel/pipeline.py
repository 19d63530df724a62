"""In-process coordinate-window pipeline (SURVEY.md §2 pipeline row).

The reference processes its stream strictly sequentially on one core
(gencore.cpp:205). This engine's stages have disjoint resources —
decode/sort/group/elect run on host CPU, overlap scoring + voting on the
device, assembly/encode back on host — so this module splits a batch into
coordinate windows and runs a 2-stage pipeline:

  main thread    : window k+1  host prep + async device dispatch
  collector thread: window k   blocking result download + assembly

While the collector blocks in the device->host transfer (which releases
the GIL) the main thread keeps the host busy preparing the next window;
device compute is async-dispatched and therefore overlaps both.

Window ownership rules, global checkpoint/watermark injection and stats
merging are identical to parallel.windows.run_sharded, which is
record-equivalence-tested against single-shot runs; windows here are cut
at equal *clustered-read* quantiles (balanced work) instead of equal
genome spans.

Multi-device: pass `devices` (e.g. jax.local_devices()) and windows are
round-robined over them — each window's upload, kernels and download are
pinned via jax.default_device (thread-local), so N chips process N
windows concurrently. Stats merge host-side (the psum formulation lives
in parallel.mesh for mesh-jit'd callers).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from gencore_tpu.engine import VectorEngine
from gencore_tpu.io import bam as bamio
from gencore_tpu.options import Options
from gencore_tpu.stats import Stats
from gencore_tpu.parallel.windows import (cluster_left_keys,
                                          global_checkpoint,
                                          global_watermark, subset_batch)


def plan_windows(batch: bamio.RecordBatch, header_lengths, n_windows: int,
                 weights=None):
    """Split records into <= n_windows coordinate windows that never split
    a position cluster. Returns a list of ascending index arrays covering
    every owned (kind>0) record; windows are cut at clustered-read count
    quantiles of the concatenated-genome cluster-left coordinate — or,
    with `weights` (per-record non-negative cost, e.g. measured device
    time per read from a prior run), at cumulative-weight quantiles, so a
    window of expensive reads gets fewer of them (profile-guided
    rebalance; see __graft_entry__.dryrun_multichip)."""
    kind, left = cluster_left_keys(batch)
    own = kind > 0
    tlen = np.array(header_lengths, dtype=np.int64)
    base = np.zeros(len(tlen) + 1, dtype=np.int64)
    np.cumsum(tlen, out=base[1:])
    coord = base[np.clip(batch.tid.astype(np.int64), 0, len(tlen) - 1)] + left
    oc = coord[own]
    if len(oc) == 0:
        return []
    cuts = []
    if weights is None:
        sc = np.sort(oc)
        for k in range(1, n_windows):
            v = sc[min(int(round(k * len(sc) / n_windows)), len(sc) - 1)]
            if not cuts or v > cuts[-1]:
                cuts.append(v)
    else:
        w_own = np.asarray(weights, dtype=np.float64)[own]
        order = np.argsort(oc, kind="stable")
        sc = oc[order]
        cw = np.cumsum(w_own[order])
        tot = float(cw[-1]) if len(cw) else 0.0
        for k in range(1, n_windows):
            i = int(np.searchsorted(cw, k * tot / n_windows))
            v = sc[min(i, len(sc) - 1)]
            if not cuts or v > cuts[-1]:
                cuts.append(v)
    cuts_a = np.asarray(cuts, dtype=np.int64)
    wid = np.searchsorted(cuts_a, coord, side="right")
    out = []
    for w in range(len(cuts_a) + 1):
        idx = np.nonzero(own & (wid == w))[0]
        if len(idx):
            out.append(idx)
    return out


def _merge_window_stats(pre: Stats, post: Stats, eng: VectorEngine):
    """Fold one window engine's stats into the global pair (per-read pre
    stats were computed once globally; only cluster/molecule counters and
    the full post stats come from windows) — mirrors windows.run_sharded."""
    pre.cluster += eng.pre_stats.cluster
    pre.multi_molecule_cluster += eng.pre_stats.multi_molecule_cluster
    pre.molecule += eng.pre_stats.molecule
    pre.molecule_se += eng.pre_stats.molecule_se
    pre.molecule_pe += eng.pre_stats.molecule_pe
    pre.supporting_histogram += eng.pre_stats.supporting_histogram
    pre.uncounted_supporting_reads += eng.pre_stats.uncounted_supporting_reads
    post.merge_from(eng.post_stats)


def merged_payload(tables) -> np.ndarray:
    """Vectorized cross-window merge: one writer-ready payload (block_size-
    prefixed record stream) in global bamComp order. Stable lexsort over
    the 5-field keys preserves (window, within-window) order for ties —
    the same order windows.merged_records produces, record-equivalent to a
    single-shot run."""
    from gencore_tpu.core.output import multi_slice_indices
    tables = [t for t in tables if len(t)]
    if not tables:
        return np.zeros(0, dtype=np.uint8)
    pays = []
    starts = []
    lens = []
    keys = []
    off = 0
    for t in tables:
        p = t.build_payload()
        doff = t._doff
        pays.append(p)
        starts.append(doff[:-1] + off)
        lens.append(np.diff(doff))
        keys.append(t.record_keys())
        off += len(p)
    K = np.concatenate(keys)
    order = np.lexsort((K[:, 4], K[:, 3], K[:, 2], K[:, 1], K[:, 0]))
    big = np.concatenate(pays)
    so = np.concatenate(starts)[order]
    sl = np.concatenate(lens)[order]
    do = np.zeros(len(sl), dtype=np.int64)
    np.cumsum(sl[:-1], out=do[1:])
    out = np.empty(int(sl.sum()), dtype=np.uint8)
    from gencore_tpu.io import native
    if not native.gather_slices(big, so, sl, out, do):
        out = big[multi_slice_indices(so, sl)]
    return out


def _put_alive(q: "queue.Queue", item, err: list) -> bool:
    """Bounded put that cannot deadlock on a dead consumer: gives up as
    soon as the collector has recorded an error (its thread no longer
    drains the queue). Returns False when abandoned."""
    while not err:
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _get_alive(q: "queue.Queue", err: list):
    """Bounded get that cannot deadlock on a dead producer: returns None
    as soon as any thread has recorded an error — the sentinel put may
    never arrive once err is non-empty (_put_alive gives up), so a plain
    blocking get() would hang forever."""
    while True:
        try:
            return q.get(timeout=0.2)
        except queue.Empty:
            if err:
                return None


def flush_ready(pending: list, boundary, writer):
    """Emit every pending record with bamComp key strictly below
    `boundary` (a (tid, pos) pair; None = flush all), preserving the
    stable (window, within-window) merge order. `pending` entries are
    (keys [n,5], starts, lens, payload) tuples; kept-back tails stay."""
    parts = []
    keep = []
    for K, starts, lens, payload in pending:
        if boundary is None:
            m = np.ones(len(K), dtype=bool)
        else:
            tb, pb = boundary
            m = (K[:, 0] < tb) | ((K[:, 0] == tb) & (K[:, 1] < pb))
        if m.any():
            parts.append((K[m], starts[m], lens[m], payload))
        if not m.all():
            keep.append((K[~m], starts[~m], lens[~m], payload))
    pending[:] = keep
    if not parts:
        return
    K = np.concatenate([p[0] for p in parts])
    order = np.lexsort((K[:, 4], K[:, 3], K[:, 2], K[:, 1], K[:, 0]))
    big_off = 0
    so_l, pay_l = [], []
    for _, starts, lens, payload in parts:
        so_l.append(starts + big_off)
        pay_l.append(payload)
        big_off += len(payload)
    big = np.concatenate(pay_l)
    so = np.concatenate(so_l)[order]
    sl = np.concatenate([p[2] for p in parts])[order]
    do = np.zeros(len(sl), dtype=np.int64)
    np.cumsum(sl[:-1], out=do[1:])
    out = np.empty(int(sl.sum()), dtype=np.uint8)
    from gencore_tpu.io import native
    if not native.gather_slices(big, so, sl, out, do):
        from gencore_tpu.core.output import multi_slice_indices
        out = big[multi_slice_indices(so, sl)]
    writer.write_payload(out)


def window_flush_boundaries(batch, wins):
    """Per-window safe flush boundary: after window w completes, every
    record with key strictly below boundary[w] can be written — no later
    window can emit below it. Emitted records keep their own (tid, pos),
    and a record's pos is always >= its cluster-left key, so the lexmin
    record (tid, pos) of each window lower-bounds its emissions; the
    suffix-min over later windows makes the bound safe even when a
    window's records all sit far right of its cluster-left cut (absent
    mates pull cluster-left below every member pos). boundary[-1] is None
    (flush all)."""
    t = batch.tid.astype(np.int64)
    p = batch.pos.astype(np.int64)
    keys = []
    for idx in wins:
        tw = t[idx]
        pw = p[idx]
        j = int(np.lexsort((pw, tw))[0])
        keys.append((int(tw[j]), int(pw[j])))
    bounds = [None] * len(wins)
    cur = None
    for w in range(len(wins) - 1, 0, -1):
        k = keys[w]
        cur = k if cur is None or k < cur else cur
        bounds[w - 1] = cur
    return bounds


def run_pipelined(opt: Options, batch: bamio.RecordBatch, header,
                  fasta=None, bed=None, n_windows: int = 0,
                  devices=None, warm_only: bool = False,
                  max_inflight: int = 3, stage_totals: dict = None,
                  engines_out: list = None, out_writer=None,
                  window_weights=None):
    """Run the vectorized engine as a window pipeline; returns
    (tables, pre_stats, post_stats) record-equivalent to a single-shot
    VectorEngine.run (the merged outputs are ordered by windows.merged_records).

    n_windows=0 picks a size-based default. devices: optional list of jax
    devices to round-robin windows over (None = default device only).

    out_writer: an incremental writer (StreamingBamWriter-compatible
    write_payload) — window outputs are then encoded and written on the
    collector thread as each window's flush boundary clears (overlapping
    the BGZF compression with later windows' host/device work) and the
    returned tables list is empty. Output bytes are identical to writing
    merged_payload(tables)."""
    assert opt.max_contig == 0, \
        "window pipelining does not combine with --quit_after_contig"
    if opt.umi_prefix == "auto":
        qn0 = batch.qname(0).decode("latin-1") if batch.n else ""
        if "umi_" in qn0:
            opt.umi_prefix = "umi"
        elif "UMI_" in qn0:
            opt.umi_prefix = "UMI"
        else:
            opt.umi_prefix = ""

    pre = Stats(opt.coverage_step, header.names, header.lengths,
                bed_stats=bed, is_post=False)
    post = Stats(opt.coverage_step, header.names, header.lengths,
                 bed_stats=bed.copy_structure() if bed is not None else None,
                 is_post=True)
    probe = VectorEngine(opt, header, fasta=None)
    nm, _ = probe._extract_nm(batch, batch.n)
    pre.add_reads_vectorized(batch.tid.astype(np.int64),
                             batch.pos.astype(np.int64),
                             batch.l_qseq.astype(np.int64), nm)

    if n_windows <= 0:
        # ~40k clustered reads per window amortizes per-window fixed costs
        # while leaving enough windows to overlap stages
        n_windows = max(1, min(16, batch.n // 40_000))
    if opt.debug and batch.n:
        # contig progress once, globally (window engines suppress theirs:
        # they would reprint per window, interleaved across threads)
        import sys
        t_dbg = batch.tid.astype(np.int64)
        cm = np.maximum.accumulate(np.append(-1, t_dbg))[:-1]
        for tv in t_dbg[t_dbg > cm]:
            print(f"Starting contig {int(tv)}", file=sys.stderr)

    ck = global_checkpoint(batch)
    wm = global_watermark(batch, header.lengths)
    wins = plan_windows(batch, header.lengths, n_windows,
                        weights=window_weights)
    if not wins:
        return [], pre, post
    bounds = (window_flush_boundaries(batch, wins)
              if out_writer is not None and not warm_only else None)
    wpending: list = []

    import jax
    devs = list(devices) if devices else [None]

    def mkopt():
        return Options(**{f.name: getattr(opt, f.name)
                          for f in opt.__dataclass_fields__.values()})

    done_q: "queue.Queue" = queue.Queue(maxsize=max_inflight)
    tables = [None] * len(wins)
    engines = [None] * len(wins)
    err: list = []

    import sys
    import time as _time
    t_origin = _time.perf_counter()
    dbg = bool(getattr(opt, "debug", False))

    def collector():
        while True:
            item = _get_alive(done_q, err)
            if item is None:
                return
            w, eng, st, dev = item
            try:
                tc0 = _time.perf_counter()
                if dev is not None:
                    with jax.default_device(dev):
                        tables[w] = eng.run_collect(st)
                else:
                    tables[w] = eng.run_collect(st)
                engines[w] = eng
                if bounds is not None:
                    tw0 = _time.perf_counter()
                    t = tables[w]
                    if t is not None and len(t):
                        pay = t.build_payload()  # sets t._doff
                        wpending.append((t.record_keys(),
                                         t._doff[:-1].copy(),
                                         np.diff(t._doff), pay))
                        out_writer.records_written = (
                            getattr(out_writer, "records_written", 0)
                            + len(t))
                    tables[w] = None  # payload now owned by wpending
                    flush_ready(wpending, bounds[w], out_writer)
                    eng.timer.totals["write"] = (
                        eng.timer.totals.get("write", 0.0)
                        + _time.perf_counter() - tw0)
                if not warm_only:
                    # stats/timer survive; matrices and the window's
                    # payload reference are dropped so peak residency
                    # stays O(inflight windows), not O(all windows)
                    eng.release_run_state()
                if dbg:
                    tc1 = _time.perf_counter()
                    print(f"[pipeline] w{w} collect "
                          f"{tc0 - t_origin:.2f}-{tc1 - t_origin:.2f}s",
                          file=sys.stderr)
            except BaseException as e:  # propagate to main
                err.append(e)
                return

    th = threading.Thread(target=collector, daemon=True)
    th.start()
    try:
        for w, idx in enumerate(wins):
            if err:
                break
            sub = subset_batch(batch, idx)
            eng = VectorEngine(mkopt(), header, fasta=fasta,
                               bed=bed.copy_structure() if bed is not None
                               else None)
            eng._suppress_contig_dbg = True
            dev = devs[w % len(devs)]
            td0 = _time.perf_counter()
            if dev is not None:
                with jax.default_device(dev):
                    st = eng.run_dispatch(sub, checkpoint=ck, watermark=wm,
                                          count_pre_reads=False,
                                          warm_only=warm_only)
            else:
                st = eng.run_dispatch(sub, checkpoint=ck, watermark=wm,
                                      count_pre_reads=False,
                                      warm_only=warm_only)
            if dbg:
                td1 = _time.perf_counter()
                print(f"[pipeline] w{w} dispatch "
                      f"{td0 - t_origin:.2f}-{td1 - t_origin:.2f}s "
                      f"({len(idx)} reads)", file=sys.stderr)
            if not _put_alive(done_q, (w, eng, st, dev), err):
                break
    finally:
        _put_alive(done_q, None, err)
        th.join()
    if err:
        raise err[0]
    if warm_only:
        return None, pre, post
    if engines_out is not None:
        engines_out.extend(e for e in engines if e is not None)
    for eng in engines:
        if eng is not None:
            _merge_window_stats(pre, post, eng)
            if stage_totals is not None:
                for k, v in eng.timer.totals.items():
                    stage_totals[k] = stage_totals.get(k, 0.0) + v
    tables = [t for t in tables if t is not None]
    return tables, pre, post
