"""The batched, vectorized consensus engine (accelerator pipeline).

Reformulates the reference's record-at-a-time streaming design
(gencore.cpp:162-477) as batch dataflow:

  1. columnar decode (io.bam.RecordBatch, native BGZF core)
  2. vectorized pre-stats + cluster-key computation (sort-by-key replaces
     the nested std::map hierarchy, gencore.h:76)
  3. vectorized pair assembly, UMI extraction (core.umivec) and greedy UMI
     grouping (single-UMI fast path; shared python greedy for the rest)
  4. template election: segment reductions over CIGAR equivalence classes
     (core.cigartable) with a python fallback for mixed-cigar groups
  5. device kernels (core.kernels) for overlap scoring + consensus voting
     over padded job tensors, bucketed by member count
  6. shared per-cluster duplex/threshold flow (core.postmerge)
  7. ordered output assembly + post-stats

Output is record-equivalent to the scalar oracle (and thus to the
documented reference behavior); tests/test_engine_equivalence.py enforces
this on randomized workloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gencore_tpu.core import kernels, umivec
from gencore_tpu.core.cigartable import CigarTable
from gencore_tpu.core.grouping import greedy_umi_groups
from gencore_tpu.core.oracle import OPair, RefLookup
from gencore_tpu.core.output import OutBlock, OutRead, OutputTable
from gencore_tpu.core.postmerge import duplex_merge_rows, postprocess_cluster
from gencore_tpu.io import bam as bamio
from gencore_tpu.options import Options
from gencore_tpu.stats import MAX_SUPPORTING_READS, Stats
from gencore_tpu.utils import cigar as cig
from gencore_tpu.utils.tracing import StageTimer

PAIR_GAP_LIMIT = 100_000  # gencore.cpp:300
TICK = 10_000             # gencore.cpp:319-322
BIG = np.int64(1 << 60)
LANE = 32                 # row length L rounds up to a multiple of this

import os as _os
_SYNC_STAGES = bool(_os.environ.get("GENCORE_SYNC_STAGES"))

_ASCII_TO_NT16 = np.zeros(256, dtype=np.uint8)
for _c, _v in zip(b"ACGT", (1, 2, 4, 8)):
    _ASCII_TO_NT16[_c] = _v

_OK_CODES = np.zeros(256, dtype=bool)
for _v in (0, 1, 2, 4, 8, 15):
    _OK_CODES[_v] = True
# packed-byte variants: both nibbles / high nibble are =ACGTN codes
_OK_PAIR = np.array([_OK_CODES[b >> 4] and _OK_CODES[b & 15]
                     for b in range(256)], dtype=bool)
_OK_HI = np.array([_OK_CODES[b >> 4] for b in range(256)], dtype=bool)


def _unpack_nibbles(p: np.ndarray) -> np.ndarray:
    """[n, W/2] packed nibbles -> [n, W] codes (BAM layout, high first)."""
    out = np.empty(p.shape[:-1] + (p.shape[-1] * 2,), dtype=np.uint8)
    out[..., 0::2] = p >> 4
    out[..., 1::2] = p & 0xF
    return out


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n


def _bucket_rows(x: int) -> int:
    """Smallest padded row count >= x from {2^k, 3*2^(k-1)}, min 16: two
    shape buckets per octave instead of one. The pow2-only pad wasted up
    to 2x wire/compute on every per-row array (a 40k-row window padded to
    65536 rows); 1.5x-steps cap the waste at 1.33x while shapes still
    recur, so a run compiles few shapes and the persistent compile cache
    hits across windows and runs."""
    n = 16
    while n < x:
        if (3 * n) >> 1 >= x:
            return (3 * n) >> 1
        n <<= 1
    return n


@dataclass
class _Job:
    group_id: int
    is_left_side: bool
    left_read_mode: bool
    template_read: int        # record index of template
    template_pair: int        # pair id owning the template read
    job_len: int
    # fast jobs: slice into the side's flat member-row array
    flat_start: int = -1
    k: int = 0
    # slow jobs: explicit member lists
    members_reads: list = None
    len_diffs: list = None
    # results
    new_seq: np.ndarray = None
    new_qual: np.ndarray = None
    diff: int = 0
    minc: int = 0


class _JobView:
    """Lazy per-job view over a _JobTable — only the scalar paths (slow
    elections, scalar-cluster assembly, debug prints) materialize one."""

    __slots__ = ("t", "i")

    def __init__(self, t, i):
        self.t = t
        self.i = i

    @property
    def group_id(self):
        return int(self.t.col("group_id")[self.i])

    @property
    def is_left_side(self):
        return bool(self.t.col("is_left")[self.i])

    @property
    def left_read_mode(self):
        return bool(self.t.col("left_mode")[self.i])

    @property
    def template_read(self):
        return int(self.t.col("tmpl_read")[self.i])

    @property
    def template_pair(self):
        return int(self.t.col("tmpl_pair")[self.i])

    @property
    def job_len(self):
        return int(self.t.col("job_len")[self.i])

    @property
    def flat_start(self):
        return int(self.t.col("flat_start")[self.i])

    @property
    def k(self):
        return int(self.t.col("k")[self.i])

    @property
    def members_reads(self):
        return self.t.members[self.i][0]

    @property
    def len_diffs(self):
        return self.t.members[self.i][1]

    @property
    def new_seq(self):
        return self.t.new_seq(self.i)

    @property
    def new_qual(self):
        return self.t.new_qual(self.i)

    @property
    def diff(self):
        return int(self.t.diff[self.i])

    @property
    def minc(self):
        return int(self.t.minc[self.i])


class _JobTable:
    """Columnar job store (struct-of-arrays). The per-job dataclass loop
    was a top host cost (~80k _Job objects + 500k list appends per run);
    fast-path elections now append whole column blocks and the dispatch/
    collect paths read/write columns directly."""

    _FIELDS = ("group_id", "is_left", "left_mode", "tmpl_read", "tmpl_pair",
               "job_len", "flat_start", "k")

    def __init__(self):
        self._chunks = []      # tuples of per-field arrays, in _FIELDS order
        self._n = 0
        self._cols = None
        self.members = {}      # slow ji -> (members_reads, len_diffs)
        self.diff = None       # int64 [n] results
        self.minc = None
        self._seqbufs = []     # (ds, dq) dense row buffers
        self._buf = None       # int32 [n] buffer id, -1 = override/missing
        self._row = None
        self._ovr = {}         # ji -> (seq_row, qual_row)

    def __len__(self):
        return self._n

    def __getitem__(self, ji):
        return _JobView(self, int(ji))

    def append_fast_block(self, group_ids, is_left, tmpl_read, tmpl_pair,
                          job_len, flat_start, k) -> int:
        """Append m fast jobs (left_read_mode=True) in one block; returns
        the base job id (ids are base..base+m-1)."""
        m = len(group_ids)
        self._chunks.append((
            np.asarray(group_ids, dtype=np.int64),
            np.full(m, bool(is_left)),
            np.ones(m, dtype=bool),
            np.asarray(tmpl_read, dtype=np.int64),
            np.asarray(tmpl_pair, dtype=np.int64),
            np.asarray(job_len, dtype=np.int64),
            np.asarray(flat_start, dtype=np.int64),
            np.asarray(k, dtype=np.int64)))
        base = self._n
        self._n += m
        self._cols = None
        return base

    def append_job(self, job: "_Job") -> int:
        """Append one slow job (explicit member lists)."""
        base = self._n
        self._chunks.append((
            np.array([job.group_id], dtype=np.int64),
            np.array([job.is_left_side]),
            np.array([job.left_read_mode]),
            np.array([job.template_read], dtype=np.int64),
            np.array([job.template_pair], dtype=np.int64),
            np.array([job.job_len], dtype=np.int64),
            np.array([-1], dtype=np.int64),
            np.array([job.k], dtype=np.int64)))
        self.members[base] = (job.members_reads, job.len_diffs)
        self._n += 1
        self._cols = None
        return base

    def col(self, name: str) -> np.ndarray:
        if self._cols is None:
            if self._chunks:
                self._cols = tuple(np.concatenate([c[i] for c in self._chunks])
                                   for i in range(len(self._FIELDS)))
            else:
                self._cols = tuple(
                    np.zeros(0, dtype=bool if f in ("is_left", "left_mode")
                             else np.int64) for f in self._FIELDS)
        return self._cols[self._FIELDS.index(name)]

    # ---- results ----
    def alloc_results(self):
        if self.diff is None or len(self.diff) != self._n:
            self.diff = np.zeros(self._n, dtype=np.int64)
            self.minc = np.zeros(self._n, dtype=np.int64)
            self._buf = np.full(self._n, -1, dtype=np.int32)
            self._row = np.zeros(self._n, dtype=np.int32)

    def add_buffer(self, ds, dq) -> int:
        self._seqbufs.append((ds, dq))
        return len(self._seqbufs) - 1

    def set_rows(self, jids, buf_id: int, rows):
        self._buf[jids] = buf_id
        self._row[jids] = rows

    def set_override(self, ji, seq_row, qual_row, diff, minc):
        ji = int(ji)
        self._ovr[ji] = (seq_row, qual_row)
        self._buf[ji] = -1
        self.diff[ji] = diff
        self.minc[ji] = minc

    def new_seq(self, ji) -> np.ndarray:
        o = self._ovr.get(int(ji))
        if o is not None:
            return o[0]
        return self._seqbufs[self._buf[ji]][0][self._row[ji]]

    def new_qual(self, ji) -> np.ndarray:
        o = self._ovr.get(int(ji))
        if o is not None:
            return o[1]
        return self._seqbufs[self._buf[ji]][1][self._row[ji]]


@dataclass
class _Dispatched:
    """State handed from run_dispatch to run_collect. `done` short-circuits
    (empty batch); otherwise `pending` holds in-flight device results."""
    done: object = None
    pending: list = None
    jobs: list = None
    out_records: list = None
    assemble_args: tuple = None


class VectorEngine:
    # None: take the accelerator path (bucketed shapes, the [K, J, L] vote
    # of core/vote.py, sparse downloads, device refbase, the fused window
    # program) exactly when JAX's default backend is not the CPU. Tests set
    # True to run that path on the CPU.
    accelerator_path: bool | None = None

    def __init__(self, opt: Options, header: bamio.BamHeader, fasta=None, bed=None):
        self.opt = opt
        self.header = header
        self.fasta = fasta
        self.ref = RefLookup(fasta, header.names)
        pre_bed = bed
        post_bed = bed.copy_structure() if bed is not None else None
        self.pre_stats = Stats(opt.coverage_step, header.names, header.lengths,
                               bed_stats=pre_bed, is_post=False)
        self.post_stats = Stats(opt.coverage_step, header.names, header.lengths,
                                bed_stats=post_bed, is_post=True)
        self._ipo_cache: dict = {}
        self._cig_cache: dict = {}
        self._refoff_cache: dict = {}
        # concatenated genome for vectorized ref gathers — cached on the
        # FastaRef keyed by contig order/length so the W window engines
        # of a pipelined run share one copy instead of building W
        if fasta is not None:
            key = (tuple(header.names), tuple(header.lengths))
            cache = getattr(fasta, "_gcat_cache", None)
            if not isinstance(cache, dict):
                cache = {}
                fasta._gcat_cache = cache
            hit = cache.get(key)
            if hit is None:
                lens = [fasta.contig_len(n) for n in header.names]
                clen = np.array(lens, dtype=np.int64)
                cbase = np.zeros(len(lens) + 1, dtype=np.int64)
                np.cumsum(lens, out=cbase[1:])
                parts = [fasta.get_contig(n) if fasta.get_contig(n) is not None
                         else np.zeros(0, dtype=np.uint8)
                         for n in header.names]
                genome = (np.concatenate(parts) if parts
                          else np.zeros(0, dtype=np.uint8))
                hit = (clen, cbase, genome)
                cache[key] = hit
            self._contig_len, self._contig_base, self._genome = hit
        else:
            self._genome = None
        self._mi_has_rank = None   # per-rank MI presence (None = no MI)
        self._qname_umi = None
        self.timer = StageTimer()
        self.wire_h2d = 0          # bytes shipped host->device this run
        self.wire_d2h = 0          # bytes downloaded device->host

    def _accelerated(self) -> bool:
        if self.accelerator_path is not None:
            return self.accelerator_path
        import jax
        return jax.default_backend() != "cpu"

    def _acct_up(self, *arrays):
        for a in arrays:
            if isinstance(a, np.ndarray):
                self.wire_h2d += a.nbytes

    # ------------------------------------------------------------------
    def run(self, batch: bamio.RecordBatch, *, checkpoint=None,
            watermark=None, count_pre_reads: bool = True,
            warm_only: bool = False):
        """warm_only: dispatch every device kernel (compiling them) and
        block WITHOUT any device->host download, then return None. The
        bench uses it to compile every shape before the timed runs."""
        return self.run_collect(self.run_dispatch(
            batch, checkpoint=checkpoint, watermark=watermark,
            count_pre_reads=count_pre_reads, warm_only=warm_only))

    def run_dispatch(self, batch: bamio.RecordBatch, *, checkpoint=None,
                     watermark=None, count_pre_reads: bool = True,
                     warm_only: bool = False):
        """Host stages + async device dispatch for one batch, WITHOUT any
        blocking device->host download. Returns a _Dispatched state to be
        completed by run_collect — the window pipeline overlaps window
        k+1's dispatch with window k's collection (SURVEY.md §2: decode/
        cluster -> consensus -> encode/write, double-buffered)."""
        self._warm_only = warm_only
        self._watermark = (-1, -1)
        opt = self.opt
        self.batchref = batch
        n = batch.n
        if n == 0:
            return _Dispatched(done=self._finalize([]))

        # UMI prefix auto-detect from first record (gencore.cpp:206-221)
        if opt.umi_prefix == "auto":
            qn0 = batch.qname(0).decode("latin-1") if n else ""
            if "umi_" in qn0:
                opt.umi_prefix = "umi"
            elif "UMI_" in qn0:
                opt.umi_prefix = "UMI"
            else:
                opt.umi_prefix = ""

        tid = batch.tid.astype(np.int64)
        pos = batch.pos.astype(np.int64)
        mtid = batch.mtid.astype(np.int64)
        mpos = batch.mpos.astype(np.int64)
        isize = batch.isize.astype(np.int64)

        # sortedness check (fatal in the reference, gencore.cpp:232-241);
        # records with tid<0 or pos<0 are exempt
        mapped_chk = (tid >= 0) & (pos >= 0)
        mi = np.nonzero(mapped_chk)[0]
        if len(mi) > 1:
            t0, p0 = tid[mi[:-1]], pos[mi[:-1]]
            t1, p1 = tid[mi[1:]], pos[mi[1:]]
            bad = (t1 < t0) | ((t1 == t0) & (p1 < p0))
            if bad.any():
                k = int(np.nonzero(bad)[0][0])
                raise ValueError(
                    f"the input is unsorted. Found {t1[k]}:{p1[k]} after "
                    f"{t0[k]}:{p0[k]}. Please sort the input first.")

        # SE-input warning (gencore.cpp:224-230)
        first1k = min(n, 1000)
        if n >= 1000 and not (mtid[:first1k] >= 0).any():
            import sys
            print("WARNING: seems that the input data is single-end, gencore "
                  "will not make consensus read and remove duplication for SE "
                  "data since grouping by coordination will be inaccurate.",
                  file=sys.stderr)

        # --quit_after_contig (gencore.cpp:222,242-246)
        limit = n
        if opt.max_contig > 0:
            over = np.nonzero(tid >= opt.max_contig)[0]
            if len(over):
                limit = int(over[0]) + 1

        # --debug contig progress (gencore.cpp:247-250): one notice per
        # strictly-increasing tid in stream order
        if opt.debug and limit and not getattr(self, "_suppress_contig_dbg",
                                               False):
            import sys
            t_dbg = tid[:limit]
            cm = np.maximum.accumulate(np.append(-1, t_dbg))[:-1]
            for tv in t_dbg[t_dbg > cm]:
                print(f"Starting contig {int(tv)}", file=sys.stderr)

        nm, nm_patch = self._extract_nm(batch, limit)
        self._nm_vals = nm
        self._nm_patch = nm_patch
        if count_pre_reads:
            self.pre_stats.add_reads_vectorized(tid[:limit], pos[:limit],
                                                batch.l_qseq[:limit].astype(np.int64),
                                                nm[:limit])
        proc = limit if limit == n else limit - 1

        mapped = (tid[:proc] >= 0) & (pos[:proc] >= 0)
        primary = (batch.flag[:proc] & (bamio.FSECONDARY | bamio.FSUPPLEMENTARY)) == 0
        idx = np.nonzero(mapped & primary)[0]

        # cluster keys (gencore.cpp:295-313)
        t = tid[idx]
        p = pos[idx]
        mt = mtid[idx]
        mp = mpos[idx]
        isz = isize[idx]
        same_near = (mt == t) & (np.abs(mp - p) < PAIR_GAP_LIMIT)
        left = np.where(same_near & (isz < 0), mp, p)
        tlen_arr = np.array(self.header.lengths, dtype=np.int64)
        right = np.where(
            same_near,
            left + np.abs(isz) - 1,
            -tlen_arr[np.clip(t, 0, len(tlen_arr) - 1)] * (mt + 1) + mp,
        )
        passthrough = ~same_near & (mt < 0)

        out_records: list = []
        self._serial = 0
        for i in idx[passthrough]:
            self._emit_raw(batch, int(i), out_records)

        cl_mask = ~passthrough
        cidx = idx[cl_mask]
        ckey_t = t[cl_mask]
        ckey_l = left[cl_mask]
        ckey_r = right[cl_mask]
        nclust = len(cidx)
        if nclust == 0:
            return _Dispatched(done=self._finalize(out_records))

        # tick checkpoints (gencore.cpp:319-389): the last one decides
        # watermark-flushed vs EOF-finished threshold (quirk gencore.cpp:409).
        # A sharded run injects the globally computed checkpoint.
        if checkpoint is not None:
            last_ck_tid, last_ck_pos = checkpoint
        else:
            last_ck_tid, last_ck_pos = -1, -1
            if nclust >= TICK:
                ck = cidx[TICK - 1::TICK][-1]
                last_ck_tid, last_ck_pos = int(tid[ck]), int(pos[ck])

        _T0 = self.timer.stage
        _T = _T0
        import jax as _jax

        with _T0("sort"):
            qname_mat, qname_w = self._qname_matrix(batch, cidx)
            # qname sort key: real qnames share a long run-constant prefix,
            # so the 8 bytes after the batch-common prefix (big-endian u64
            # = lex order) almost always decide the order; an adjacency
            # check proves exactness post-sort and falls back to the full
            # byte-string lexsort on any collision between distinct qnames
            s_q = None
            if qname_w > 8 and nclust > 1:
                lo = qname_mat.min(axis=0)
                hi = qname_mat.max(axis=0)
                neq = np.nonzero(lo != hi)[0]
                p0 = int(neq[0]) if len(neq) else qname_w
                sub = qname_mat[:, p0:p0 + 8]
                if sub.shape[1] < 8:
                    sub = np.pad(sub, ((0, 0), (0, 8 - sub.shape[1])))
                key64 = np.ascontiguousarray(sub).view(">u8").ravel()
                key64 = key64.astype(np.uint64)
                order = np.lexsort((cidx, key64, ckey_r, ckey_l, ckey_t))
                kk = key64[order]
                st_ = ckey_t[order]
                sl_ = ckey_l[order]
                sr_ = ckey_r[order]
                same = ((kk[1:] == kk[:-1]) & (st_[1:] == st_[:-1])
                        & (sl_[1:] == sl_[:-1]) & (sr_[1:] == sr_[:-1]))
                ok64 = True
                if same.any():
                    ia = order[:-1][same]
                    ib = order[1:][same]
                    ok64 = bool((qname_mat[ia] == qname_mat[ib]).all())
                if ok64:
                    # adjacent key64 ties are whole-qname ties, so key64
                    # equality is qname equality for the pair detection
                    s_q = kk
            if s_q is None:
                qname_keys = qname_mat.view(f"S{qname_w}").ravel()
                order = np.lexsort((cidx, qname_keys, ckey_r, ckey_l,
                                    ckey_t))
                s_q = qname_keys[order]
        s_rec = cidx[order]
        s_t = ckey_t[order]
        s_l = ckey_l[order]
        s_r = ckey_r[order]

        new_cluster = np.ones(nclust, dtype=bool)
        new_cluster[1:] = (s_t[1:] != s_t[:-1]) | (s_l[1:] != s_l[:-1]) | (s_r[1:] != s_r[:-1])
        new_pair = new_cluster.copy()
        new_pair[1:] |= s_q[1:] != s_q[:-1]
        pair_start = np.nonzero(new_pair)[0]
        pair_end = np.append(pair_start[1:], nclust)
        # pair left = first read in stream order, right = LAST
        # (Cluster::addRead overwrites mRight, cluster.cpp:260-273)
        pl = s_rec[pair_start]
        pr = np.where(pair_end - pair_start >= 2, s_rec[pair_end - 1], -1)
        npairs = len(pl)

        cluster_of_pair = np.cumsum(new_cluster)[pair_start] - 1
        nclusters = int(cluster_of_pair[-1]) + 1
        c_first = np.nonzero(new_cluster)[0]
        c_tid = s_t[c_first]
        c_left = s_l[c_first]
        c_right = s_r[c_first]
        pc_change = np.ones(npairs, dtype=bool)
        pc_change[1:] = cluster_of_pair[1:] != cluster_of_pair[:-1]
        c_pair_start = np.nonzero(pc_change)[0]
        c_pair_end = np.append(c_pair_start[1:], npairs)

        flushed = (c_tid < last_ck_tid) | (
            (c_tid == last_ck_tid) & (c_left < last_ck_pos) & (c_right < last_ck_pos))
        c_thr = np.where(flushed, opt.proper_reads_umi_diff_threshold,
                         opt.unproper_reads_umi_diff_threshold)

        # Final watermark (mProcessedTid/Pos after the last flush tick,
        # gencore.cpp:324-389): the lexmin (tid, left) cluster key remaining
        # after the tick's sweep. The reference drains its output set only
        # strictly below this key before report() — the final drain happens
        # in ~Gencore AFTER report() (gencore.cpp:21-37) — so the REPORTED
        # post-stats cover only records below the watermark. Validated
        # against the actual reference binary (tools/golden_compare.py).
        if checkpoint is not None:
            self._watermark = watermark if watermark is not None else (-1, -1)
        elif nclust >= TICK:
            c_first_read = np.minimum.reduceat(s_rec, c_first)
            for ck in cidx[TICK - 1::TICK][::-1]:
                tb, pb = int(tid[ck]), int(pos[ck])
                fl = (c_tid < tb) | ((c_tid == tb) & (c_left < pb) & (c_right < pb))
                rem = ~fl & (c_first_read <= ck)
                if rem.any():
                    rt, rl2 = c_tid[rem], c_left[rem]
                    j = np.lexsort((rl2, rt))[0]
                    self._watermark = (int(rt[j]), int(rl2[j]))
                    break

        # rank space: position in the ascending cidx (NOT the device work
        # row — rows get a group-contiguous permutation below so uploads
        # and member gathers can exploit group locality)
        rank_l = np.searchsorted(cidx, pl)
        has_right = pr >= 0
        rank_r = np.where(has_right,
                          np.searchsorted(cidx, np.where(has_right, pr, pl)),
                          -1)

        # ---- vectorized UMIs ----
        with _T("umi"):
            u_start, u_len, u_keys, u_mat = self._pair_umis_vec(
                batch, qname_mat, cidx, rank_l, rank_r, has_right)
        _, pair_ukey_id = np.unique(u_keys, return_inverse=True)
        pair_has_umi = u_len > 0

        # ---- grouping ----
        # Greedy UMI grouping (cluster.cpp:55-100) as a per-pair group RANK
        # (the position of the pair's group in the cluster's greedy
        # creation order) + one stable lexsort — no per-cluster python for
        # the overwhelming cases: single-UMI clusters rank 0 everywhere,
        # and two-distinct-UMI clusters (e.g. the duplex A_B / B_A split)
        # reduce to one vectorized umi_diff against the winner. Only >2
        # distinct UMIs take the greedy loop.
        with _T0("grouping"):
            P = npairs
            grp_rank = np.zeros(P, dtype=np.int64)
            if P:
                U = int(pair_ukey_id.max()) + 1
                comb = cluster_of_pair * U + pair_ukey_id
                uniqc, first_idx, cnts = np.unique(
                    comb, return_index=True, return_counts=True)
                ucl = uniqc // U
                uidv = uniqc % U
                n_per_cl = np.bincount(ucl, minlength=nclusters)
                cl_ptr = np.searchsorted(ucl, np.arange(nclusters + 1))
                two = np.nonzero(n_per_cl == 2)[0]
                if len(two):
                    # winner = higher count, tie -> lex-smaller (ids are
                    # lex-ordered because np.unique sorted the keys)
                    e0 = cl_ptr[two]
                    e1 = e0 + 1
                    win = np.where(cnts[e1] > cnts[e0], e1, e0)
                    p0 = first_idx[e0]
                    p1 = first_idx[e1]
                    l0 = u_len[p0]
                    l1 = u_len[p1]
                    lm = max(int(l0.max()), int(l1.max()), 1)
                    jj = np.arange(lm, dtype=np.int64)[None, :]
                    Wm = u_mat.shape[1]
                    g0 = u_mat[p0[:, None],
                               np.minimum(u_start[p0][:, None] + jj, Wm - 1)]
                    g1 = u_mat[p1[:, None],
                               np.minimum(u_start[p1][:, None] + jj, Wm - 1)]
                    ham = ((g0 != g1)
                           & (jj < np.minimum(l0, l1)[:, None])).sum(axis=1)
                    d2 = ham + np.abs(l0 - l1)  # cluster.cpp:41-53
                    split = d2 > c_thr[two]
                    if split.any():
                        wmap = np.full(nclusters, -1, dtype=np.int64)
                        wmap[two[split]] = uidv[win[split]]
                        wcl = wmap[cluster_of_pair]
                        msk = wcl >= 0
                        grp_rank[msk] = (pair_ukey_id[msk]
                                         != wcl[msk]).astype(np.int64)
                from gencore_tpu.io import native as _nat
                _glib = _nat.get_lib()
                for ci in np.nonzero(n_per_cl > 2)[0]:
                    lo, hi = int(c_pair_start[ci]), int(c_pair_end[ci])
                    if _glib is not None:
                        # columnar form: the cluster's DISTINCT umis are
                        # already lex-sorted with counts (np.unique over
                        # comb above); feed the native greedy directly —
                        # no per-pair python strings (deep amplicon piles
                        # have thousands of pairs per cluster)
                        e0, e1 = int(cl_ptr[ci]), int(cl_ptr[ci + 1])
                        firsts = first_idx[e0:e1]
                        lens_c = u_len[firsts].astype(np.int64)
                        Wc = max(int(lens_c.max()), 1)
                        cols_w = np.arange(Wc, dtype=np.int64)[None, :]
                        gidx = np.minimum(u_start[firsts][:, None] + cols_w,
                                          u_mat.shape[1] - 1)
                        matc = np.ascontiguousarray(
                            u_mat[firsts[:, None], gidx])
                        matc[cols_w >= lens_c[:, None]] = 0
                        cnts_c = np.ascontiguousarray(cnts[e0:e1],
                                                      dtype=np.int64)
                        group_of = np.empty(e1 - e0, dtype=np.int64)
                        _glib.gc_greedy_group(
                            matc.ctypes.data, lens_c.ctypes.data,
                            cnts_c.ctypes.data, e1 - e0, Wc,
                            int(c_thr[ci]), group_of.ctypes.data)
                        ids_local = np.searchsorted(
                            uidv[e0:e1], pair_ukey_id[lo:hi])
                        grp_rank[lo:hi] = group_of[ids_local]
                    else:
                        umis = [umivec.umi_string(u_mat, u_start, u_len, pi)
                                for pi in range(lo, hi)]
                        for r, idxs in enumerate(
                                greedy_umi_groups(umis, int(c_thr[ci]))):
                            grp_rank[lo + np.asarray(idxs,
                                                     dtype=np.int64)] = r
            order_p = np.lexsort((grp_rank, cluster_of_pair))
            mem_pairs = order_p.astype(np.int64)
            cl_s = cluster_of_pair[order_p]
            rk_s = grp_rank[order_p]
            newg = np.ones(P, dtype=bool)
            if P:
                newg[1:] = (cl_s[1:] != cl_s[:-1]) | (rk_s[1:] != rk_s[:-1])
            gs_idx = np.nonzero(newg)[0]
            G = len(gs_idx)
            g_start = np.append(gs_idx, P).astype(np.int64)
            g_sizes = np.diff(g_start)
            g_cluster = (cl_s[gs_idx] if G else np.zeros(0, dtype=np.int64))
            g_cross = c_right[g_cluster] < 0 if G else np.zeros(0, dtype=bool)

        # single-pair-no-right early-return groups (group.cpp:73-77):
        # excluded from election/scoring entirely
        g_single = np.zeros(G, dtype=bool)
        if G:
            first_pair = mem_pairs[g_start[:-1]]
            g_single = (g_sizes == 1) & ~has_right[first_pair]

        # ---- group-contiguous row permutation ----
        # Work rows are laid out (group, side, member-rank)-contiguous:
        # every (group, side) segment's member rows are consecutive, in
        # member order, with the segment head = the fast-path template
        # (first present member). This makes the upload duplicate-aware
        # (members ship as edits vs their segment head — see _WorkArrays)
        # and vote member gathers iota-addressable. Reads that are neither
        # a pair's left nor its (last) right sit at the tail and ship no
        # seq/qual bytes at all.
        with _T("sort.perm"):
            gidx_of_member = (np.repeat(np.arange(G), g_sizes)
                              if G else np.zeros(0, dtype=np.int64))
            lmem = pl[mem_pairs]
            rmem = np.where(has_right[mem_pairs], pr[mem_pairs], -1)
            presl = lmem >= 0
            presr = rmem >= 0
            e_reads = np.concatenate([lmem[presl], rmem[presr]])
            e_group = np.concatenate([gidx_of_member[presl],
                                      gidx_of_member[presr]])
            e_side = np.concatenate([
                np.zeros(int(presl.sum()), dtype=np.int8),
                np.ones(int(presr.sum()), dtype=np.int8)])
            e_ord = np.concatenate([np.nonzero(presl)[0],
                                    np.nonzero(presr)[0]])
            eo = np.lexsort((e_ord, e_side, e_group))
            seg_reads = e_reads[eo]
            seg_group = e_group[eo]
            seg_side = e_side[eo]
            # segment id per laid-out row: changes when (group, side) does
            ne = len(seg_reads)
            newseg = np.ones(ne, dtype=bool)
            if ne > 1:
                newseg[1:] = ((seg_group[1:] != seg_group[:-1])
                              | (seg_side[1:] != seg_side[:-1]))
            seg_of_row = np.cumsum(newseg) - 1 if ne else np.zeros(0, np.int64)
            perm_ranks = np.searchsorted(cidx, seg_reads)
            rest = np.ones(nclust, dtype=bool)
            rest[perm_ranks] = False
            perm_ranks = np.concatenate([perm_ranks, np.nonzero(rest)[0]])
            rank2row = np.empty(nclust, dtype=np.int64)
            rank2row[perm_ranks] = np.arange(nclust)
            cidx_rows = cidx[perm_ranks]

        # ---- working arrays + upload ----
        max_len = int(batch.l_qseq[cidx].max())
        # round L up so compiled kernel shapes recur across workloads
        # (shapes are bucketed and cached persistently — see
        # utils/compile_cache.py); on an accelerator the row counts are
        # bucketed too (_bucket_rows)
        self._pad_shapes = self._accelerated()
        self.max_len = max(((max_len + LANE - 1) // LANE) * LANE, LANE)
        # true data length: device->host transfers slice to this
        self.out_len = max(((max_len + 7) // 8) * 8, 8)
        with _T("materialize"):
            with _T("materialize.host"):
                gref_ok = (self._genome is not None
                           and len(self._genome) < 2**31 - _GENOME_PAD
                           and self.max_len <= _GENOME_PAD
                           and len(self._genome) > 0)
                work = _WorkArrays(batch, cidx_rows, self.max_len,
                                   w_host=self.out_len,
                                   pad_pow2=self._pad_shapes,
                                   sorted_cidx=cidx, rank2row=rank2row,
                                   seg_of_row=seg_of_row,
                                   genome=self._genome if gref_ok else None,
                                   contig_base=self._contig_base
                                   if gref_ok else None,
                                   contig_len=self._contig_len
                                   if gref_ok else None)
                self.work = work
                ct = CigarTable(batch, cidx_rows)
            # read matrices live on device for the fused kernel pipeline,
            # uploaded as arguments of a jit identity (_upload_fn)
            import jax
            # sparse uploads defer to the fused upload+score program
            # (dispatched at the score stage, after election): one device
            # execute instead of two
            defer_up = (work.upload_mode == "sparse"
                        and work.n_pad <= (1 << 16))
            if defer_up:
                seq_dev = qual_dev = lens_dev = None
            else:
                with _T("materialize.updispatch"):
                    seq_dev, qual_dev, lens_dev = work.upload(
                        genome_dev=self._genome_dev()
                        if (work.upload_mode == "sparse"
                            and work._sup["has_genome"]) else None)
                    if work.upload_mode == "sparse":
                        self._acct_up(*[v for v in work._sup.values()
                                        if isinstance(v, np.ndarray)])
                    else:
                        self._acct_up(work.seq_up, work.qual_up, work.lens,
                                      work.qtable16)
                if _SYNC_STAGES:
                    with _T("materialize.upwait"):
                        jax.block_until_ready(seq_dev)
                        jax.block_until_ready(qual_dev)

        rl = work.row_of(pl)
        rr = np.where(has_right, work.row_of(np.where(has_right, pr, pl)), -1)

        # ---- election ----
        jobs = _JobTable()
        side_jobs = {}
        flats = {}
        with _T("election"):
            for is_left in (True, False):
                sj, flat = self._elect_vectorized(
                    is_left, mem_pairs, g_start, g_sizes, g_single, pl, pr, rl, rr,
                    ct, batch, jobs)
                side_jobs[is_left] = sj
                flats[is_left] = flat

        # ---- overlap scoring (on device; matrices stay resident; fused
        # with the deferred sparse upload when applicable) ----
        with _T("score"):
            score_dev, qual_dev, seq_dev = self._score_pairs_vec(
                batch, pl, pr, rl, rr, has_right, ct, mem_pairs, g_start,
                g_sizes, side_jobs, work, seq_dev, qual_dev, lens_dev)
            if _SYNC_STAGES:
                with _T("score.wait"):
                    _jax.block_until_ready(score_dev)

        # ---- voting ----
        # =ACGTN-only data takes the reduced-bin kernel (see kernels.py);
        # checked on the packed nibbles (host no longer keeps dense rows).
        # 2-bit staging already proved pure ACGT (a subset of =ACGTN), so
        # that mode skips the scan.
        if work.seq_mode == "2bit":
            full_bins = False
        else:
            from gencore_tpu.io import native as _nat2
            seen = (_nat2.nib_seen(work.seq_packed, work.lens)
                    if work.seq_packed.flags.c_contiguous else None)
            if seen is not None:
                # threaded native census: one memory-speed pass
                full_bins = bool(
                    (seen[0].astype(bool) & ~_OK_PAIR).any()
                    or (seen[1].astype(bool) & ~_OK_CODES[:16]).any())
            else:
                pwf = work.lens // 2
                cols_p = np.arange(work.seq_packed.shape[1])
                full_bins = bool(((~_OK_PAIR[work.seq_packed])
                                  & (cols_p[None, :] < pwf[:, None])).any())
                if not full_bins:
                    oddrows = np.nonzero(work.lens % 2 == 1)[0]
                    if len(oddrows):
                        lastb = work.seq_packed[oddrows,
                                                work.lens[oddrows] // 2]
                        full_bins = bool((~_OK_HI[lastb]).any())
        with _T("vote"):
            pending = self._vote_jobs(jobs, batch, work, flats, full_bins,
                                      seq_dev, qual_dev, score_dev, ct)

        return _Dispatched(
            pending=pending, jobs=jobs, out_records=out_records,
            assemble_args=(nclusters, G, g_cluster, g_sizes, g_start,
                           g_single, g_cross, side_jobs, jobs,
                           batch, pl, pr, work, pair_has_umi, c_pair_start,
                           mem_pairs, u_mat, u_start, u_len, out_records))

    def release_run_state(self):
        """Drop per-run buffers (work matrices, batch reference, caches)
        after a window's results are consumed. The stats/timer fields the
        window pipeline merges at the end survive; OutputTable holds its
        own references to anything the payload build still needs. Without
        this, a W-window run retains W windows' worth of matrices (the
        streaming mode's whole point is NOT doing that)."""
        self.work = None
        self.batchref = None
        self._nm_vals = None
        self._nm_patch = None
        self._ipo_cache = {}
        self._cig_cache = {}
        self._refoff_cache = {}

    def run_collect(self, st: "_Dispatched"):
        """Blocking half of a dispatched run: download vote results,
        assemble records, finalize stats/output."""
        if st.done is not None:
            return st.done
        _T = self.timer.stage
        with _T("vote"):
            self._vote_collect(st.jobs, st.pending)
        if getattr(self, "_warm_only", False):
            return None

        # ---- per-cluster assembly + duplex + thresholds (columnar) ----
        with _T("assemble"):
            self._assemble_all(*st.assemble_args)

        with _T("finalize"):
            out = self._finalize(st.out_records)
        # wire accounting (bytes -> MB pseudo-stages; summed across window
        # engines by the pipeline's stage_totals merge)
        self.timer.totals["wire.h2dMB"] = (
            self.timer.totals.get("wire.h2dMB", 0.0) + self.wire_h2d / 1e6)
        self.timer.totals["wire.d2hMB"] = (
            self.timer.totals.get("wire.d2hMB", 0.0) + self.wire_d2h / 1e6)
        return out

    # ------------------------------------------------------------------
    def _mi_candidate_ranks(self, batch, cidx):
        """Exact vectorized MI-presence pre-filter: ranks (positions in
        cidx) whose aux region could hold an MI:Z tag. A real MI tag always
        embeds the bytes 'M','I','Z' consecutively, so a whole-payload
        3-byte pattern scan restricted to aux spans is sound (a value-byte
        false positive only costs a per-record verification walk). Replaces
        the round-3 sampled probe, which could miss minority-MI files
        (reference consults MI per read, bamutil.cpp:23-38)."""
        d = batch.data
        if len(d) < 4 or len(cidx) == 0:
            return np.zeros(0, dtype=np.int64)
        from gencore_tpu.io import native as _nat
        if d.flags.c_contiguous:
            flags = _nat.mi_flags(d, batch.aux_off, batch.end)
            if flags is not None:
                # threaded memchr over aux spans only (~30 B/read) instead
                # of the whole payload; identical candidate predicate
                return np.nonzero(flags[cidx] != 0)[0]
        # one full-payload compare finds 'M' candidates (~1/256 density);
        # the 'I'/'Z' confirmation then touches only those few positions —
        # no payload copy, ~1.3 passes total vs 4 for a 3-way compare
        cand = np.nonzero(d[:-3] == ord("M"))[0]
        if not len(cand):
            return np.zeros(0, dtype=np.int64)
        pp = cand[(d[cand + 1] == ord("I")) & (d[cand + 2] == ord("Z"))]
        if not len(pp):
            return np.zeros(0, dtype=np.int64)
        rec = np.searchsorted(batch.off, pp, side="right") - 1
        valid = ((rec >= 0) & (pp >= batch.aux_off[rec])
                 & (pp + 3 < batch.end[rec]))
        recs = np.unique(rec[valid])
        # restrict to clustered records, mapped to ranks in cidx
        rk = np.searchsorted(cidx, recs)
        ok = (rk < len(cidx)) & (cidx[np.clip(rk, 0, len(cidx) - 1)] == recs)
        return rk[ok]

    def _pair_umis_vec(self, batch, qname_mat, cidx, rl, rr, has_right):
        """Per-pair UMI spans (start, len, fixed-width key, source matrix).

        Qname-vectorized; MI tags win over qname PER READ
        (bamutil.cpp:23-38) — candidate rows come from an exact vectorized
        aux scan. Mate UMI mismatch is fatal (pair.cpp:196-216).
        """
        prefix = self.opt.umi_prefix
        cand = self._mi_candidate_ranks(batch, cidx)
        has_mi = len(cand) > 0
        self._mi_has_rank = None
        self._qname_umi = None
        if not has_mi:
            src_mat = qname_mat
            src_len = batch.l_read_name[cidx].astype(np.int64) - 1
        else:
            # MI tag wins over qname, per read (bamutil.cpp:23-38); the tag
            # values are batch-extracted via a layout probe and substituted
            # into the parse matrix for the rows that carry one
            maybe = np.zeros(len(cidx), dtype=bool)
            maybe[cand] = True
            mi_mat, mi_len, mi_has = self._extract_str_tag(
                batch, cidx, b"MI", fallback_mask=maybe)
            qlen = batch.l_read_name[cidx].astype(np.int64) - 1
            W = max(qname_mat.shape[1], mi_mat.shape[1])
            src_mat = np.zeros((len(cidx), W), dtype=np.uint8)
            src_mat[:, :qname_mat.shape[1]] = qname_mat
            src_len = qlen.copy()
            src_mat[mi_has, :] = 0
            src_mat[mi_has, :mi_mat.shape[1]] = mi_mat[mi_has]
            src_len[mi_has] = mi_len[mi_has]
            self._mi_has_rank = mi_has
            self._umi_cidx = cidx
            # qname-only umi spans, for the qname-copy reconciliation path
            # (a merged read whose template lacks MI takes the umi from its
            # possibly-copied qname, oracle get_umi / pair.cpp:192)
            qs, ql2 = umivec.umi_spans(
                qname_mat, batch.l_read_name[cidx].astype(np.int64) - 1,
                prefix)
            self._qname_umi = (qname_mat, qs, ql2)
        start_all, len_all = umivec.umi_spans(src_mat, src_len, prefix)
        if has_mi:
            self._umi_read_arrays = (src_mat, start_all, len_all)
        keys_all, _ = umivec.umi_keys(src_mat, start_all, len_all)
        rr_c = np.clip(rr, 0, None)
        ll = len_all[rl]
        lk = keys_all[rl]
        rk = np.where(has_right, keys_all[rr_c], b"")
        mism = has_right & (ll > 0) & (lk != rk)
        if mism.any():
            pi = int(np.nonzero(mism)[0][0])
            a = umivec.umi_string(src_mat, start_all, len_all, int(rl[pi]))
            b = umivec.umi_string(src_mat, start_all, len_all, int(rr[pi]))
            raise ValueError(
                "The UMI of a read pair should be identical, "
                f"but we got {a} and {b}")
        use_right = (ll == 0) & has_right
        src_row = np.where(use_right, rr_c, rl)
        return (start_all[src_row], len_all[src_row],
                np.where(use_right, rk, lk), src_mat[src_row])

    def _extract_str_tag(self, batch, idx: np.ndarray, tag: bytes,
                         scan_w: int = 256, fallback_mask=None):
        """Vectorized Z-typed aux-tag extraction for records `idx`:
        (mat uint8[n, <=scan_w], lens int64[n], has bool[n]). Same layout-
        probe strategy as _extract_nm — a constant tag offset from aux_off
        is verified per record (tag bytes + 'Z' type); probe misses walk
        the aux chain per record (restricted to fallback_mask rows when
        given — rows a pre-filter already cleared never pay the walk)."""
        n = len(idx)
        datalen = len(batch.data)
        delta = None
        for k in range(min(n, 8)):
            off, typ = batch.find_tag(int(idx[k]), tag)
            if off is not None and typ == "Z":
                delta = off - int(batch.aux_off[idx[k]])
                break
        ends = batch.end[idx]
        if delta is None:
            ok = np.zeros(n, dtype=bool)
            cand = np.zeros(n, dtype=np.int64)
        else:
            cand = batch.aux_off[idx].astype(np.int64) + delta
            ok = cand + 1 <= ends
            ok &= batch.data[np.clip(cand - 3, 0, datalen - 1)] == tag[0]
            ok &= batch.data[np.clip(cand - 2, 0, datalen - 1)] == tag[1]
            ok &= batch.data[np.clip(cand - 1, 0, datalen - 1)] == ord("Z")
        cols = np.arange(scan_w, dtype=np.int64)
        g = np.clip(cand[:, None] + cols[None, :], 0, datalen - 1)
        wmat = batch.data[g]
        isnul = (wmat == 0) | ((cand[:, None] + cols[None, :])
                               >= ends[:, None])
        has_nul = isnul.any(axis=1)
        ln = np.where(has_nul, isnul.argmax(axis=1), 0).astype(np.int64)
        ok &= has_nul
        mat = np.where(cols[None, :] < ln[:, None], wmat, 0)
        has = ok.copy()
        ln[~ok] = 0
        walk = ~ok if fallback_mask is None else (~ok & fallback_mask)
        for k in np.nonzero(walk)[0]:
            off, typ = batch.find_tag(int(idx[k]), tag)
            if off is None or typ != "Z":
                continue
            e = int(ends[k])
            seg = batch.data[off:e]
            z = np.nonzero(seg == 0)[0]
            ln_k = min(int(z[0]) if len(z) else len(seg), scan_w)
            mat[k, :ln_k] = seg[:ln_k]
            mat[k, ln_k:] = 0
            ln[k] = ln_k
            has[k] = True
        return mat, ln, has

    # ------------------------------------------------------------------
    def _elect_vectorized(self, is_left, mem_pairs, g_start, g_sizes, g_single,
                          pl, pr, rl, rr, ct, batch, jobs):
        """Election for one side over all groups: vectorized fast path for
        single-cigar-class groups, python fallback otherwise
        (reference group.cpp:136-318)."""
        G = len(g_sizes)
        side_job = np.full(G, -1, dtype=np.int64)
        if G == 0:
            return side_job, np.zeros(0, dtype=np.int64)
        side_read = (pl if is_left else pr)[mem_pairs]
        present = side_read >= 0
        srow = np.where(present, (rl if is_left else rr)[mem_pairs], 0)
        cls = np.where(present, ct.class_id[srow], -1)
        ncig = np.where(present, ct.n_cigar[srow], 0)
        segs = g_start[:-1]
        n_present = np.add.reduceat(present.astype(np.int64), segs)
        cls_min = np.minimum.reduceat(np.where(present, cls, BIG), segs)
        cls_max = np.maximum.reduceat(np.where(present, cls, -1), segs)
        same_class = (cls_min == cls_max) & (n_present > 0)
        has_cigar = np.maximum.reduceat(ncig, segs) > 0
        if is_left:
            aligned = np.ones(G, dtype=bool)
        else:
            rp = np.where(present,
                          batch.pos[np.where(present, side_read, 0)].astype(np.int64), 0)
            p_min = np.minimum.reduceat(np.where(present, rp, BIG), segs)
            p_max = np.maximum.reduceat(np.where(present, rp, -1), segs)
            aligned = p_min == p_max
        fast = same_class & has_cigar & aligned & (n_present > 0) & ~g_single
        ok = fast & ~((n_present < g_sizes * 0.4) & (g_sizes != 1))

        ordv = np.arange(len(mem_pairs), dtype=np.int64) - np.repeat(segs, g_sizes)
        first_present = np.minimum.reduceat(np.where(present, ordv, BIG), segs)

        gidx_of_member = np.repeat(np.arange(G), g_sizes)
        sel = present & ok[gidx_of_member]
        flat_rows = srow[sel]
        counts = np.add.reduceat(sel.astype(np.int64), segs)
        flat_ptr = np.zeros(G + 1, dtype=np.int64)
        np.cumsum(counts, out=flat_ptr[1:])

        tmpl_member = segs + np.where(first_present == BIG, 0, first_present)
        tmpl_member = np.clip(tmpl_member, 0, max(len(side_read) - 1, 0))
        tmpl_read = side_read[tmpl_member]
        tmpl_pair = mem_pairs[tmpl_member]
        oki = np.nonzero(ok)[0]
        if len(oki):
            tr = tmpl_read[oki]
            base = jobs.append_fast_block(
                oki, is_left, tr, tmpl_pair[oki],
                batch.l_qseq[tr].astype(np.int64),
                flat_ptr[oki], counts[oki])
            side_job[oki] = base + np.arange(len(oki), dtype=np.int64)

        for gi in np.nonzero(~fast & (n_present > 0) & ~g_single)[0]:
            lo, hi = int(g_start[gi]), int(g_start[gi + 1])
            side_reads = [int(side_read[m]) for m in range(lo, hi)]
            job = self._elect_side_python(int(gi), is_left, side_reads,
                                          [int(mem_pairs[m]) for m in range(lo, hi)],
                                          batch)
            if job is not None:
                side_job[gi] = jobs.append_job(job)
        return side_job, flat_rows

    # ------------------------------------------------------------------
    def _cig(self, batch, read_idx: int):
        key = batch.data[batch.cigar_off[read_idx]:batch.seq_off[read_idx]].tobytes()
        c = self._cig_cache.get(key)
        if c is None:
            c = np.frombuffer(key, dtype=np.uint32)
            self._cig_cache[key] = c
        return key, c

    def _is_part_of(self, key_a, cig_a, key_b, cig_b, mode: bool) -> bool:
        k = (key_a, key_b, mode)
        v = self._ipo_cache.get(k)
        if v is None:
            v = cig.is_part_of(cig_a, cig_b, mode)
            self._ipo_cache[k] = v
        return v

    def _elect_side_python(self, gid: int, is_left: bool, side_reads: list,
                           pair_ids: list, batch):
        """Full-fidelity election (reference group.cpp:136-318) for groups
        with mixed cigars / unaligned right reads / SE no-cigar reads."""
        opt = self.opt
        npairs = len(side_reads)

        if npairs > opt.skip_low_complexity_cluster_threshold:
            cigars = set()
            first_read = -1
            for ri in side_reads:
                if ri >= 0:
                    cigars.add(self._cig(batch, ri)[0])
                    if first_read < 0:
                        first_read = ri
            if len(cigars) > npairs * 0.1 and first_read >= 0:
                seq = batch.seq_codes(first_read)
                diff_neighbor = int((seq[:-1] != seq[1:]).sum())
                if diff_neighbor < len(seq) * 0.5:
                    if opt.debug:  # group.cpp:169-171
                        import sys
                        print(f"Skipping {npairs} low complexity reads "
                              f"like: {bamio.codes_to_seq_str(seq)}",
                              file=sys.stderr)
                    return None

        left_read_mode = is_left
        if not is_left:
            last_pos = -1
            left_aligned = True
            for ri in side_reads:
                if ri >= 0:
                    rp = int(batch.pos[ri])
                    if last_pos >= 0 and rp != last_pos:
                        left_aligned = False
                        break
                    last_pos = rp
            if left_aligned:
                left_read_mode = True

        keys = []
        rrps = []
        for ri in side_reads:
            if ri >= 0:
                k, c = self._cig(batch, ri)
                keys.append((k, c))
                rrps.append(int(batch.pos[ri]) + cig.ref_len(c) if not is_left else 0)
            else:
                keys.append(None)
                rrps.append(0)

        contained_by = [0] * npairs
        early_break = npairs > opt.skip_low_complexity_cluster_threshold
        for i in range(npairs):
            if keys[i] is None:
                continue
            cby = 1
            for j in range(npairs):
                if i == j or keys[j] is None:
                    continue
                if not is_left and rrps[i] != rrps[j]:
                    continue
                if self._is_part_of(keys[i][0], keys[i][1],
                                    keys[j][0], keys[j][1], left_read_mode):
                    cby += 1
            contained_by[i] = cby
            if early_break and cby >= npairs // 2:
                break

        most_id = -1
        most_num = -1
        for i in range(npairs):
            if contained_by[i] > most_num:
                most_num = contained_by[i]
                most_id = i
            elif contained_by[i] == most_num and most_id >= 0:
                bi = side_reads[i]
                bc = side_reads[most_id]
                this_len = int(batch.l_qseq[bi]) if bi >= 0 else 0
                cur_len = int(batch.l_qseq[bc]) if bc >= 0 else 0
                if this_len < cur_len:
                    most_num = contained_by[i]
                    most_id = i

        if most_num < npairs * 0.4 and npairs != 1:
            return None
        template = side_reads[most_id]
        if template < 0:
            return None

        tkey, tcig = self._cig(batch, template)
        members_reads = [template]
        for j in range(npairs):
            if j == most_id or side_reads[j] < 0:
                continue
            rj = side_reads[j]
            jkey, jcig = self._cig(batch, rj)
            # collection: template contained by member (group.cpp:309)
            if self._is_part_of(tkey, tcig, jkey, jcig, left_read_mode):
                members_reads.append(rj)

        tlen_q = int(batch.l_qseq[template])
        len_diffs = []
        for rj in members_reads:
            d = int(batch.l_qseq[rj]) - tlen_q
            if d != 0:
                jkey, jcig = self._cig(batch, rj)
                # aligner WAR (group.cpp:339-349)
                if int(batch.pos[rj]) == int(batch.pos[template]) and \
                        self._is_part_of(tkey, tcig, jkey, jcig, True):
                    d = 0
            len_diffs.append(d)

        job_len = tlen_q
        if len(tcig) == 0:
            for rj in members_reads:
                job_len = min(job_len, int(batch.l_qseq[rj]))

        return _Job(group_id=gid, is_left_side=is_left,
                    left_read_mode=left_read_mode, template_read=template,
                    template_pair=pair_ids[most_id], job_len=job_len,
                    members_reads=members_reads, len_diffs=len_diffs,
                    k=len(members_reads))

    # ------------------------------------------------------------------
    def _score_pairs_vec(self, batch, pl, pr, rl, rr, has_right, ct,
                         mem_pairs, g_start, g_sizes, side_jobs, work,
                         seq_dev, qual_dev, lens_dev=None):
        """Overlap scoring for every pair of any group owning >= 1 job
        (reference fetches scores for all group pairs, group.cpp:272,300-304).
        Runs fully on device; returns (score_dev, qual_dev, seq_dev).
        seq_dev is None on entry when the sparse upload was deferred: the
        fused upload+score program then builds the resident matrices AND
        scores in one execute."""
        import jax
        import jax.numpy as jnp
        o = self.opt
        deferred = seq_dev is None
        G = len(g_sizes)
        N = work.n_pad
        opts = dict(hi=o.high_quality, mod=o.moderate_quality,
                    lo=o.low_quality,
                    s_hi=o.score_not_overlapped_high_qual,
                    s_mod=o.score_not_overlapped_moderate_qual,
                    s_lo=o.score_not_overlapped_low_qual,
                    s_bad=o.score_not_overlapped_bad_qual)
        _Ts = self.timer.stage

        # geometry of scored pairs (possibly empty)
        lrow = rrow = None
        if G:
            need_g = (side_jobs[True] >= 0) | (side_jobs[False] >= 0)
            gidx_of_member = np.repeat(np.arange(G), g_sizes)
            need_pair_mask = np.zeros(len(pl), dtype=bool)
            need_pair_mask[mem_pairs[need_g[gidx_of_member]]] = True
            sel = np.nonzero(need_pair_mask & has_right)[0]
            if len(sel):
                lr0 = rl[sel]
                rr0 = rr[sel]
                lmo, lml = ct.m_off[lr0], ct.m_len[lr0]
                rmo, rml = ct.m_off[rr0], ct.m_len[rr0]
                okg = (lml > 0) & (rml > 0)
                if okg.any():
                    lrow, rrow = lr0[okg], rr0[okg]
                    lmo, lml = lmo[okg], lml[okg]
                    rmo, rml = rmo[okg], rml[okg]
                    sel = sel[okg]
                    pos_dis = (batch.pos[pr[sel]].astype(np.int64)
                               - batch.pos[pl[sel]].astype(np.int64))
                    fwd = pos_dis >= 0
                    ls = np.where(fwd, lmo + pos_dis, lmo)
                    rs = np.where(fwd, rmo, rmo - pos_dis)
                    cl = np.where(fwd, np.minimum(lml - pos_dis, rml),
                                  np.minimum(lml, rml + pos_dis))

        if deferred:
            # fused upload+score (one execute). Empty geometry still runs
            # the program: all rows unscored -> moderate default + original
            # quals (pair.cpp:92), which the plain path's `default` mirrors.
            # When NO pair overlaps (amplicon panels: mate gap >= read
            # length), the per-row geometry is pure wire waste — ship one
            # scored BIT per row instead and score by qual tier alone
            # (in_ov is empty so the kernels agree exactly).
            no_ov = lrow is None or not bool((cl > 0).any())
            if no_ov:
                scored_m = np.zeros(N, dtype=bool)
                if lrow is not None:
                    scored_m[lrow] = True
                    scored_m[rrow] = True
                mate16 = np.zeros(1, dtype=np.uint16)
                meta = np.packbits(scored_m, bitorder="little")
            else:
                mate16, meta = _pack_score_meta(N, lrow, rrow, ls, rs, cl)
            s = work._sup
            self._acct_up(mate16, meta,
                          *[v for v in s.values()
                            if isinstance(v, np.ndarray)])
            g = (self._genome_dev() if s["has_genome"]
                 else np.zeros(1, np.uint8))
            with _Ts("score.dispatch"):
                seq_dev, qual_dev, score_dev = _upload_score_fn(
                    work.w_host, work.L, s["mode2"], s["has_sedit"],
                    s["has_qdense"], s["has_qedit"], s["const_lens"],
                    opts["hi"], opts["mod"], opts["lo"], opts["s_hi"],
                    opts["s_mod"], opts["s_lo"], opts["s_bad"],
                    s["has_genome"], no_ov)(
                    s["sd"], s["src"], s["scnt"], s["epos"], s["ecode"],
                    s["base"], s["q_src"], s["qd"], s["qcnt"], s["qpos"],
                    s["qval"], s["lens16"], mate16, meta, g, s["gslots"])
            # staging handed to the async dispatch; jax holds what it
            # needs — drop our references so inflight windows don't stack
            # ~8MB of dead staging each
            work._sup = None
            return score_dev, qual_dev, seq_dev

        default = jnp.full((work.n_pad, work.L),
                           o.score_not_overlapped_moderate_qual,
                           dtype=jnp.int8)
        if lrow is None:
            return default, qual_dev, seq_dev
        if lens_dev is not None and work.w_host <= 256 and N <= (1 << 16):
            # packed wire form: u32 geometry + u16 mate row = 6 B/row
            # (was 22 B across 7 arrays). cmp_len <= 0 (no overlap) clamps
            # to an empty window with start 0 — identical semantics.
            mate16, meta = _pack_score_meta(N, lrow, rrow, ls, rs, cl)
            self._acct_up(mate16, meta)
            with _Ts("score.dispatch"):
                score_dev, qual_dev = kernels.score_map_kernel_packed(
                    seq_dev, qual_dev, lens_dev, mate16, meta, **opts)
            return score_dev, qual_dev, seq_dev
        mate_row = np.arange(N, dtype=np.int32)
        my_start = np.zeros(N, dtype=np.int32)
        mt_start = np.zeros(N, dtype=np.int32)
        cmp_len = np.zeros(N, dtype=np.int32)
        my_len = np.zeros(N, dtype=np.int32)
        is_left = np.zeros(N, dtype=bool)
        scored = np.zeros(N, dtype=bool)
        llen = batch.l_qseq[pl[sel]].astype(np.int32)
        rlen = batch.l_qseq[pr[sel]].astype(np.int32)
        mate_row[lrow] = rrow
        mate_row[rrow] = lrow
        my_start[lrow] = ls
        my_start[rrow] = rs
        mt_start[lrow] = rs
        mt_start[rrow] = ls
        cmp_len[lrow] = cl
        cmp_len[rrow] = cl
        my_len[lrow] = llen
        my_len[rrow] = rlen
        is_left[lrow] = True
        scored[lrow] = True
        scored[rrow] = True
        self._acct_up(mate_row, my_start, mt_start, cmp_len, my_len,
                      is_left, scored)
        with _Ts("score.dispatch"):
            score_dev, qual_dev = kernels.score_map_kernel(
                seq_dev, qual_dev, mate_row, my_start, mt_start, cmp_len,
                my_len, is_left, scored, **opts)
        return score_dev, qual_dev, seq_dev

    # ------------------------------------------------------------------
    def _ref_offsets(self, key: bytes, c: np.ndarray, length: int):
        k = (key, length)
        v = self._refoff_cache.get(k)
        if v is None:
            v = cig.ref_offsets_vector(c, length)
            self._refoff_cache[k] = v
        return v

    def _replay_ref_guards(self, guard_tid, guard_ok):
        """Replay a window's per-job Reference::getData calls through
        FastaRef.guard in job order, for stderr warning parity
        (reference.cpp:33-71: one-shot 'not found', per-call length
        mismatch, silence while the cache holds a good contig)."""
        if self.fasta is None:
            return
        called = np.nonzero(guard_tid >= 0)[0]
        if called.size == 0:
            return
        if guard_ok[called].all():
            # no warnings possible; just land the cache on the last
            # contig touched (reference.cpp:67-70)
            self.fasta._last_contig = \
                self.header.names[int(guard_tid[called[-1]])]
            self.fasta._last_ok = True
            return
        for j in called:
            self.fasta.guard(self.header.names[int(guard_tid[j])],
                             bool(guard_ok[j]))

    def _refbase_all(self, jobs: list, batch, ct, work) -> np.ndarray:
        """Reference bases for ALL jobs at once (group.cpp:362-367,430-439):
        vectorized grouping by (cigar class id, job_len) — one contig gather
        per distinct class instead of per-job python byte extraction."""
        L = self.work.L
        J = len(jobs)
        out = np.zeros((J, L), dtype=np.uint8)
        if self._genome is None or J == 0:
            return out
        tmpl = jobs.col("tmpl_read")
        jlen = jobs.col("job_len")
        need = ((batch.isize[tmpl] != 0) & (batch.n_cigar[tmpl] != 0)
                & (jlen > 0))
        if not need.any():
            return out
        rows_w = work.row_of(tmpl)  # ct arrays are indexed by work row
        key = ct.class_id[rows_w] * (int(jlen.max()) + 1) + jlen
        key[~need] = -1
        uniq, inv = np.unique(key, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        bounds = np.nonzero(np.diff(inv[order]))[0] + 1
        guard_tid = np.full(J, -1, dtype=np.int64)
        guard_ok = np.zeros(J, dtype=bool)
        for jjs in np.split(order, bounds):
            if key[jjs[0]] < 0:
                continue
            tr = int(tmpl[jjs[0]])
            ckey = batch.data[batch.cigar_off[tr]:batch.seq_off[tr]].tobytes()
            jl = int(jlen[jjs[0]])
            c = np.frombuffer(ckey, dtype=np.uint32)
            offs = self._ref_offsets(ckey, c, jl)
            # span check uses getRefOffset(out, len-1)+1 (group.cpp:364)
            reflen = int(offs[jl - 1]) + 1
            trs = tmpl[jjs]
            tids = np.clip(batch.tid[trs].astype(np.int64), 0,
                           len(self._contig_len) - 1)
            poss = batch.pos[trs].astype(np.int64)
            clen = self._contig_len[tids]
            avail = (clen > 0) & (poss + reflen < clen)
            guard_tid[jjs] = batch.tid[trs].astype(np.int64)
            guard_ok[jjs] = avail
            if not avail.any():
                continue
            base = self._contig_base[tids]
            gidx = base[:, None] + poss[:, None] + offs[None, :]
            np.clip(gidx, 0, max(len(self._genome) - 1, 0), out=gidx)
            codes = _ASCII_TO_NT16[self._genome[gidx]]
            codes[:, offs < 0] = 0
            codes[~avail] = 0
            out[jjs[:, None], np.arange(jl)[None, :]] = codes
        self._replay_ref_guards(guard_tid, guard_ok)
        return out

    def _genome_dev(self):
        """NT16-coded genome resident in HBM, cached on the FastaRef so it
        uploads once per reference (reused across runs/windows/shards).
        Padded by _GENOME_PAD so clamped end-of-genome dynamic slices never
        shift real data."""
        # _genome layout depends on the header's contig order; key on a
        # fingerprint of (base, len) per contig so a FastaRef reused across
        # headers with different orderings never returns a stale device
        # genome (same total length is not enough). The pinned device is
        # part of the key: the window pipeline round-robins engines over
        # jax.default_device and each chip needs its own resident copy.
        import jax as _jax
        dev_pin = _jax.config.jax_default_device
        key = ("nt16", len(self._genome),
               self._contig_base.tobytes(), self._contig_len.tobytes(),
               str(dev_pin))
        cache = getattr(self.fasta, "_gdev_cache", None)
        if cache is None:
            cache = {}
            if self.fasta is not None:
                self.fasta._gdev_cache = cache
        elif not isinstance(cache, dict):
            cache = {}
            self.fasta._gdev_cache = cache
        hit = cache.get(key)
        if hit is not None:
            return hit
        gn = np.pad(_ASCII_TO_NT16[self._genome], (0, _GENOME_PAD))
        dev = _upload_fn()(gn, np.zeros(1, np.uint8))[0]
        cache[key] = dev
        return dev

    def _refbase_host_args(self, jobs: list, batch, ct, work):
        """Host-side inputs for the on-device refbase assembly
        (group.cpp:362-367,430-439): contiguous all-M cigar classes (the
        overwhelmingly common case) gather straight from the HBM-resident
        genome via a [J] genome offset; non-contiguous classes
        (indels/clips shifting ref offsets) build compact host rows.
        Returns (gp int32[J2], hr uint8[H2, L], hm int16/32[J2],
        jp uint16[J2])."""
        L = self.work.L
        J = len(jobs)
        tmpl = jobs.col("tmpl_read")
        jlen = jobs.col("job_len")
        need = ((batch.isize[tmpl] != 0) & (batch.n_cigar[tmpl] != 0)
                & (jlen > 0))
        gpos = np.zeros(J, dtype=np.int32)
        host_map = np.zeros(J, dtype=np.int32)  # row 0 = all-zero row
        host_rows = [np.zeros((1, L), dtype=np.uint8)]
        jl32 = np.zeros(J, dtype=np.int32)
        # per-job Reference::getData call record for warning parity
        # (reference.cpp:33-71): tid of the call (-1 = no call) and
        # whether the lookup succeeded; replayed through FastaRef.guard
        # in job order after the class loop
        guard_tid = np.full(J, -1, dtype=np.int64)
        guard_ok = np.zeros(J, dtype=bool)
        if need.any():
            rows_w = work.row_of(tmpl)
            key = ct.class_id[rows_w] * (int(jlen.max()) + 1) + jlen
            key[~need] = -1
            uniq, inv = np.unique(key, return_inverse=True)
            order = np.argsort(inv, kind="stable")
            bounds = np.nonzero(np.diff(inv[order]))[0] + 1
            for jjs in np.split(order, bounds):
                if key[jjs[0]] < 0:
                    continue
                tr = int(tmpl[jjs[0]])
                ckey = batch.data[batch.cigar_off[tr]:batch.seq_off[tr]].tobytes()
                jl = int(jlen[jjs[0]])
                c = np.frombuffer(ckey, dtype=np.uint32)
                offs = self._ref_offsets(ckey, c, jl)
                reflen = int(offs[jl - 1]) + 1
                trs = tmpl[jjs]
                tids = np.clip(batch.tid[trs].astype(np.int64), 0,
                               len(self._contig_len) - 1)
                poss = batch.pos[trs].astype(np.int64)
                clen = self._contig_len[tids]
                avail = (clen > 0) & (poss + reflen < clen)
                guard_tid[jjs] = batch.tid[trs].astype(np.int64)
                guard_ok[jjs] = avail
                if not avail.any():
                    continue
                base = self._contig_base[tids]
                if reflen == jl and bool((offs == np.arange(jl)).all()):
                    sel = jjs[avail]
                    gpos[sel] = (base + poss)[avail].astype(np.int32)
                    host_map[sel] = -1
                    jl32[sel] = jl
                else:
                    gidx = base[:, None] + poss[:, None] + offs[None, :]
                    np.clip(gidx, 0, max(len(self._genome) - 1, 0), out=gidx)
                    codes = _ASCII_TO_NT16[self._genome[gidx]]
                    codes[:, offs < 0] = 0
                    codes[~avail] = 0
                    rows = np.zeros((len(jjs), L), dtype=np.uint8)
                    rows[:, :jl] = codes
                    start = sum(r.shape[0] for r in host_rows)
                    host_rows.append(rows)
                    host_map[jjs] = np.arange(start, start + len(jjs),
                                              dtype=np.int32)
        self._replay_ref_guards(guard_tid, guard_ok)
        J2 = _bucket_rows(max(J, 1)) if self._pad_shapes else J
        hr = np.concatenate(host_rows, axis=0)
        H2 = _bucket_rows(hr.shape[0]) if self._pad_shapes else hr.shape[0]
        hr = np.pad(hr, ((0, H2 - hr.shape[0]), (0, 0)))
        gp = np.pad(gpos, (0, J2 - J))
        hm = np.pad(host_map, (0, J2 - J))
        if hr.shape[0] <= 0x7FFF:
            hm = hm.astype(np.int16)
        jp = np.pad(jl32, (0, J2 - J)).astype(np.uint16)
        self._acct_up(gp, hr, hm, jp)
        return gp, hr, hm, jp

    def _refbase_device(self, jobs: list, batch, ct, work):
        """Standalone dispatch of the refbase assembly; the fused window
        vote runs the same combine inside its own program instead."""
        gp, hr, hm, jp = self._refbase_host_args(jobs, batch, ct, work)
        return _refbase_combine_fn(self.work.L)(
            self._genome_dev(), gp, hr, hm, jp)

    def _vote_jobs(self, jobs: list, batch, work, flats, full_bins,
                   seq_dev, qual_dev, score_dev, ct):
        if not jobs:
            return []
        import os
        import jax
        o = self.opt
        rnum, rden = kernels.ratio_fraction(o.score_percent_req)
        L = work.L
        # the [K, J, L] vote (core/vote.py) covers =ACGTN data; other
        # bases take kernels.fused_vote_kernel's full 16-bin vote
        device_vote = not full_bins and self._accelerated()
        # sparse download encoding needs byte-sized positions (out_len <= 256)
        self._sparse_dl = (device_vote and self.out_len <= 256
                           and not os.environ.get("GENCORE_NO_SPARSE"))
        # qual-value nibble table for the sparse encoding (halves the run
        # values on the wire); decode side reads the same table
        self._sparse_qtable = (self._vote_qual_table()
                               if self._sparse_dl else None)
        refbase_all = refbase_dev = None
        devref_ok = (device_vote and self._genome is not None
                     and len(self._genome) < 2**31 - _GENOME_PAD
                     and L <= _GENOME_PAD
                     and not os.environ.get("GENCORE_NO_DEVREF"))
        # the fused window program assembles refbase inside itself; a
        # standalone dispatch happens lazily only if a leftover bucket
        # needs it (see below)
        fuse_window = (devref_ok and self._sparse_dl
                       and not os.environ.get("GENCORE_NO_CONTIG_VOTE"))
        refbase_args = None
        with self.timer.stage("vote.refbase"):
            if fuse_window:
                refbase_args = self._refbase_host_args(jobs, batch, ct, work)
            elif devref_ok:
                refbase_dev = self._refbase_device(jobs, batch, ct, work)
            else:
                refbase_all = self._refbase_all(jobs, batch, ct, work)
        nj = len(jobs)
        k_col = jobs.col("k")
        fs_col = jobs.col("flat_start")
        side_col = jobs.col("is_left")
        jl_col = jobs.col("job_len")
        # next_pow2 per job, vectorized (bit-smear)
        kb_col = np.maximum(k_col, 1) - 1
        for s in (1, 2, 4, 8, 16, 32):
            kb_col |= kb_col >> s
        kb_col += 1

        _T = self.timer.stage
        pending = []
        handled = np.zeros(nj, dtype=bool)

        # ---- fused whole-window vote (ONE device execute) ----
        # The group-contiguous row layout means a fast job's member rows
        # are base..base+k-1 with the template at base, so every k-class
        # ships 9-11 B/job (base, count, jl, ridx) and the whole window's
        # refbase assembly + gathers + votes + sparse encodes + download
        # concat run in one program. k-classes are
        # quantized to {4, 16, pow2<=256}; deeper/non-contiguous jobs
        # (rare) take the gathered per-bucket path below.
        wflat_made = False
        if fuse_window and nj:
            from gencore_tpu.core import vote as _vote
            fl = flats[True]
            fr = flats[False]
            fastm = fs_col >= 0
            base_all = np.zeros(nj, dtype=np.int64)
            if fastm.any():
                fsel = np.nonzero(fastm)[0]
                fls = fs_col[fsel]
                base_all[fsel] = np.where(
                    side_col[fsel],
                    (fl if len(fl) else np.zeros(1, np.int64))[
                        np.clip(fls, 0, max(len(fl) - 1, 0))],
                    (fr if len(fr) else np.zeros(1, np.int64))[
                        np.clip(fls, 0, max(len(fr) - 1, 0))])
            contig = fastm.copy()
            for side, flat in ((True, fl), (False, fr)):
                m = fastm & (side_col == side)
                if not m.any() or len(flat) == 0:
                    continue
                step = np.ones(len(flat), dtype=np.int64)
                step[1:] = (np.diff(flat) != 1).astype(np.int64)
                cb = np.cumsum(step)
                sel = np.nonzero(m)[0]
                fs_s = fs_col[sel]
                last = np.clip(fs_s + k_col[sel] - 1, 0, len(flat) - 1)
                contig[sel] &= (cb[last] - cb[fs_s]) == 0
            cls = np.where(k_col <= 4, 4,
                           np.where(k_col <= 16, 16, kb_col))
            contig &= k_col <= 255
            classes = []
            class_args = []
            entries = []
            rdt = np.uint16 if work.n_pad <= (1 << 16) else np.uint32
            jdt = np.uint16 if nj <= 0xFFFF else np.uint32
            for K in (np.unique(cls[contig]) if contig.any() else ()):
                K = int(K)
                jlist = np.nonzero(contig & (cls == K))[0]
                J = len(jlist)
                J2 = _bucket_rows(max(J, 1)) if self._pad_shapes else J
                base_row = np.full(J2, work.dummy_row, dtype=rdt)
                base_row[:J] = base_all[jlist]
                counts = np.zeros(J2, dtype=np.uint8)
                counts[:J] = k_col[jlist]
                jl_arr = np.zeros(J2, dtype=np.uint16)
                jl_arr[:J] = jl_col[jlist]
                ridx = np.zeros(J2, dtype=jdt)
                ridx[:J] = jlist
                self._acct_up(base_row, counts, jl_arr, ridx)
                classes.append((K, J2))
                class_args.extend((base_row, counts, jl_arr, ridx))
                rows0 = np.full(J2, work.dummy_row, dtype=np.int64)
                rows0[:J] = base_all[jlist]
                entries.append((jlist, None, rows0))
                handled[jlist] = True
            if classes:
                gp, hr, hm, jp = refbase_args
                flat_dev, refbase_dev, dense = _vote.vote_window(
                    seq_dev, qual_dev, score_dev, self._genome_dev(),
                    gp, hr, hm, jp, self._sparse_qtable, *class_args,
                    classes=tuple(classes), L=work.L, hi=o.high_quality,
                    mod=o.moderate_quality, lo=o.low_quality,
                    base_score_req=o.base_score_req, ratio_num=rnum,
                    ratio_den=rden, out_len=self.out_len)
                entries = [(jl_, dense[i], r0)
                           for i, (jl_, _, r0) in enumerate(entries)]
                if _SYNC_STAGES:
                    with _T("vote.device"):
                        jax.block_until_ready(flat_dev)
                try:
                    # start the device->host copy as soon as the program
                    # finishes (async) — the collector's np.asarray then
                    # finds the bytes already landed instead of paying the
                    # full wire latency inside vote.sync
                    flat_dev.copy_to_host_async()
                except (AttributeError, RuntimeError):
                    pass
                pending.append(("wflat", flat_dev, entries))
                wflat_made = True

        if fuse_window and refbase_dev is None and not handled.all():
            # leftover buckets still need refbase rows
            with self.timer.stage("vote.refbase"):
                gp, hr, hm, jp = refbase_args
                refbase_dev = _refbase_combine_fn(L)(
                    self._genome_dev(), gp, hr, hm, jp)

        for kb in np.unique(kb_col[~handled]) if nj else ():
            jlist = np.nonzero(~handled & (kb_col == kb))[0]
            kb = int(kb)
            J = len(jlist)
            J2 = _bucket_rows(max(J, 1)) if self._pad_shapes else J
            rows = np.full((J2, kb), work.dummy_row, dtype=np.int32)
            shifts = np.zeros((J2, kb), dtype=np.int32)
            valid = np.zeros((J2, kb), dtype=bool)
            jl_arr = np.zeros(J2, dtype=np.int32)
            jl_arr[:J] = jl_col[jlist]
            fmask = fs_col[jlist] >= 0
            shifted_jj = []
            for jj in np.nonzero(~fmask)[0]:
                job = jobs[int(jlist[jj])]
                any_shift = False
                for k, rj in enumerate(job.members_reads):
                    rows[jj, k] = work.row_of_one(rj)
                    valid[jj, k] = True
                    if not job.left_read_mode:
                        d = job.len_diffs[k]
                        # collected members are never shorter than the
                        # template (group.cpp:309), so d >= 0
                        shifts[jj, k] = max(d, 0)
                        any_shift = any_shift or d > 0
                if any_shift:
                    shifted_jj.append(int(jj))
            if fmask.any():
                jj_arr = np.nonzero(fmask)[0]
                sel_ji = jlist[jj_arr]
                k_arr = k_col[sel_ji]
                fs_arr = fs_col[sel_ji]
                side_arr = side_col[sel_ji]
                tot = int(k_arr.sum())
                jrep = np.repeat(jj_arr, k_arr)
                krep = np.arange(tot) - np.repeat(
                    np.cumsum(np.append(0, k_arr[:-1])), k_arr)
                srcj = np.repeat(fs_arr, k_arr) + krep
                # np.where evaluates both branches: guard empty flats
                fl = flats[True] if len(flats[True]) else np.zeros(1, dtype=np.int64)
                fr = flats[False] if len(flats[False]) else np.zeros(1, dtype=np.int64)
                lr = np.repeat(side_arr, k_arr)
                vals = np.where(
                    lr, fl[np.clip(srcj, 0, max(len(fl) - 1, 0))],
                    fr[np.clip(srcj, 0, max(len(fr) - 1, 0))])
                rows[jrep, krep] = vals
                valid[jrep, krep] = True

            if refbase_dev is not None:
                ridx = np.zeros(J2, dtype=np.int32)
                ridx[:J] = jlist
                refbase = _gather_one(refbase_dev, ridx)
                self._acct_up(ridx)
            else:
                refbase = np.zeros((J2, work.L), dtype=np.uint8)
                refbase[:J] = refbase_all[jlist]
                self._acct_up(refbase)
            self._acct_up(rows, shifts, valid, jl_arr)

            if device_vote:
                outs, overrides = self._vote_device(
                    kb, rows, shifts, valid, jl_arr, refbase, shifted_jj,
                    work, batch, seq_dev, qual_dev, score_dev, rnum, rden,
                    force_dense=wflat_made)
                if _SYNC_STAGES:
                    with _T("vote.device"):
                        jax.block_until_ready(outs.dev_out)
                pending.append((jlist, outs, overrides))
            else:
                outs = kernels.fused_vote_kernel(
                    seq_dev, qual_dev, score_dev, rows, shifts, valid, jl_arr,
                    refbase, hi=o.high_quality, mod=o.moderate_quality,
                    lo=o.low_quality, base_score_req=o.base_score_req,
                    ratio_num=rnum, ratio_den=rden, full_bins=full_bins)
                pending.append((jlist, list(outs), None))

        return pending

    def _vote_qual_table(self):
        """Candidate nibble table for vote-output quals, or None.

        Out-qual values are selections of the (scoring-mutated) input
        quals: {0} ∪ inputs ∪ positive pairwise differences (the mismatch
        mutation qual := max(0, this−pair), pair.cpp:155-167). When that
        closure fits 15 codes, qual downloads ship as nibble indices —
        half the bytes. A device-side
        mismatch count guards the assumption (fallback: raw download)."""
        import os
        if os.environ.get("GENCORE_NO_QPACK"):
            return None
        work = getattr(self, "work", None)
        if work is None or work.qual_table is None:
            return None
        from gencore_tpu.io import native
        if native.get_lib() is None:
            return None
        v = np.unique(work.qtable16[work.qtable16 > 0])
        d = (v[:, None].astype(np.int64) - v[None, :].astype(np.int64)).ravel()
        cand = np.unique(np.concatenate(
            [[0], v.astype(np.int64), d[d > 0]])).astype(np.uint8)
        if len(cand) > 15:
            return None
        qtable = np.zeros(16, dtype=np.uint8)
        qtable[1:1 + len(cand)] = cand
        return qtable

    def _vote_collect(self, jobs: list, pending: list):
        """Collection phase: all bucket dispatches are in flight (async jax
        dispatch). Delta outputs from every bucket are concatenated on
        device and downloaded in ONE transfer per array, then XOR-undone
        vectorized."""
        from gencore_tpu.io import native
        _T = self.timer.stage
        wflat = [p for p in pending
                 if isinstance(p[0], str) and p[0] == "wflat"]
        rest = [p for p in pending if not isinstance(p[0], str)]
        packed = [(jlist, outs, ov) for jlist, outs, ov in rest
                  if isinstance(outs, _PackedOut)]
        plains = [(jlist, outs, ov) for jlist, outs, ov in rest
                  if not isinstance(outs, _PackedOut)]
        sparse = bool(packed) and packed[0][1].enc is not None
        qtable = (self._vote_qual_table()
                  if packed and not sparse else None)
        if getattr(self, "_warm_only", False):
            import jax as _jx
            for _, flat_dev, _e in wflat:
                _jx.block_until_ready(flat_dev)
            if sparse:
                flat = []
                for _, outs, _ in packed:
                    flat.extend(outs.enc)
                _jx.block_until_ready(_concat_sparse_fn(len(packed))(*flat))
            elif packed:
                flat = []
                for _, outs, _ in packed:
                    flat.extend(outs.dev_out)
                if qtable is not None:
                    _jx.block_until_ready(
                        _concat_outs_packed_fn(len(packed))(qtable, *flat))
                else:
                    _jx.block_until_ready(_concat_outs_fn(len(packed))(*flat))
            for _, outs, _ in plains:
                _jx.block_until_ready(outs)
            return
        jobs.alloc_results()
        for _, flat_dev, entries in wflat:
            with _T("vote.sync"):
                fb = np.asarray(flat_dev)
                self.wire_d2h += fb.nbytes
                ds, dq, df, mc = self._sparse_parse(fb, entries)
            buf = jobs.add_buffer(ds, dq)
            off = 0
            for jl_, _dense, rows0 in entries:
                j2 = len(rows0)
                jl = np.asarray(jl_)
                m = len(jl)
                jobs.diff[jl] = df[off:off + m]
                jobs.minc[jl] = mc[off:off + m]
                jobs.set_rows(jl, buf, off + np.arange(m, dtype=np.int32))
                off += j2
        if sparse:
            with _T("vote.sync"):
                ds, dq, df, mc = self._sparse_collect(packed)
            buf = jobs.add_buffer(ds, dq)
            off = 0
            for jlist, outs, ov in packed:
                j2 = outs.enc[2].shape[0]
                jl = np.asarray(jlist)
                m = len(jl)
                jobs.diff[jl] = df[off:off + m]
                jobs.minc[jl] = mc[off:off + m]
                jobs.set_rows(jl, buf, off + np.arange(m, dtype=np.int32))
                if ov is not None:
                    for jj, (pse, q, dd, mi) in ov.items():
                        jobs.set_override(jl[jj],
                                          _unpack_nibbles(pse[None])[0],
                                          np.array(q), dd, mi)
                off += j2
            for jlist, outs, _ in plains:
                with _T("vote.sync"):
                    new_seq, new_qual = np.array(outs[0]), np.array(outs[1])
                    diff, minc = np.asarray(outs[2]), np.asarray(outs[3])
                jl = np.asarray(jlist)
                m = len(jl)
                pbuf = jobs.add_buffer(new_seq, new_qual)
                jobs.diff[jl] = diff[:m]
                jobs.minc[jl] = minc[:m]
                jobs.set_rows(jl, pbuf, np.arange(m, dtype=np.int32))
            return
        if packed:
            with _T("vote.sync"):
                flat = []
                for _, outs, _ in packed:
                    flat.extend(outs.dev_out)
                dq = None
                if qtable is not None:
                    flat_d, dq_d = \
                        _concat_outs_packed_fn(len(packed))(qtable, *flat)
                    # ONE device->host transfer for the whole window
                    fb = np.asarray(flat_d)
                    self.wire_d2h += fb.nbytes
                    J2 = sum(outs.dev_out[0].shape[0] for _, outs, _ in packed)
                    pw = packed[0][1].dev_out[0].shape[1]
                    o1 = J2 * pw          # ps
                    o2 = o1 + J2 * pw     # qp
                    o3 = o2 + J2 * 4      # df
                    o4 = o3 + J2 * 4      # mc
                    ps = fb[:o1].reshape(J2, pw)
                    qn = fb[o1:o2].reshape(J2, pw)
                    df = fb[o2:o3].view(np.int32)
                    mc = fb[o3:o4].view(np.int32)
                    bad = int(fb[o4:o4 + 4].view(np.int32)[0])
                    if bad == 0:
                        # nibble-indexed qual rows (half bytes) + threaded
                        # native unpack; fresh array => writable (duplex
                        # merging mutates rows in place,
                        # postmerge.duplex_merge_bam, cluster.cpp:190-244)
                        dq = native.unpack_nib_dense(qn, qtable)
                    else:  # a value escaped the candidate closure
                        dq = np.array(dq_d)
                else:
                    ps_d, dq_d, df_d, mc_d = _concat_outs_fn(len(packed))(*flat)
                    ps = np.asarray(ps_d)
                    dq = np.array(dq_d)
                    df = np.asarray(df_d)
                    mc = np.asarray(mc_d)
                    self.wire_d2h += (ps.nbytes + dq.nbytes + df.nbytes
                                      + mc.nbytes)
                ds = native.unpack_nib_dense(ps, _IDENT16)
                if ds is None:
                    ds = _unpack_nibbles(ps)
            buf = jobs.add_buffer(ds, dq)
            off = 0
            for jlist, outs, ov in packed:
                j2 = outs.dev_out[0].shape[0]
                jl = np.asarray(jlist)
                m = len(jl)
                jobs.diff[jl] = df[off:off + m]
                jobs.minc[jl] = mc[off:off + m]
                jobs.set_rows(jl, buf, off + np.arange(m, dtype=np.int32))
                if ov is not None:
                    for jj, (pse, q, dd, mi) in ov.items():
                        jobs.set_override(jl[jj],
                                          _unpack_nibbles(pse[None])[0],
                                          np.array(q), dd, mi)
                off += j2
        for jlist, outs, _ in plains:
            with _T("vote.sync"):
                new_seq, new_qual = np.array(outs[0]), np.array(outs[1])
                diff, minc = np.asarray(outs[2]), np.asarray(outs[3])
            jl = np.asarray(jlist)
            m = len(jl)
            pbuf = jobs.add_buffer(new_seq, new_qual)
            jobs.diff[jl] = diff[:m]
            jobs.minc[jl] = minc[:m]
            jobs.set_rows(jl, pbuf, np.arange(m, dtype=np.int32))

    def _sparse_collect(self, packed):
        """Legacy per-bucket sparse path: concat the buckets' encodings on
        device, download once, parse."""
        flat = []
        for _, outs, _ in packed:
            flat.extend(outs.enc)
        fb = np.asarray(_concat_sparse_fn(len(packed))(*flat))
        self.wire_d2h += fb.nbytes
        entries = [(jlist, (outs.dev_out[0], outs.dev_out[1]), outs.rows0)
                   for jlist, outs, _ in packed]
        return self._sparse_parse(fb, entries)

    def _sparse_parse(self, fb, entries):
        """Decode the sparse wire encoding for one window's downloaded
        flat buffer: consensus seq = the template row (host already has it
        in work.seq_packed) patched with <=C downloaded edits; qual rows
        expand from <=R run-length pairs (values via the nibble table when
        active). Jobs whose true edit/run counts exceed the caps — or a
        whole bucket whose qual values escaped the table — are pulled
        densely (rare). entries: [(jlist, (pseq_dev, qual_dev), rows0)].

        Returns (ds, dq, df, mc) shaped like the dense path's outputs."""
        from gencore_tpu.core.vote import SPARSE_DIFFS as C
        from gencore_tpu.core.vote import SPARSE_RUNS as R
        from gencore_tpu.io import native
        J2s = [len(rows0) for _, _, rows0 in entries]
        Jt = sum(J2s)
        nb = len(entries)
        ol = self.out_len
        qtab = getattr(self, "_sparse_qtable", None)
        o = 0
        if qtab is not None:
            qvp = fb[o:o + Jt * (R // 2)].reshape(Jt, R // 2)
            o += Jt * (R // 2)
            qidx = np.empty((Jt, R), dtype=np.uint8)
            qidx[:, 0::2] = qvp >> 4
            qidx[:, 1::2] = qvp & 0xF
            qv = qtab[qidx]
        else:
            qv = fb[o:o + Jt * R].reshape(Jt, R); o += Jt * R
        qs = fb[o:o + Jt * R].reshape(Jt, R).astype(np.int32); o += Jt * R
        nr = fb[o:o + Jt].astype(np.int32); o += Jt
        sp = fb[o:o + Jt * C].reshape(Jt, C).astype(np.int64); o += Jt * C
        sbp = fb[o:o + Jt * (C // 2)].reshape(Jt, C // 2); o += Jt * (C // 2)
        sb = np.empty((Jt, C), dtype=np.uint8)
        sb[:, 0::2] = sbp >> 4
        sb[:, 1::2] = sbp & 0xF
        nd = fb[o:o + Jt].astype(np.int32); o += Jt
        df = fb[o:o + 2 * Jt].view(np.int16).astype(np.int64); o += 2 * Jt
        mc = fb[o:o + 2 * Jt].view(np.int16).astype(np.int64); o += 2 * Jt
        bads = fb[o:o + 4 * nb].view(np.int32)

        real = np.zeros(Jt, dtype=bool)
        rows0 = np.zeros(Jt, dtype=np.int64)
        off = 0
        for (jlist, _dense, r0), j2 in zip(entries, J2s):
            real[off:off + len(jlist)] = True
            rows0[off:off + j2] = r0
            off += j2
        ov = real & ((nr > R) | (nd > C))
        if qtab is not None and bads.any():
            # a qual value escaped the nibble table: dense-pull the
            # affected bucket(s) wholesale (rare)
            off = 0
            for bi, j2 in enumerate(J2s):
                if bads[bi]:
                    ov[off:off + j2] |= real[off:off + j2]
                off += j2

        # ---- qual: run-length expansion (overflow/pad rows expand as a
        # single zero run and are overwritten below)
        nr_c = np.minimum(nr, R)
        force = ov | ~real
        nr_c[force] = 1
        qs[force, 0] = 0
        ar = np.arange(R)
        vrun = ar[None, :] < nr_c[:, None]
        last = ar[None, :] == (nr_c - 1)[:, None]
        ends = np.concatenate([qs[:, 1:], np.full((Jt, 1), ol, np.int32)],
                              axis=1)
        ends = np.where(last, np.int32(ol), ends)
        lens = np.where(vrun, ends - qs, 0)
        dq = np.repeat(qv[vrun], lens[vrun].clip(0)).reshape(Jt, ol)

        # ---- seq: template rows (host copy) + downloaded edits
        tpk = self.work.seq_packed[rows0]
        ds = native.unpack_nib_dense(tpk, _IDENT16)
        if ds is None:
            ds = _unpack_nibbles(tpk)
        nd_c = np.minimum(nd, C)
        nd_c[force] = 0
        vedit = np.arange(C)[None, :] < nd_c[:, None]
        jj, cc = np.nonzero(vedit)
        ds[jj, sp[jj, cc]] = sb[jj, cc]

        # ---- overflow fallback: dense rows per affected bucket
        if ov.any():
            off = 0
            for (jlist, dense_outs, _r0), j2 in zip(entries, J2s):
                sel = np.nonzero(ov[off:off + j2])[0]
                if len(sel):
                    n2 = _bucket_rows(len(sel))
                    idxp = np.zeros(n2, dtype=np.int32)
                    idxp[:len(sel)] = sel
                    pseq_d, qual_d = dense_outs[0], dense_outs[1]
                    pw = pseq_d.shape[1]
                    buf = np.asarray(_pull_dense_fn()(pseq_d, qual_d, idxp))
                    self.wire_d2h += buf.nbytes
                    pr = buf[:n2 * pw].reshape(n2, pw)[:len(sel)]
                    qr = buf[n2 * pw:].reshape(n2, ol)[:len(sel)]
                    drows = native.unpack_nib_dense(pr, _IDENT16)
                    if drows is None:
                        drows = _unpack_nibbles(pr)
                    ds[off + sel] = drows
                    dq[off + sel] = qr
                off += j2
        return ds, dq, df, mc

    def _vote_device(self, kb, rows, shifts, valid, jl_arr, refbase,
                     shifted_jj, work, batch, seq_dev, qual_dev, score_dev,
                     rnum, rden, force_dense=False):
        """One bucket through the [K, J, L] vote (core/vote.py): device
        row-gather + vote; the rare lenDiff-shifted jobs (right-mode
        mixed-length members, group.cpp:339-349) are re-gathered host-side
        with shifts applied and voted in a second small call whose results
        override the main bucket's rows at collection time. refbase may be
        a device array (genome-gathered rows, see _refbase_device).

        Returns (_PackedOut, overrides) — overrides maps bucket-local job
        index -> (packed_seq_row, qual_row, diff, minc)."""
        from gencore_tpu.core import vote
        o = self.opt
        kw = dict(hi=o.high_quality, mod=o.moderate_quality, lo=o.low_quality,
                  base_score_req=o.base_score_req, ratio_num=rnum,
                  ratio_den=rden)
        row0 = np.ascontiguousarray(rows[:, 0])
        # leftover buckets of a fused window ship dense: the window's wire
        # buffer is already one flat sparse download, and the collect path
        # keeps sparse/dense groups separate
        sparse = bool(getattr(self, "_sparse_dl", False)) and not force_dense
        res = vote.vote_gathered(
            seq_dev, qual_dev, score_dev, np.ascontiguousarray(rows.T),
            valid.T, jl_arr, refbase, getattr(self, "_sparse_qtable", None),
            out_len=self.out_len, sparse=sparse, **kw)
        if sparse:
            out = _PackedOut(list(res[:4]), enc=res[4], rows0=row0.copy())
        else:
            out = _PackedOut(list(res))
        overrides = None
        if shifted_jj:
            # host re-gather with shifts for the affected jobs only
            sj = np.asarray(shifted_jj)
            n_s = len(sj)
            S2 = _bucket_rows(n_s) if self._pad_shapes else n_s
            L = work.L
            w = work.w_host
            hseq = np.full((kb, S2, L), vote.SENTINEL, dtype=np.uint8)
            hqual = np.zeros((kb, S2, L), dtype=np.uint8)
            hscore = np.zeros((kb, S2, L), dtype=np.int8)
            hvalid = np.zeros((kb, S2), dtype=bool)
            need_rows = np.unique(rows[sj].ravel())
            real = need_rows[need_rows != work.dummy_row]
            qual_rows, score_rows = _pull_rows(qual_dev, score_dev, need_rows)
            seq_rows = np.zeros((len(need_rows), w), dtype=np.uint8)
            if len(real):
                rmap = {int(r): i for i, r in enumerate(need_rows)}
                got = batch.seq_matrix(work.cidx[real], w)
                for k2, r in enumerate(real):
                    seq_rows[rmap[int(r)]] = got[k2]
            qmap = {int(r): i for i, r in enumerate(need_rows)}
            for si, jj in enumerate(sj):
                for k in range(kb):
                    if not valid[jj, k]:
                        continue
                    r = int(rows[jj, k])
                    d = int(shifts[jj, k])
                    qrow = qual_rows[qmap[r]]
                    srow = score_rows[qmap[r]]
                    seqrow = seq_rows[qmap[r]]
                    hseq[k, si, :w - d] = seqrow[d:]
                    hseq[k, si, w - d:] = 0
                    hqual[k, si, :L - d] = qrow[d:]
                    hscore[k, si, :L - d] = srow[d:]
                    hvalid[k, si] = True
            if isinstance(refbase, np.ndarray):
                rb_sj = np.pad(refbase[sj], ((0, S2 - n_s), (0, 0)))
            else:  # device refbase: pull the few shifted rows to host
                sj_pad = np.zeros(S2, dtype=np.int32)
                sj_pad[:n_s] = sj
                # np.asarray on a jax array is a read-only view; copy
                # before zeroing the pad rows.
                rb_sj = np.array(_gather_one(refbase, sj_pad))
                rb_sj[n_s:] = 0
            sout = vote.vote(
                hseq, hqual, hscore, hvalid,
                np.pad(jl_arr[sj], (0, S2 - n_s)), rb_sj,
                out_len=self.out_len, **kw)
            sout = [np.asarray(x) for x in sout]
            overrides = {int(jj): (sout[0][si], sout[1][si],
                                   int(sout[2][si]), int(sout[3][si]))
                         for si, jj in enumerate(sj)}
        return out, overrides

    # ------------------------------------------------------------------
    def _assemble_all(self, nclusters, G, g_cluster, g_sizes, g_start,
                      g_single, g_cross, side_jobs, jobs,
                      batch, pl, pr, work, pair_has_umi, c_pair_start,
                      mem_pairs, u_mat, u_start, u_len, out_records):
        """Columnar cluster tail: duplex eligibility, supporting-read
        thresholds, SSCS tagging, qname reconciliation, NM patching, stats
        and record emission for ALL clusters at once (reference
        cluster.cpp:102-188, pair.cpp:43-68, group.cpp:94-131).

        Order-sensitive clusters — >=2 groups under duplex pairing (the
        back-pop duplex scan, cluster.cpp:119-155) or any cross-contig
        group (qname min-scan, group.cpp:94-113) — take the scalar OPair
        path per cluster; everything else is batched numpy."""
        opt = self.opt
        pre, post = self.pre_stats, self.post_stats
        if G == 0:
            return
        umi_cache: dict = {}

        def pair_umi_str(pi):
            v = umi_cache.get(pi)
            if v is None:
                v = umivec.umi_string(u_mat, u_start, u_len, pi)
                umi_cache[pi] = v
            return v

        # cluster geometry over the (cluster-sorted) group axis
        cg_start = np.searchsorted(g_cluster, np.arange(nclusters))
        n_groups = np.append(cg_start[1:], G) - cg_start
        has_umi_cl = np.logical_or.reduceat(pair_has_umi, c_pair_start)
        eligible = has_umi_cl & (not opt.disable_duplex)
        cross_cl = np.logical_or.reduceat(g_cross, cg_start)
        # multi-group duplex clusters run the columnar back-pop duplex
        # pass below (cluster.cpp:119-155); only cross-contig clusters and
        # MI-tagged inputs keep the scalar OPair path
        mi_mode = self._mi_has_rank is not None
        if mi_mode:
            scalar_cl = (eligible & (n_groups >= 2)) | cross_cl
            dup_cl = np.zeros(nclusters, dtype=bool)
        else:
            scalar_cl = cross_cl
            dup_cl = eligible & (n_groups >= 2) & ~cross_cl
        vec_g = ~scalar_cl[g_cluster]
        dup_g = dup_cl[g_cluster]

        # per-group columns
        lj = side_jobs[True]
        rj = side_jobs[False]
        njobs = len(jobs)
        if njobs == 0:  # all groups single / elections abandoned
            job_tr = np.full(1, -1, dtype=np.int64)
            job_minc = np.zeros(1, dtype=np.int64)
        else:
            job_tr = jobs.col("tmpl_read")
            job_minc = jobs.minc
        single = g_single
        first_pair = mem_pairs[g_start[:-1]]
        l_ex = np.where(single, True, lj >= 0)
        r_ex = np.where(single, False, rj >= 0)
        pe = l_ex & r_ex
        merge_reads = g_sizes
        emitted = (not opt.duplex_only) & (merge_reads >= opt.cluster_size_req)

        # ---- qname reconciliation + NM for non-single vector groups ----
        ljc = np.clip(lj, 0, None)
        rjc = np.clip(rj, 0, None)
        tr_l = np.where(lj >= 0, job_tr[ljc], -1)
        tr_r = np.where(rj >= 0, job_tr[rjc], -1)
        qlen = batch.l_read_name.astype(np.int64)  # includes NUL
        pql_l = ((qlen[np.clip(tr_l, 0, None)] + 3) // 4) * 4
        pql_r = ((qlen[np.clip(tr_r, 0, None)] + 3) // 4) * 4
        both = (lj >= 0) & (rj >= 0) & ~single
        use_left = pql_l <= pql_r
        qrec_l = tr_l.copy()
        qrec_r = tr_r.copy()
        m = both & use_left
        qrec_r[m] = tr_l[m]
        m = both & ~use_left
        qrec_l[m] = tr_r[m]

        def _nm_side(jarr, trarr):
            mc = np.where(jarr >= 0, job_minc[np.clip(jarr, 0, None)], 0)
            trc = np.clip(trarr, 0, None)
            newnm = np.where(trarr >= 0, self._nm_vals[trc], 0) + mc
            ok = ((jarr >= 0) & (mc != 0) & (mc <= 5)
                  & (self._nm_patch[trc] >= 0) & (newnm >= 0) & (newnm <= 255))
            return np.where(ok, newnm, -1)

        nm_l = _nm_side(lj, tr_l)
        nm_r = _nm_side(rj, tr_r)
        fr_val = np.minimum(merge_reads, 65535) & 0xFF

        # ---- columnar duplex pass (cluster.cpp:119-155) ----
        # Exact int-id simulation of the reference's back-pop matching
        # loop over canonical 2-part UMI identities; survivor emission
        # order, FR/RR tags, base masking (duplexMerge, cluster.cpp:
        # 199-244) and stats all come out of the simulation. Per-event
        # cost is O(1) amortized — no per-group OPair objects.
        lq = batch.l_qseq
        jbuf = jobs._buf if njobs and jobs._buf is not None \
            else np.zeros(1, dtype=np.int32)
        jrow = jobs._row if njobs and jobs._row is not None \
            else np.zeros(1, dtype=np.int32)
        seqbufs = jobs._seqbufs if njobs else []
        rr_val = np.full(G, -1, dtype=np.int64)
        dup_ovr: dict = {}     # group gi -> masked (seq, qual) overrides
        emit_rank = None       # within-cluster emission order (dup only)
        if dup_cl.any():
            tpj = (jobs.col("tmpl_pair") if njobs
                   else np.zeros(1, dtype=np.int64))
            # umi source pair per group (group.cpp:124-131): single groups
            # use their only pair; merged groups the reconciled side's
            # template pair
            src_pair = np.where(single, first_pair, -1)
            nsg = ~single
            lonly = nsg & (lj >= 0) & (rj < 0)
            ronly = nsg & (rj >= 0) & (lj < 0)
            src_pair[lonly] = tpj[lj[lonly]]
            src_pair[ronly] = tpj[rj[ronly]]
            bsel = nsg & both
            src_pair[bsel] = np.where(use_left[bsel], tpj[ljc[bsel]],
                                      tpj[rjc[bsel]])
            # canonical duplex identity: exactly-two-part '_' split;
            # partner = reversed parts (cluster.cpp:246-258)
            from gencore_tpu.utils.umi import _split_nonempty
            key_id = np.full(G, -1, dtype=np.int64)
            partner_id = np.full(G, -1, dtype=np.int64)
            interned: dict = {}
            for g in np.nonzero(dup_g)[0]:
                sp = int(src_pair[g])
                if sp < 0:
                    continue
                parts = _split_nonempty(
                    umivec.umi_string(u_mat, u_start, u_len, sp), "_")
                if len(parts) != 2:
                    continue
                a, b = parts
                key_id[g] = interned.setdefault((a, b), len(interned))
                partner_id[g] = interned.setdefault((b, a), len(interned))

            def side_view(g, left):
                """('raw', rec) | ('job', j) | None for a group's side."""
                if single[g]:
                    return ("raw", int(pl[first_pair[g]])) if left else None
                j = int(lj[g] if left else rj[g])
                return ("job", j) if j >= 0 else None

            def rows_of(h):
                kind, v = h
                if kind == "raw":
                    return batch.seq_codes(v), np.asarray(batch.qual(v))
                n = int(lq[job_tr[v]])
                bi = int(jbuf[v])
                if bi >= 0:
                    sb, qb = seqbufs[bi]
                    return sb[int(jrow[v])][:n], qb[int(jrow[v])][:n]
                return jobs.new_seq(v)[:n], jobs.new_qual(v)[:n]

            def mask_side(g, h, mism):
                if h[0] == "job":
                    s, q = rows_of(h)
                    s[mism] = 15
                    q[mism] = 0
                else:
                    o = dup_ovr.get(g)
                    if o is None:
                        s, q = rows_of(h)
                        o = (np.asarray(s).copy(), np.asarray(q).copy())
                        dup_ovr[g] = o
                    o[0][mism] = 15
                    o[1][mism] = 0

            emit_rank = np.zeros(G, dtype=np.int64)
            thr_d = opt.duplex_mismatch_threshold
            req = opt.cluster_size_req
            dup_only = opt.duplex_only
            for ci in np.nonzero(dup_cl)[0]:
                g0 = int(cg_start[ci])
                gn = int(n_groups[ci])
                occ: dict = {}
                for p in range(gn):
                    k = int(key_id[g0 + p])
                    if k >= 0:
                        occ.setdefault(k, []).append(p)
                ptr = {k: 0 for k in occ}
                alive = [True] * gn
                nalive = gn
                rank = 0
                top = gn - 1
                while nalive > 0:
                    while not alive[top]:
                        top -= 1
                    p1 = top
                    alive[p1] = False
                    nalive -= 1
                    g1 = g0 + p1
                    p2 = -1
                    if key_id[g1] >= 0:
                        lst = occ.get(int(partner_id[g1]))
                        if lst is not None:
                            i = ptr[int(partner_id[g1])]
                            while i < len(lst) and not alive[lst[i]]:
                                i += 1
                            ptr[int(partner_id[g1])] = i
                            if i < len(lst):
                                p2 = lst[i]
                    if p2 >= 0:
                        g2 = g0 + p2
                        alive[p2] = False
                        nalive -= 1
                        mr1 = int(merge_reads[g1])
                        mr2 = int(merge_reads[g2])
                        pre.add_molecule(mr1 + mr2, bool(pe[g1]))
                        d = 0
                        masks = []
                        for left in (True, False):
                            h1 = side_view(g1, left)
                            h2 = side_view(g2, left)
                            if h1 is None or h2 is None:
                                continue
                            s1, _ = rows_of(h1)
                            s2, _ = rows_of(h2)
                            dd, mism = duplex_merge_rows(s1, s2)
                            d += dd
                            if len(mism):
                                masks.append((h1, mism))
                        if d <= thr_d and mr1 + mr2 >= req:
                            for h1, mism in masks:
                                mask_side(g1, h1, mism)
                            rr_val[g1] = min(mr2, 65535) & 0xFF
                            post.add_dcs()
                            emitted[g1] = True
                            emit_rank[g1] = rank
                            rank += 1
                        else:
                            emitted[g1] = False
                        emitted[g2] = False
                    else:
                        mr1 = int(merge_reads[g1])
                        pre.add_molecule(mr1, bool(pe[g1]))
                        if not dup_only and mr1 >= req:
                            post.add_sscs()
                            emitted[g1] = True
                            emit_rank[g1] = rank
                            rank += 1
                        else:
                            emitted[g1] = False

        # ---- vectorized stats for vector clusters/groups ----
        # (duplex-cluster molecule/sscs/dcs counts came out of the
        # simulation above; cluster counts and post-molecule accounting
        # stay columnar)
        vec_cl = ~scalar_cl
        pre.cluster += int(vec_cl.sum())
        pre.multi_molecule_cluster += int((n_groups[vec_cl] > 1).sum())
        vsel = np.nonzero(vec_g & ~dup_g)[0]
        mr_v = merge_reads[vsel]
        small = mr_v < MAX_SUPPORTING_READS
        pre.molecule += len(vsel)
        if len(vsel):
            hist = np.bincount(mr_v[small], minlength=MAX_SUPPORTING_READS)
            pre.supporting_histogram += hist[:MAX_SUPPORTING_READS]
        pre.uncounted_supporting_reads += int((~small).sum())
        pe_v = pe[vsel]
        pre.molecule_pe += int(pe_v.sum())
        pre.molecule_se += int((~pe_v).sum())
        post.sscs_num += int(emitted[vsel].sum())
        esel = np.nonzero(vec_g & emitted)[0]
        emc = np.add.reduceat((vec_g & emitted).astype(np.int64), cg_start)
        post.cluster += int(((emc > 0) & vec_cl).sum())
        post.multi_molecule_cluster += int(((emc > 1) & vec_cl).sum())
        post.molecule += len(esel)
        post.supporting_histogram[1] += len(esel)
        pee = pe[esel]
        post.molecule_pe += int(pee.sum())
        post.molecule_se += int((~pee).sum())

        # ---- scalar clusters (rare): exact OPair path ----
        scalar_results = {}
        for ci in np.nonzero(scalar_cl)[0]:
            pre.add_cluster(bool(n_groups[ci] > 1))
            singles = [self._assemble_group(
                gi, mem_pairs[g_start[gi]:g_start[gi + 1]],
                bool(g_single[gi]), bool(g_cross[gi]),
                side_jobs, jobs, batch, pl, pr, work, pair_umi_str)
                for gi in range(int(cg_start[ci]),
                                int(cg_start[ci] + n_groups[ci]))]
            scalar_results[int(ci)] = postprocess_cluster(
                singles, bool(has_umi_cl[ci]), opt, pre, post)

        # ---- emission in cluster order ----
        def emit_block(gis):
            """Columnar OutBlock for an ascending run of vector groups:
            per group [single-or-left, right?] in the serial order the
            per-record loop used to produce."""
            sing = single[gis]
            lw = ~sing & (lj[gis] >= 0)
            rw = ~sing & (rj[gis] >= 0)
            first_slot = sing | lw
            cnt = first_slot.astype(np.int64) + rw
            base = np.zeros(len(gis) + 1, dtype=np.int64)
            np.cumsum(cnt, out=base[1:])
            total = int(base[-1])
            rec = np.zeros(total, dtype=np.int64)
            qrec = np.zeros(total, dtype=np.int64)
            nm = np.full(total, -1, dtype=np.int64)
            fr = np.zeros(total, dtype=np.int64)
            rr = np.full(total, -1, dtype=np.int64)
            buf = np.full(total, -1, dtype=np.int64)
            row = np.zeros(total, dtype=np.int64)
            sp = base[:-1][sing]
            srec = pl[first_pair[gis[sing]]]
            rec[sp] = srec
            qrec[sp] = srec
            fr[sp] = fr_val[gis[sing]]
            rr[sp] = rr_val[gis[sing]]
            lp2 = base[:-1][lw]
            jidl = lj[gis[lw]]
            rec[lp2] = job_tr[jidl]
            qrec[lp2] = qrec_l[gis[lw]]
            nm[lp2] = nm_l[gis[lw]]
            fr[lp2] = fr_val[gis[lw]]
            rr[lp2] = rr_val[gis[lw]]
            buf[lp2] = jbuf[jidl]
            row[lp2] = jrow[jidl]
            rp2 = (base[:-1] + first_slot)[rw]
            jidr = rj[gis[rw]]
            rec[rp2] = job_tr[jidr]
            qrec[rp2] = qrec_r[gis[rw]]
            nm[rp2] = nm_r[gis[rw]]
            fr[rp2] = fr_val[gis[rw]]
            rr[rp2] = rr_val[gis[rw]]
            buf[rp2] = jbuf[jidr]
            row[rp2] = jrow[jidr]
            serial = self._serial + 1 + np.arange(total, dtype=np.int64)
            self._serial += total
            blk = OutBlock(rec, qrec, nm, fr, serial, jobs._seqbufs,
                           buf, row, rr_tag=rr)
            # override jobs carry materialized rows instead of buffer refs
            for p2, jid in ((lp2, jidl), (rp2, jidr)):
                for k in np.nonzero(jbuf[jid] < 0)[0]:
                    ji = int(jid[k])
                    pp = int(p2[k])
                    n = int(lq[rec[pp]])
                    blk.ovr[pp] = (jobs.new_seq(ji)[:n],
                                   jobs.new_qual(ji)[:n])
            if dup_ovr:
                # duplex-masked single-group survivors materialize rows
                for k in np.nonzero(sing)[0]:
                    o = dup_ovr.get(int(gis[k]))
                    if o is not None:
                        blk.ovr[int(base[k])] = o
            return blk

        emit_sel = np.nonzero(vec_g & emitted & (l_ex | r_ex))[0]
        if emit_rank is not None and len(emit_sel):
            # duplex clusters emit survivors in back-pop order; plain
            # clusters keep ascending group order (their local index)
            key2 = np.where(dup_g[emit_sel], emit_rank[emit_sel],
                            emit_sel - cg_start[g_cluster[emit_sel]])
            vec_emit = emit_sel[np.lexsort((key2, g_cluster[emit_sel]))]
        else:
            vec_emit = emit_sel
        if not scalar_results:
            if len(vec_emit):
                out_records.append(emit_block(vec_emit))
            return
        # interleave: block runs between scalar clusters, in cluster order
        vec_emit_cl = g_cluster[vec_emit]
        vp = 0
        for ci in sorted(scalar_results):
            hi = int(np.searchsorted(vec_emit_cl, ci))
            if hi > vp:
                out_records.append(emit_block(vec_emit[vp:hi]))
                vp = hi
            for pair in scalar_results[ci]:
                self._emit_pair(pair, out_records)
        if vp < len(vec_emit):
            out_records.append(emit_block(vec_emit[vp:]))

    # ------------------------------------------------------------------
    def _assemble_group(self, gi, pair_ids, is_single, cross_contig,
                        side_jobs, jobs, batch, pl, pr, work, pair_umi_str) -> OPair:
        """Merged OPair for one group (reference group.cpp:68-134)."""
        opt = self.opt

        if is_single:
            pair = OPair(opt)
            pi = int(pair_ids[0])
            pair.left = OutRead(batch, int(pl[pi]))
            pair.umi = pair_umi_str(pi)
            return pair

        lj = int(side_jobs[True][gi])
        rj = int(side_jobs[False][gi])
        left = self._job_output(lj, jobs, batch, work)
        right = self._job_output(rj, jobs, batch, work)

        pair = OPair(opt)
        pair.merge_reads = len(pair_ids)

        # UMI of the merged pair: the reference re-extracts from the merged
        # left (else right) read after qname reconciliation (group.cpp:124-131,
        # pair.cpp:192). PER READ, an MI tag on the template record wins over
        # the (possibly copied) qname (bamutil.cpp:23-38 via oracle get_umi).
        mi_mode = self._mi_has_rank is not None
        umi_src = (jobs[lj].template_pair if lj >= 0
                   else (jobs[rj].template_pair if rj >= 0 else None))
        if cross_contig:
            name_to_copy = None
            cur_len = 0
            cur_read = -1
            cur_pair = None
            for pi in pair_ids:
                li = int(pl[pi])
                if li < 0:
                    continue
                qn = batch.qname(li)
                plen = bamio.padded_qname_len(len(qn))
                if name_to_copy is None or plen < cur_len or \
                        (plen == cur_len and qn < name_to_copy):
                    name_to_copy, cur_len, cur_read, cur_pair = qn, plen, li, int(pi)
            if left is not None and name_to_copy is not None and \
                    cur_read != (jobs[lj].template_read if lj >= 0 else -1):
                left.qname_rec = cur_read
                if not mi_mode:
                    umi_src = cur_pair
        elif left is not None and right is not None:
            if left.padded_l_qname() <= right.padded_l_qname():
                right.qname_rec = left.qname_rec
                if not mi_mode:
                    umi_src = jobs[lj].template_pair
            else:
                left.qname_rec = right.qname_rec
                if not mi_mode:
                    umi_src = jobs[rj].template_pair

        pair.left = left
        pair.right = right
        if lj >= 0:
            pair.merge_left_diff = jobs[lj].diff
        if rj >= 0:
            pair.merge_right_diff = jobs[rj].diff
        if mi_mode:
            ul = self._merged_side_umi(lj, left, jobs)
            ur = self._merged_side_umi(rj, right, jobs)
            pair.umi = ul if ul else (ur or "")
        else:
            pair.umi = pair_umi_str(int(umi_src)) if umi_src is not None else ""
        return pair

    def _umi_rank(self, read_idx: int) -> int:
        return int(np.searchsorted(self._umi_cidx, read_idx))

    def _read_has_mi(self, read_idx: int) -> bool:
        m = self._mi_has_rank
        if m is None:
            return False
        rk = self._umi_rank(read_idx)
        c = self._umi_cidx
        return bool(rk < len(c) and c[rk] == read_idx and m[rk])

    def _merged_side_umi(self, side_job, read_out, jobs):
        """get_umi of one merged side read (oracle get_umi / reference
        pair.cpp:192 + bamutil.cpp:23-38): MI tag of the template record
        when present, else qname parse of the possibly-copied qname."""
        if side_job < 0 or read_out is None:
            return None
        tr = int(jobs[side_job].template_read)
        if self._read_has_mi(tr):
            mat, st, ln = self._umi_read_arrays
            return umivec.umi_string(mat, st, ln, self._umi_rank(tr))
        qmat, qs, ql = self._qname_umi
        return umivec.umi_string(qmat, qs, ql,
                                 self._umi_rank(int(read_out.qname_rec)))

    def _job_output(self, job_id: int, jobs, batch, work):
        if job_id < 0:
            return None
        job = jobs[job_id]
        tr = job.template_read
        n = int(batch.l_qseq[tr])
        # fused kernel outputs are complete final rows (voted prefix +
        # post-overlap-scoring template tail)
        r = OutRead(batch, tr, seq=job.new_seq[:n], qual=job.new_qual[:n])
        if job.minc != 0 and job.minc <= 5:
            new_nm = int(self._nm_vals[tr]) + job.minc
            if self._nm_patch[tr] >= 0 and 0 <= new_nm <= 255:
                r.nm_new = new_nm
        elif job.minc > 5 and self.opt.debug:
            # rollback notice (group.cpp:538-550); the seq/qual restore
            # itself happened in the vote kernel's epilogue. The reference
            # additionally dumps ref/css/member rows — we print the notice
            # core (the restore is already reflected in the output record).
            import sys
            nm0 = int(self._nm_vals[tr])
            print(f"\nNOTICE: mismatch increased with {job.minc}",
                  file=sys.stderr)
            print("Consensus by left" if job.is_left_side
                  else "Consensus by right", file=sys.stderr)
            print(f"Edit distance (NM) changed from {nm0} to "
                  f"{nm0 + job.minc}", file=sys.stderr)
            print(f"Read name: {batch.qname(tr).decode('latin-1')}",
                  file=sys.stderr)
            print(f"tid: {int(batch.tid[tr])}, pos: {int(batch.pos[tr])}",
                  file=sys.stderr)
        return r

    # ------------------------------------------------------------------
    def _finalize(self, out_records: list) -> OutputTable:
        nm_vals = getattr(self, "_nm_vals", np.zeros(self.batchref.n, dtype=np.int64))
        nm_patch = getattr(self, "_nm_patch", np.full(self.batchref.n, -1, dtype=np.int64))
        table = OutputTable(self.batchref, out_records, nm_vals, nm_patch)
        if table.n:
            # Reported post-stats include only records the reference would
            # have written before report(): bamComp keys strictly below the
            # final watermark (writeBam gate, gencore.cpp:133-143; see
            # watermark computation in run()).
            wt, wp = getattr(self, "_watermark", (-1, -1))
            t_, p_, l_, nm_ = table.stats_arrays()
            if wp != -1:
                st = np.where(t_ >= 0, t_, 0x7FFFFFFF)
                mask = (st < wt) | ((st == wt) & (p_ < wp))
                if mask.any():
                    self.post_stats.add_reads_vectorized(
                        t_[mask], p_[mask], l_[mask], nm_[mask])
        return table

    def _emit_raw(self, batch, i: int, out_records: list):
        r = OutRead(batch, i)
        self._serial += 1
        r.serial = self._serial
        out_records.append(r)

    def _emit_pair(self, pair: OPair, out_records: list):
        self.post_stats.add_molecule(1, pair.left is not None and pair.right is not None)
        for r in (pair.left, pair.right):
            if r is not None:
                self._serial += 1
                r.serial = self._serial
                out_records.append(r)

    # ------------------------------------------------------------------
    def _extract_nm(self, batch, limit: int):
        """Vectorized NM extraction: probe the first record's tag layout and
        verify it across records; per-record fallback for mismatches.

        Returns (values int64[n], patch_off int64[n]) where patch_off is the
        payload offset of the writable 1-byte 'C' NM value (-1 if the tag is
        absent or not 'C'-typed; reference patches only then, group.cpp:569).
        """
        n = batch.n
        out = np.zeros(n, dtype=np.int64)
        patch = np.full(n, -1, dtype=np.int64)
        if n == 0:
            return out, patch
        from gencore_tpu.io import native as _natnm
        if batch.data.flags.c_contiguous:
            got = _natnm.nm_extract(batch.data, batch.aux_off, batch.end)
            if got is not None:
                return got
        tag = b"NM"
        off0, typ0 = batch.find_tag(0, tag)
        done = np.zeros(n, dtype=bool)
        if off0 is not None and typ0 in "Cc":
            delta = off0 - int(batch.aux_off[0])
            cand = batch.aux_off + delta
            ok = cand + 1 <= batch.end
            probe = cand - 3
            ok &= (batch.data[np.clip(probe, 0, len(batch.data) - 1)] == tag[0])
            ok &= (batch.data[np.clip(probe + 1, 0, len(batch.data) - 1)] == tag[1])
            ok &= (batch.data[np.clip(probe + 2, 0, len(batch.data) - 1)] == ord(typ0))
            vals = batch.data[np.clip(cand, 0, len(batch.data) - 1)].astype(np.int64)
            if typ0 == "c":
                vals = np.where(vals > 127, vals - 256, vals)
            out[ok] = vals[ok]
            if typ0 == "C":
                patch[ok] = cand[ok]
            done = ok
        for i in np.nonzero(~done)[0]:
            voff, typ = batch.find_tag(int(i), tag)
            if voff is None:
                continue
            out[i] = batch.get_int_tag(int(i), tag, 0)
            if typ == "C":
                patch[i] = voff
        return out, patch

    def _qname_matrix(self, batch, idx: np.ndarray):
        lens = batch.l_read_name[idx].astype(np.int64) - 1
        w = max(int(lens.max()) if len(lens) else 1, 1)
        from gencore_tpu.io import native
        if native.get_lib() is not None and batch.data.flags.c_contiguous:
            m = np.zeros((len(idx), w), dtype=np.uint8)
            native.gather_rows_into(batch.data, batch.qname_off[idx], lens, m)
            return m, w
        cols = np.arange(w, dtype=np.int64)
        g = batch.qname_off[idx][:, None] + cols[None, :]
        np.minimum(g, len(batch.data) - 1, out=g)
        m = batch.data[g].copy()
        m[cols[None, :] >= lens[:, None]] = 0
        return m, w


import functools as _functools


def _pack_score_meta(N, lrow, rrow, ls, rs, cl):
    """u16 mate rows + u32 packed geometry for score_map_kernel_packed:
    my_start 8b | mate_start 8b | cmp_len 9b | is_left 1b | scored 1b.
    cmp_len <= 0 (no overlap) clamps to an empty window with start 0 —
    identical semantics (the window is empty either way). Single source
    of truth for the bit layout (decode: kernels.score_map_kernel_packed)."""
    mate16 = np.arange(N, dtype=np.uint16)
    meta = np.zeros(N, dtype=np.uint32)
    if lrow is not None and len(lrow):
        mate16[lrow] = rrow.astype(np.uint16)
        mate16[rrow] = lrow.astype(np.uint16)
        clc = np.clip(cl, 0, 511).astype(np.uint32)
        empty = clc == 0
        lsc = np.where(empty, 0, np.clip(ls, 0, 255)).astype(np.uint32)
        rsc = np.where(empty, 0, np.clip(rs, 0, 255)).astype(np.uint32)
        mrow = np.concatenate([lrow, rrow])
        mval = np.concatenate([
            lsc | (rsc << 8) | (clc << 16) | (1 << 25) | (1 << 26),
            rsc | (lsc << 8) | (clc << 16) | (1 << 26)])
        meta[mrow] = mval
    return mate16, meta


@_functools.cache
def _upload_fn():
    import jax

    @jax.jit
    def up(a, b):
        return a, b

    return up


@_functools.cache
def _upload_unpack_fn(w_host: int, L: int, qual_mode: str, seq_mode: str):
    """Upload path: packed seq + packed/indexed quals go over the wire; the
    chip unpacks, decodes, masks beyond each read length, and zero-pads to
    the kernel width L. seq_mode: '2bit' (pure ACGT data — code = 1<<idx)
    or '4bit' (BAM nibbles). qual_mode: '2bit' (<=3 distinct values),
    '4bit' (<=15), or 'raw'. 2-bit modes ship 4 bases/byte — 6x fewer
    bytes than dense u8 matrices. Whether the packing pays on a local
    card is an open measurement (ROADMAP Design 2)."""
    import jax
    import jax.numpy as jnp

    def un2(packed, n):
        cols = [(packed >> 6) & 3, (packed >> 4) & 3,
                (packed >> 2) & 3, packed & 3]
        return jnp.stack(cols, axis=-1).reshape(n, -1)[:, :w_host]

    def un4(packed, n):
        return jnp.stack([packed >> 4, packed & 0xF],
                         axis=-1).reshape(n, -1)[:, :w_host]

    @jax.jit
    def up(seq_up, qual_up, lens, qtable):
        n = seq_up.shape[0]
        if seq_mode == "2bit":
            seq = (jnp.uint8(1) << un2(seq_up, n))
        else:
            seq = un4(seq_up, n)
        j = jnp.arange(w_host, dtype=jnp.int32)[None, :]
        keep = j < lens[:, None]
        seq = jnp.where(keep, seq, 0)
        if qual_mode == "2bit":
            qidx = un2(qual_up, n)
            qual = jnp.zeros_like(qidx)
            for i in range(1, 4):
                qual = jnp.where(qidx == i, qtable[i], qual)
        elif qual_mode == "4bit":
            qidx = un4(qual_up, n)
            qual = jnp.zeros_like(qidx)
            for i in range(1, 16):
                qual = jnp.where(qidx == i, qtable[i], qual)
        else:
            qual = qual_up
        qual = jnp.where(keep, qual, 0)
        if L > w_host:
            seq = jnp.pad(seq, ((0, 0), (0, L - w_host)))
            qual = jnp.pad(qual, ((0, 0), (0, L - w_host)))
        return seq, qual, lens

    return up


_SPARSE_SEQ_CAP = 12   # per-row seq edits before the row ships dense
_SPARSE_QUAL_CAP = 12  # per-row qual edits before the row ships raw


def _upload_sparse_trace(w: int, L: int, mode2: bool, has_sedit: bool,
                         has_qdense: bool, has_qedit: bool,
                         const_lens: bool, has_genome: bool = False):
    """Traceable core of the duplicate-aware upload reconstruction (see
    _upload_sparse_fn); shared by the standalone upload jit and the fused
    upload+score program. With has_genome, extra genome-slot rows are
    appended to the dense table: slot t holds the NT16 genome slice at
    gsl[t] (vmapped dynamic_slice from the HBM-resident genome), and
    genome-sourced rows land their ref-diff edits through the normal
    per-row edit stream — no dense head rows ship for those segments."""
    import jax
    import jax.numpy as jnp

    def un2(packed, n):
        cols = [(packed >> 6) & 3, (packed >> 4) & 3,
                (packed >> 2) & 3, packed & 3]
        return jnp.stack(cols, axis=-1).reshape(n, -1)[:, :w]

    def un4(packed, n):
        return jnp.stack([packed >> 4, packed & 0xF],
                         axis=-1).reshape(n, -1)[:, :w]

    def _apply_edits(mat, cnts, pos_flat, val_flat, cap, j):
        off = jnp.concatenate([
            jnp.zeros(1, jnp.int32),
            jnp.cumsum(cnts.astype(jnp.int32))[:-1]])
        Ef = pos_flat.shape[0]
        cnt = cnts.astype(jnp.int32)
        for c in range(cap):
            idx = jnp.clip(off + c, 0, Ef - 1)
            p = pos_flat[idx].astype(jnp.int32)
            v = val_flat[idx]
            m = (c < cnt)[:, None] & (j == p[:, None])
            mat = jnp.where(m, v[:, None], mat)
        return mat

    def up(sd, src, scnt, epos, ecode, base, q_src, qd, qcnt, qpos, qval,
           lens16, genome, gsl):
        n = src.shape[0]
        nd = sd.shape[0]
        if mode2:
            dense = (jnp.uint8(1) << un2(sd, nd))
            # row 0 is the reserved zero row; 2-bit 0 decodes to code 1
            dense = jnp.where((jnp.arange(nd) == 0)[:, None],
                              jnp.uint8(0), dense)
        else:
            dense = un4(sd, nd)
        if has_genome:
            gv = jax.vmap(
                lambda st: jax.lax.dynamic_slice(genome, (st,), (w,)))(gsl)
            dense = jnp.concatenate([dense, gv], axis=0)
        seq = dense[src.astype(jnp.int32)]
        j = jnp.arange(w, dtype=jnp.int32)[None, :]
        if has_sedit:
            seq = _apply_edits(seq, scnt, epos, ecode, _SPARSE_SEQ_CAP, j)
        if const_lens:
            ri = jnp.arange(n, dtype=jnp.int32)
            lens = jnp.where(ri < lens16[1], lens16[0], 0)
        else:
            lens = lens16.astype(jnp.int32)
        keep = j < lens[:, None]
        seq = jnp.where(keep, seq, 0)
        qual = jnp.broadcast_to(base[:, None], (n, w))
        if has_qdense:
            nq = qd.shape[0]
            qsel = q_src.astype(jnp.int32)
            qrows = qd[jnp.clip(qsel - 1, 0, nq - 1)]
            qual = jnp.where((qsel > 0)[:, None], qrows, qual)
        if has_qedit:
            qual = _apply_edits(qual, qcnt, qpos, qval, _SPARSE_QUAL_CAP, j)
        qual = jnp.where(keep, qual, 0)
        if L > w:
            seq = jnp.pad(seq, ((0, 0), (0, L - w)))
            qual = jnp.pad(qual, ((0, 0), (0, L - w)))
        return seq, qual, lens

    return up


@_functools.cache
def _upload_sparse_fn(w: int, L: int, mode2: bool, has_sedit: bool,
                      has_qdense: bool, has_qedit: bool,
                      const_lens: bool = False, has_genome: bool = False):
    """Duplicate-aware upload reconstruction: the wire carries one dense
    row per (group, side) segment (2-bit packed when pure ACGT) plus flat
    per-member (pos, code) seq edits and per-row qual base values with
    (pos, val) edits; the chip rebuilds the dense [n_pad, L] matrices.
    Edits apply as <=CAP broadcast compare-selects, not a scatter. Flat
    edit offsets come from a device cumsum over the per-row counts, so no
    row array ships."""
    import jax
    return jax.jit(_upload_sparse_trace(w, L, mode2, has_sedit, has_qdense,
                                        has_qedit, const_lens, has_genome))


@_functools.cache
def _upload_score_fn(w: int, L: int, mode2: bool, has_sedit: bool,
                     has_qdense: bool, has_qedit: bool, const_lens: bool,
                     hi: int, mod: int, lo: int, s_hi: int, s_mod: int,
                     s_lo: int, s_bad: int, has_genome: bool = False,
                     no_overlap: bool = False):
    """Fused upload-reconstruction + overlap-scoring program: ONE device
    execute builds the resident seq/qual matrices from the sparse wire
    form AND applies Pair::computeScore across all rows (pair.cpp:88-172).
    Returns (seq_dev, qual_scored, score_dev)."""
    import jax

    up = _upload_sparse_trace(w, L, mode2, has_sedit, has_qdense,
                              has_qedit, const_lens, has_genome)

    @jax.jit
    def f(sd, src, scnt, epos, ecode, base, q_src, qd, qcnt, qpos, qval,
          lens16, mate16, meta, genome, gsl):
        seq, qual, lens = up(sd, src, scnt, epos, ecode, base, q_src, qd,
                             qcnt, qpos, qval, lens16, genome, gsl)
        if no_overlap:
            # meta = per-row scored bits (little order); empty overlap
            # windows reduce score_map_kernel to the qual tier per
            # position with untouched quals (pair.cpp:92,124-131)
            import jax.numpy as jnp
            bits = ((meta[:, None] >> jnp.arange(8, dtype=jnp.uint8)[None, :])
                    & 1).reshape(-1)[:qual.shape[0]].astype(jnp.bool_)
            q = qual.astype(jnp.int32)
            sc = kernels._qual2score(q, hi, mod, lo, s_hi, s_mod, s_lo,
                                     s_bad)
            score = jnp.where(bits[:, None], sc, s_mod).astype(jnp.int8)
            return seq, qual, score
        score, qual2 = kernels.score_map_kernel_packed(
            seq, qual, lens, mate16, meta, hi=hi, mod=mod, lo=lo,
            s_hi=s_hi, s_mod=s_mod, s_lo=s_lo, s_bad=s_bad)
        return seq, qual2, score

    return f


# BAM nibble byte (2 bases) -> 2-bit code pair; only meaningful for bytes
# passing the _PAIR_ACGT/_HI_ACGT validity check below (and 0 = padding)
_NIB2B = np.zeros(256, dtype=np.uint8)
_PAIR_ACGT = np.zeros(256, dtype=bool)  # both nibbles in {1,2,4,8}
_HI_ACGT = np.zeros(256, dtype=bool)    # hi in {1,2,4,8}, lo == 0 (odd tail)
for _hi in range(4):
    _HI_ACGT[(1 << _hi) << 4] = True
    _NIB2B[(1 << _hi) << 4] = _hi << 2
    for _lo in range(4):
        _b = ((1 << _hi) << 4) | (1 << _lo)
        _NIB2B[_b] = (_hi << 2) | _lo
        _PAIR_ACGT[_b] = True


# qual-index nibble pair -> 2-bit pair (indices <= 3 by construction)
_NIBIDX2B = np.array([((b >> 4) << 2) | (b & 0xF) for b in range(256)],
                     dtype=np.uint8)
_ALL_OK = np.ones(256, dtype=bool)

_GENOME_PAD = 4096  # device-genome end slack; also caps device-refbase L


@_functools.cache
def _refbase_combine_fn(L: int):
    """Device refbase assembly: genome slice-gather for contiguous-M jobs
    (host_map < 0), compact host-built rows for the rest."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(genome, gpos, host_rows, host_map, jl):
        hm = host_map.astype(jnp.int32)
        g = jax.vmap(lambda s: jax.lax.dynamic_slice(genome, (s,), (L,)))(gpos)
        keep = (jnp.arange(L, dtype=jnp.int32)[None, :]
                < jl.astype(jnp.int32)[:, None])
        g = jnp.where(keep, g, 0)
        h = host_rows[jnp.clip(hm, 0, host_rows.shape[0] - 1)]
        return jnp.where((hm < 0)[:, None], g, h)

    return f


@_functools.cache
def _concat_outs_fn(nb: int):
    """One-shot device concat of nb buckets' (dseq, dqual, diff, minc) so
    the host downloads 4 arrays instead of 4*nb."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def cat(*arrs):
        if nb == 1:
            return arrs[0], arrs[1], arrs[2], arrs[3]
        return tuple(jnp.concatenate([arrs[4 * i + k] for i in range(nb)],
                                     axis=0) for k in range(4))

    return cat


_IDENT16 = np.arange(16, dtype=np.uint8)


@_functools.cache
def _concat_sparse_fn(nb: int):
    """One-shot device concat of nb buckets' sparse encodings into a single
    u8 wire buffer: [qv J*(R or R/2) | qs J*R | nr J | sp J*C | sb J*C/2 |
    nd J | df 2J | mc 2J | bads 4*nb] — ~30-46 bytes/job vs ~160
    dense-packed. Per-bucket `bad` escape counters ride the tail (a bucket
    whose qual values escaped the nibble table is dense-pulled)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def cat(*arrs):
        groups = [arrs[9 * i:9 * (i + 1)] for i in range(nb)]
        bads = jnp.stack([g[8].reshape(()) for g in groups])
        if nb == 1:
            qv, qs, nr, sp, sb, nd, df16, mc16 = groups[0][:8]
        else:
            qv, qs, nr, sp, sb, nd, df16, mc16 = (
                jnp.concatenate([g[k] for g in groups], axis=0)
                for k in range(8))
        return jnp.concatenate([
            qv.reshape(-1), qs.reshape(-1), nr.reshape(-1),
            sp.reshape(-1), sb.reshape(-1), nd.reshape(-1),
            jax.lax.bitcast_convert_type(df16, jnp.uint8).reshape(-1),
            jax.lax.bitcast_convert_type(mc16, jnp.uint8).reshape(-1),
            jax.lax.bitcast_convert_type(bads, jnp.uint8).reshape(-1),
        ])

    return cat


@_functools.cache
def _pull_dense_fn():
    """Gather selected dense rows (packed seq + qual) into one flat u8
    download buffer — the overflow fallback for sparse collection."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def pull(pseq, qual, idx):
        return jnp.concatenate([pseq[idx].reshape(-1), qual[idx].reshape(-1)])

    return pull


@_functools.cache
def _concat_outs_packed_fn(nb: int):
    """_concat_outs_fn variant that also nibble-encodes the qual rows
    against a 16-value table (enc 0 = 'not in table'; `bad` counts
    escapes so the host can fall back to the raw rows, which stay
    device-resident and untransferred unless needed)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def cat(qtable, *arrs):
        if nb == 1:
            ps, dq, df, mc = arrs[0], arrs[1], arrs[2], arrs[3]
        else:
            ps, dq, df, mc = (jnp.concatenate(
                [arrs[4 * i + k] for i in range(nb)], axis=0)
                for k in range(4))
        enc = jnp.zeros(dq.shape, jnp.uint8)
        dec = jnp.zeros(dq.shape, jnp.uint8)
        for i in range(1, 16):
            hit = dq == qtable[i]
            enc = jnp.where(hit, jnp.uint8(i), enc)
            dec = jnp.where(hit, qtable[i], dec)
        bad = jnp.sum((dec != dq).astype(jnp.int32))
        qp = (enc[:, 0::2] << 4) | enc[:, 1::2]
        # single flat download buffer: [ps | qp | df | mc | bad] as bytes —
        # one np.asarray instead of five
        flat = jnp.concatenate([
            ps.reshape(-1),
            qp.reshape(-1),
            jax.lax.bitcast_convert_type(df, jnp.uint8).reshape(-1),
            jax.lax.bitcast_convert_type(mc, jnp.uint8).reshape(-1),
            jax.lax.bitcast_convert_type(bad[None], jnp.uint8).reshape(-1),
        ])
        return flat, dq

    return cat


@_functools.cache
def _gather_fns():
    import jax

    @jax.jit
    def g2(qual_dev, score_dev, rows):
        return qual_dev[rows], score_dev[rows]

    @jax.jit
    def g1(arr, rows):
        return arr[rows]

    return g2, g1


def _gather_one(arr, rows):
    _, g1 = _gather_fns()
    return g1(arr, rows)


def _pull_rows(qual_dev, score_dev, need_rows):
    g2, _ = _gather_fns()
    n2 = _bucket_rows(max(len(need_rows), 1))
    padded = np.pad(need_rows, (0, n2 - len(need_rows)))
    q, s = g2(qual_dev, score_dev, padded.astype(np.int32))
    return np.asarray(q), np.asarray(s)


class _PackedOut:
    """Deferred device vote outputs (packed seq nibbles, qual, diff, minc);
    device arrays are held until the single collection download.

    When the sparse wire encoding is active, `enc` holds the compact
    per-bucket device arrays (see vote._epilogue_core) and `rows0` the
    template work-array row per job (the host rebuilds consensus rows from
    its own copy of the template and the downloaded edits); dev_out then
    serves only as the dense fallback for overflow rows."""

    def __init__(self, dev_out, enc=None, rows0=None):
        self.dev_out = dev_out
        self.enc = enc
        self.rows0 = rows0


class _WorkArrays:
    """Dense working matrices for clustered reads; rows map from record
    index via searchsorted (cidx is ascending). Row count is padded to a
    power of two (+1 dummy row used as a scatter/gather sink for padded
    lanes) so compiled kernel shapes recur across workloads."""

    def __init__(self, batch, cidx: np.ndarray, max_len: int,
                 w_host: int | None = None, pad_pow2: bool = True,
                 sorted_cidx: np.ndarray = None, rank2row: np.ndarray = None,
                 seg_of_row: np.ndarray = None, genome: np.ndarray = None,
                 contig_base: np.ndarray = None,
                 contig_len: np.ndarray = None):
        """max_len is the device width L; w_host (defaults to L) is the
        narrower transfer width — enough for real read bases. The host
        keeps only compact upload staging (4-bit packed seq; quals as
        nibble indices into a <=16-entry value table when the data is
        RTA-binned, raw bytes otherwise); the device unpacks/decodes and
        zero-pads to [n_pad, L] on chip. No dense host matrices are built.

        cidx may arrive PERMUTED (group-contiguous row layout); then
        sorted_cidx/rank2row provide the read->row mapping and seg_of_row
        the per-row (group, side) segment id for the duplicate-aware
        upload encoding (rows beyond len(seg_of_row) are unreferenced by
        device kernels and ship no bytes)."""
        self.L = max_len
        self.w_host = w_host = w_host or max_len
        assert w_host % 2 == 0 and w_host <= max_len
        self.cidx = cidx
        if sorted_cidx is None:
            sorted_cidx = cidx
            rank2row = None
        self._sorted_cidx = sorted_cidx
        self._rank2row = rank2row
        self.seg_of_row = seg_of_row
        self._pad_pow2 = pad_pow2
        # host ASCII genome + contig geometry for genome-sourced upload
        # rows (all-M in-contig rows reconstruct on device from the
        # HBM-resident genome + their own ref-diff edits instead of
        # shipping dense segment heads)
        self._genome = genome
        self._contig_base = contig_base
        self._contig_len = contig_len
        n = len(cidx)
        n_pad = _bucket_rows(n + 1) if pad_pow2 else n + 1
        self.n_pad = n_pad
        self.lens = np.zeros(n_pad, dtype=np.int32)
        self.lens[:n] = np.minimum(batch.l_qseq[cidx], w_host)
        pw = w_host // 2
        from gencore_tpu.io import native
        use_native = (native.get_lib() is not None
                      and batch.data.flags.c_contiguous)
        # 4-bit packed seq rows straight from the BAM payload (threaded row
        # copies; garbage nibbles beyond each read are masked on device)
        seq_bytes = np.minimum((batch.l_qseq[cidx].astype(np.int64) + 1) // 2, pw)
        if use_native:
            self.seq_packed = np.zeros((n_pad, pw), dtype=np.uint8)
            native.gather_rows_into(batch.data, batch.seq_off[cidx],
                                    seq_bytes, self.seq_packed)
        else:
            cols = np.arange(pw, dtype=np.int64)
            gidx = batch.seq_off[cidx][:, None] + cols[None, :]
            np.minimum(gidx, len(batch.data) - 1, out=gidx)
            self.seq_packed = np.zeros((n_pad, pw), dtype=np.uint8)
            self.seq_packed[:n] = batch.data[gidx]
            mask = cols[None, :] >= seq_bytes[:, None]
            self.seq_packed[:n][mask] = 0
        qlens = self.lens[:n]
        self.dummy_row = n_pad - 1
        self.qtable16 = np.zeros(16, dtype=np.uint8)
        self.qual_table = None

        # ---- duplicate-aware sparse upload staging ----
        # Group members are near-duplicates of their segment head: ship one
        # dense row per (group, side) segment plus per-member (pos, code)
        # edits, reconstructed on device. Quals ship as one base value per
        # row plus (pos, val) edits (RTA data is runny; the bench case is
        # constant-per-read). Rows whose edit count exceeds the cap ship
        # dense; unreferenced tail rows ship nothing.
        import os as _os2
        self.upload_mode = "dense"
        if (seg_of_row is not None and w_host <= 256 and n > 0
                and not _os2.environ.get("GENCORE_NO_SPARSE_UP")
                and self._build_sparse_upload(batch, cidx, qlens, pw,
                                              use_native)):
            self.upload_mode = "sparse"
            self.seq_up = None
            self.qual_up = None
            self.seq_mode = "sparse"
            self.qual_mode = "sparse"
            # distinct-value table from the edit scan's seen mask (no
            # separate histogram pass; only segment rows matter — votes
            # gather member rows only). Feeds the download qual closure.
            nzvals = np.nonzero(self._qual_seen[1:])[0].astype(np.uint8) + 1
            if len(nzvals) <= 15:
                self.qual_table = self.qtable16
                self.qtable16[1:1 + len(nzvals)] = nzvals
            return

        # ---- dense staging fallback ----
        # qual value histogram -> (usual RTA case) nibble-index staging
        if use_native:
            counts = native.hist_rows(batch.data, batch.qual_off[cidx], qlens)
        else:
            counts = np.bincount(
                batch.qual_matrix(cidx, w_host).reshape(-1), minlength=256)
        nzvals = np.nonzero(counts[1:])[0].astype(np.uint8) + 1
        if len(nzvals) <= 15:
            self.qual_table = self.qtable16
            self.qtable16[1:1 + len(nzvals)] = nzvals
        if self.qual_table is not None:
            lut = np.zeros(256, dtype=np.uint8)
            lut[nzvals] = np.arange(1, 1 + len(nzvals), dtype=np.uint8)
            if use_native:
                self.qual_up = native.pack_nib_rows(
                    batch.data, batch.qual_off[cidx], qlens, lut, pw,
                    n_rows=n_pad)
            else:
                qidx = lut[batch.qual_matrix(cidx, w_host)]
                self.qual_up = np.zeros((n_pad, pw), dtype=np.uint8)
                self.qual_up[:n] = (qidx[:, 0::2] << 4) | qidx[:, 1::2]
        else:
            self.qual_up = np.zeros((n_pad, w_host), dtype=np.uint8)
            self.qual_up[:n] = batch.qual_matrix(cidx, w_host)

        # 2-bit staging when the data allows (pure-ACGT bases / <=3 distinct
        # qual values): 4 items per wire byte instead of 2. Fused native
        # check+map+pack when available (the numpy version's boolean
        # temporaries were a top materialize cost); numpy fallback below.
        self.seq_up = self.seq_packed
        self.seq_mode = "4bit"
        ow = (pw + 1) // 2
        packed2 = -1
        if n and use_native:
            s2 = np.zeros((n_pad, ow), dtype=np.uint8)
            packed2 = native.pack2_rows(self.seq_packed[:n], qlens,
                                        _NIB2B, _PAIR_ACGT, _HI_ACGT, s2)
            if packed2 == 1:
                self.seq_up = s2
                self.seq_mode = "2bit"
        if packed2 == -1 and n:
            cols = np.arange(pw, dtype=np.int64)[None, :]
            ql64 = qlens.astype(np.int64)[:, None]
            in_full = cols < (ql64 // 2)
            odd_pos = (cols == ql64 // 2) & (ql64 % 2 == 1)
            b = self.seq_packed[:n]
            bad = (~_PAIR_ACGT[b] & in_full) | (~_HI_ACGT[b] & odd_pos)
            if not bad.any():
                v = _NIB2B[b]
                s2 = np.zeros((n_pad, ow), dtype=np.uint8)
                if pw % 2:
                    v = np.pad(v, ((0, 0), (0, 1)))
                s2[:n] = (v[:, 0::2] << 4) | v[:, 1::2]
                self.seq_up = s2
                self.seq_mode = "2bit"
        if self.qual_table is not None and len(nzvals) <= 3:
            self.qual_mode = "2bit"
            q2 = None
            if n and use_native:
                q2 = np.zeros((n_pad, ow), dtype=np.uint8)
                full = np.full(n, 2 * pw, dtype=np.int32)
                if native.pack2_rows(self.qual_up[:n], full, _NIBIDX2B,
                                     _ALL_OK, _ALL_OK, q2) != 1:
                    q2 = None
            if q2 is not None:
                self.qual_up = q2
            else:
                bq = self.qual_up
                vq = ((bq >> 4) << 2) | (bq & 0xF)
                if pw % 2:
                    vq = np.pad(vq, ((0, 0), (0, 1)))
                self.qual_up = (vq[:, 0::2] << 4) | vq[:, 1::2]
        elif self.qual_table is not None:
            self.qual_mode = "4bit"
        else:
            self.qual_mode = "raw"

    def row_of(self, read_idx: np.ndarray) -> np.ndarray:
        rk = np.searchsorted(self._sorted_cidx, read_idx)
        return rk if self._rank2row is None else self._rank2row[rk]

    def row_of_one(self, read_idx: int) -> int:
        rk = int(np.searchsorted(self._sorted_cidx, read_idx))
        return rk if self._rank2row is None else int(self._rank2row[rk])

    def _build_sparse_upload(self, batch, cidx, qlens, pw, use_native) -> bool:
        """Stage the duplicate-aware sparse upload (see __init__ notes).
        Returns False when the encoding does not apply (dense-index
        overflow); True with self._sup populated. Wire cost on typical
        deep-panel data: ~1/3 of rows ship dense 2-bit (segment heads),
        everything else is a 2-byte src + ~1 edit — vs 2-bit dense rows
        for every member before (the upload byte floor)."""
        n = len(cidx)
        n_pad = self.n_pad
        w = self.w_host
        seg = self.seg_of_row
        ne = len(seg)
        ln = self.lens[:ne]
        if ne:
            new = np.ones(ne, dtype=bool)
            new[1:] = seg[1:] != seg[:-1]
            heads = np.nonzero(new)[0]
            rep = heads[seg]
        else:
            heads = np.zeros(0, dtype=np.int64)
            rep = np.zeros(0, dtype=np.int64)

        # ---- genome-sourced rows: all-M in-contig rows reconstruct from
        # the device-resident genome + their own ref-diff edits; segments
        # where EVERY row qualifies ship NO dense head at all (slots are
        # 4-byte genome offsets). Mixed/ineligible segments keep the
        # head-dense + member-diff scheme below. ----
        from gencore_tpu.io import native
        cap = _SPARSE_SEQ_CAP
        import os as _os3
        red = None
        gpos_row = np.full(max(ne, 1), -1, dtype=np.int64)
        if (self._genome is not None and use_native and ne
                and not _os3.environ.get("GENCORE_NO_GENOME_UP")):
            rec = cidx[:ne]
            lq = batch.l_qseq[rec].astype(np.int64)
            co = batch.cigar_off[rec]
            d = batch.data
            u32 = (d[co].astype(np.uint32)
                   | (d[co + 1].astype(np.uint32) << 8)
                   | (d[co + 2].astype(np.uint32) << 16)
                   | (d[co + 3].astype(np.uint32) << 24))
            t = batch.tid[rec].astype(np.int64)
            p = batch.pos[rec].astype(np.int64)
            tok = (t >= 0) & (t < len(self._contig_len))
            tc = np.clip(t, 0, max(len(self._contig_len) - 1, 0))
            ok = ((batch.n_cigar[rec] == 1)
                  & (u32 == (lq.astype(np.uint32) << 4))
                  & tok & (p >= 0) & (p + lq <= self._contig_len[tc]))
            if ok.any():
                gpos_row[:ne][ok] = (self._contig_base[tc] + p)[ok]
                red = native.ref_edits(self.seq_packed[:ne], ln,
                                       self._genome, gpos_row[:ne], cap)
        row_g = np.zeros(ne, dtype=bool)
        if red is not None and ne:
            # a segment goes genome-mode only when every row qualifies
            # (member edits below are diffs vs the head row, which a
            # genome-mode segment no longer ships)
            seg_bad = np.logical_or.reduceat(red[0] >= 128, heads)
            row_g = ~seg_bad[seg]
            if not row_g.any():
                red = None

        if red is not None and row_g.any():
            # genome-mode rows skip the member-vs-head diff scan entirely
            # (rep == self early-outs in gc_seq_edits); their edits come
            # from the ref diff
            rep_eff = np.where(row_g, np.arange(ne, dtype=np.int64), rep)
        else:
            rep_eff = rep
        sed = (native.seq_edits(self.seq_packed[:ne], rep_eff, ln,
                                _SPARSE_SEQ_CAP)
               if use_native and ne and not row_g.all() else None)
        if sed is not None or red is not None:
            if sed is not None:
                cnt_s, pos_s, code_s = sed
            else:
                cnt_s = np.zeros(ne, dtype=np.uint8)
                pos_s = np.zeros((ne, cap), dtype=np.uint8)
                code_s = np.zeros((ne, cap), dtype=np.uint8)
            dense_mask = np.zeros(ne, dtype=bool)
            dense_mask[heads] = True
            dense_mask |= cnt_s == 255
            if red is not None:
                dense_mask &= ~row_g
                cnt_s = np.where(row_g, red[0], cnt_s)
                pos_s = np.where(row_g[:, None], red[1], pos_s)
                code_s = np.where(row_g[:, None], red[2], code_s)
            scnt_e = np.where(dense_mask, 0, cnt_s).astype(np.uint8)
            vm = np.arange(cap, dtype=np.uint8)[None, :] < scnt_e[:, None]
            epos = pos_s[vm]          # C-order: grouped by row
            ecode = code_s[vm]
        else:
            X = self.seq_packed[:ne]
            Y = self.seq_packed[rep]
            D = X ^ Y
            cols2 = np.arange(pw, dtype=np.int32) * 2
            mhi = ((D >> 4) != 0) & (cols2[None, :] < ln[:, None])
            mlo = ((D & 15) != 0) & ((cols2 + 1)[None, :] < ln[:, None])
            cnt = mhi.sum(axis=1) + mlo.sum(axis=1)
            dense_mask = np.zeros(ne, dtype=bool)
            dense_mask[heads] = True
            dense_mask |= cnt > cap
            scnt_e = np.where(dense_mask, 0, cnt).astype(np.uint8)
            mhi &= ~dense_mask[:, None]
            mlo &= ~dense_mask[:, None]
            r1, c1 = np.nonzero(mhi)
            r2, c2 = np.nonzero(mlo)
            erow = np.concatenate([r1, r2])
            epos_all = np.concatenate([c1 * 2, c2 * 2 + 1])
            order = np.lexsort((epos_all, erow))
            erow = erow[order]
            epos_all = epos_all[order]
            byte = X[erow, epos_all // 2]
            ecode = np.where(epos_all % 2 == 0, byte >> 4,
                             byte & 15).astype(np.uint8)
            epos = epos_all.astype(np.uint8)
        dense_rows = np.nonzero(dense_mask)[0]
        nd = len(dense_rows) + 1  # index 0 = reserved all-zero row
        if nd > 65535:
            return False
        nd2 = _bucket_rows(nd) if self._pad_pow2 else nd
        gslots = np.zeros(1, dtype=np.int32)
        has_genome = False
        src = np.zeros(n_pad, dtype=np.uint16)
        dense_id = np.zeros(max(ne, 1), dtype=np.int64)
        dense_id[dense_rows] = 1 + np.arange(len(dense_rows))
        if ne:
            src[:ne] = np.where(dense_mask, dense_id[:ne],
                                dense_id[rep]).astype(np.uint16)
        if red is not None and row_g.any():
            # genome slots sit after the PADDED dense table on device:
            # src = nd2 + slot; one i32 genome offset per distinct window
            ug, ginv = np.unique(gpos_row[:ne][row_g], return_inverse=True)
            ns = len(ug)
            ns2 = _bucket_rows(ns) if self._pad_pow2 else ns
            if nd2 + ns2 > 65535:
                return False
            has_genome = True
            gslots = np.zeros(ns2, dtype=np.int32)
            gslots[:ns] = ug.astype(np.int32)
            src[:ne][row_g] = (nd2 + ginv).astype(np.uint16)
        scnt = np.zeros(n_pad, dtype=np.uint8)
        scnt[:ne] = scnt_e
        E = len(epos)

        # ---- qual: base value + (pos, val) edits; overflow rows raw ----
        sel = cidx[:ne]
        qcap = _SPARSE_QUAL_CAP
        base = np.zeros(n_pad, dtype=np.uint8)
        qed = (native.qual_edits(batch.data, batch.qual_off[sel], ln, qcap)
               if use_native and ne else None)
        if qed is not None:
            base_n, qcnt_n, qpos_s, qval_s, q_seen = qed
            self._qual_seen = q_seen
            base[:ne] = base_n
            over_q = qcnt_n == 255
            nq = int(over_q.sum())
            if nq > 65534:
                return False
            qcnt_e = np.where(over_q, 0, qcnt_n).astype(np.uint8)
            vmq = np.arange(qcap, dtype=np.uint8)[None, :] < qcnt_e[:, None]
            qpos = qpos_s[vmq]
            qval = qval_s[vmq]
            qd = np.zeros((max(nq, 1), w), dtype=np.uint8)
            q_src = np.zeros(n_pad, dtype=np.uint16)
            if nq:
                qrows = np.nonzero(over_q)[0]
                q_src[qrows] = 1 + np.arange(nq, dtype=np.int64)
                got = native.copy_rows(batch.data, batch.qual_off[sel[qrows]],
                                       ln[qrows].astype(np.int32), w)
                if got is None:
                    got = batch.qual_matrix(sel[qrows], w)
                qd[:nq] = got
        else:
            if ne:
                Q = None
                if use_native:
                    Q = native.copy_rows(batch.data, batch.qual_off[sel],
                                         ln.astype(np.int32), w)
                if Q is None:
                    Q = batch.qual_matrix(sel, w)
            else:
                Q = np.zeros((0, w), dtype=np.uint8)
            if ne:
                base[:ne] = np.where(ln > 0, Q[:, 0], 0)
            self._qual_seen = (np.bincount(
                Q.reshape(-1), minlength=256) > 0).astype(np.uint8)
            colw = np.arange(w, dtype=np.int32)
            Dq = (Q != base[:ne, None]) & (colw[None, :] < ln[:, None])
            qcnt_full = Dq.sum(axis=1)
            over_q = qcnt_full > qcap
            nq = int(over_q.sum())
            if nq > 65534:
                return False
            q_src = np.zeros(n_pad, dtype=np.uint16)
            qd = np.zeros((max(nq, 1), w), dtype=np.uint8)
            if nq:
                qrows = np.nonzero(over_q)[0]
                q_src[qrows] = 1 + np.arange(nq, dtype=np.int64)
                qd[:nq] = Q[qrows]
                Dq &= ~over_q[:, None]
            qcnt_e = np.where(over_q, 0, qcnt_full).astype(np.uint8)
            qr, qc = np.nonzero(Dq)  # C-order: already grouped by row
            qpos = qc.astype(np.uint8)
            qval = Q[qr, qc]
        qcnt = np.zeros(n_pad, dtype=np.uint8)
        qcnt[:ne] = qcnt_e
        Eq = len(qpos)

        # ---- dense subset packing (2-bit when pure ACGT) ----
        sub = self.seq_packed[dense_rows]
        sub_lens = ln[dense_rows].astype(np.int32)
        ow = (pw + 1) // 2
        mode2 = False
        sd = None
        if len(dense_rows):
            s2 = np.zeros((nd, ow), dtype=np.uint8)
            st = -1
            if use_native:
                from gencore_tpu.io import native
                st = native.pack2_rows(np.ascontiguousarray(sub), sub_lens,
                                       _NIB2B, _PAIR_ACGT, _HI_ACGT, s2[1:])
            if st == -1:
                colsp = np.arange(pw, dtype=np.int64)[None, :]
                ql64 = sub_lens.astype(np.int64)[:, None]
                in_full = colsp < (ql64 // 2)
                odd_pos = (colsp == ql64 // 2) & (ql64 % 2 == 1)
                bad = (~_PAIR_ACGT[sub] & in_full) | (~_HI_ACGT[sub] & odd_pos)
                if not bad.any():
                    v = _NIB2B[sub]
                    if pw % 2:
                        v = np.pad(v, ((0, 0), (0, 1)))
                    s2[1:] = (v[:, 0::2] << 4) | v[:, 1::2]
                    st = 1
            if st == 1:
                mode2 = True
                sd = s2
        if sd is None:
            sd = np.zeros((nd, pw), dtype=np.uint8)
            if len(dense_rows):
                sd[1:] = sub

        p2 = self._pad_pow2
        nd2 = _bucket_rows(nd) if p2 else nd
        sd = np.pad(sd, ((0, nd2 - nd), (0, 0)))
        if nq:
            nq2 = _bucket_rows(nq + 1) if p2 else nq + 1
            qd = np.pad(qd, ((0, nq2 - qd.shape[0]), (0, 0)))
        if E:
            E2 = _bucket_rows(E) if p2 else E
            epos = np.pad(epos, (0, E2 - E))
            ecode = np.pad(ecode, (0, E2 - E))
        if Eq:
            Eq2 = _bucket_rows(Eq) if p2 else Eq
            qpos = np.pad(qpos, (0, Eq2 - Eq))
            qval = np.pad(qval, (0, Eq2 - Eq))
        z1 = np.zeros(1, dtype=np.uint8)
        # uniform read length (the usual Illumina case): ship (len, n)
        # instead of an n_pad-long array
        const_lens = bool(n and (self.lens[:n] == self.lens[0]).all())
        lens16 = (np.array([self.lens[0], n], dtype=np.int32) if const_lens
                  else self.lens.astype(np.uint16))
        self._sup = dict(
            mode2=mode2, sd=sd, src=src,
            has_sedit=E > 0,
            scnt=scnt if E else z1, epos=epos if E else z1,
            ecode=ecode if E else z1,
            base=base,
            has_qdense=nq > 0,
            q_src=q_src if nq else np.zeros(1, dtype=np.uint16),
            qd=qd if nq else np.zeros((1, 1), dtype=np.uint8),
            has_qedit=Eq > 0,
            qcnt=qcnt if Eq else z1, qpos=qpos if Eq else z1,
            qval=qval if Eq else z1,
            const_lens=const_lens, lens16=lens16,
            has_genome=has_genome, gslots=gslots)
        return True

    def upload(self, genome_dev=None):
        """Dispatch the async host->device upload; returns device-resident
        (seq_dev, qual_dev, lens_dev): [n_pad, L] uint8 matrices plus the
        int32 per-row lengths (consumed by the packed score kernel so the
        lengths never ship twice). genome_dev: the HBM-resident NT16
        genome, required when the staging has genome-sourced rows."""
        if self.upload_mode == "sparse":
            s = self._sup
            g = genome_dev if s["has_genome"] else np.zeros(1, np.uint8)
            return _upload_sparse_fn(
                self.w_host, self.L, s["mode2"], s["has_sedit"],
                s["has_qdense"], s["has_qedit"], s["const_lens"],
                s["has_genome"])(
                s["sd"], s["src"], s["scnt"], s["epos"], s["ecode"],
                s["base"], s["q_src"], s["qd"], s["qcnt"], s["qpos"],
                s["qval"], s["lens16"], g, s["gslots"])
        return _upload_unpack_fn(
            self.w_host, self.L, self.qual_mode, self.seq_mode)(
            self.seq_up, self.qual_up, self.lens, self.qtable16)
