"""Consensus vote over gathered member tensors, in plain jax.numpy.

Layout: member tensors are [K, J, L] (K member reads with the template at
k=0, J jobs, L positions). The vote reduces over K to per-position
candidate outputs plus change/mismatch masks; a small epilogue applies the
reference's per-read rollback rule (mismatchInc > 5 -> restore,
group.cpp:538-566) and packs the outputs for download. Everything is int32
arithmetic, so the GPU, the CPU and the reference agree exactly; XLA fuses
the member gather, the K reductions and the elementwise election.

Semantics: identical to kernels._vote_core with full_bins=False (=ACGTN
data; other data takes kernels.fused_vote_kernel). tests/test_vote.py
checks the equivalence on the CPU; chip_smoke.py checks it on the GPU at
real widths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

I32 = jnp.int32
BINS = (0, 1, 2, 4, 8, 15)  # non-empty bins for =ACGTN data (see kernels.py)


SENTINEL = 255  # member-absent marker (never matches a bin or refbase)

# sparse wire-encoding caps (see _epilogue_core): inline seq edits / qual
# runs per job; jobs exceeding either are pulled densely by the collector.
# Sized on the bench workloads (deep panel + amplicon pile): per-job runs
# are p50=2 / max=10 and seq edits p99=2 / max=4, so these caps see no
# overflow there (the dense-pull fallback still covers any tail).
# SPARSE_DIFFS must stay even (bases pack 2/byte).
SPARSE_DIFFS = 4
SPARSE_RUNS = 10

_VOTE_PARAMS = ("hi", "mod", "lo", "base_score_req", "ratio_num",
                "ratio_den")


def _member_stats(seq, qual, score, rb, hi):
    """Per-bin member statistics, reduced over the K axis of seq/qual/score
    [K, J, L] (absent members carry SENTINEL rows with qual=0/score=0).
    rb is the int32 refbase [J, L]. Returns (countsB, scoresB, qualsB,
    topqB, total_score, ref_qual, high_ref)."""
    seq = seq.astype(I32)
    sc = score.astype(I32)
    ql = qual.astype(I32)
    countsB, scoresB, qualsB, topqB = [], [], [], []
    for b in BINS:
        m = seq == b
        mq = jnp.where(m, ql, 0)
        countsB.append(m.sum(axis=0, dtype=I32))
        scoresB.append(jnp.where(m, sc, 0).sum(axis=0))
        qualsB.append(mq.sum(axis=0))
        topqB.append(mq.max(axis=0))
    refm = (seq == rb[None]) & (rb != 0)[None]
    ref_qual = jnp.where(refm, ql, 0).max(axis=0)
    high_ref = (refm & (ql >= hi)).any(axis=0)
    return countsB, scoresB, qualsB, topqB, sc.sum(axis=0), ref_qual, high_ref


def _elect(stats, rb, out_base, hi, mod, lo, bsr, rnum, rden):
    """Per-position election from _member_stats; out_base is the int32
    template row [J, L]."""
    (countsB, scoresB, qualsB, topqB, total_score, ref_qual,
     high_ref) = stats
    has_ref = rb != 0

    # top election: lexmax of (score, qual, b) — see kernels.py proof
    neg_inf = jnp.int32(-0x7FFFFFFF)
    zero = jnp.zeros_like(rb)
    top_base = zero
    top_score = jnp.full_like(rb, neg_inf)
    top_qual_sum = zero
    for bi, b in enumerate(BINS):
        better = ((scoresB[bi] > top_score) |
                  ((scoresB[bi] == top_score) & (qualsB[bi] >= top_qual_sum)))
        top_base = jnp.where(better, b, top_base)
        top_score = jnp.where(better, scoresB[bi], top_score)
        top_qual_sum = jnp.where(better, qualsB[bi], top_qual_sum)
    # virtual always-empty candidate, lexmax key (score=0, qual=0, b=14)
    vb = ((0 > top_score) |
          ((top_score == 0) & (top_qual_sum <= 0) & (top_base < 14)))
    top_base = jnp.where(vb, 14, top_base)
    top_score = jnp.where(vb, 0, top_score)

    sec_base = zero
    sec_score = jnp.full_like(rb, neg_inf)
    sec_qual_sum = zero
    for bi, b in enumerate(BINS):
        better = ((top_base != b) &
                  ((scoresB[bi] > sec_score) |
                   ((scoresB[bi] == sec_score)
                    & (qualsB[bi] >= sec_qual_sum))))
        sec_base = jnp.where(better, b, sec_base)
        sec_score = jnp.where(better, scoresB[bi], sec_score)
        sec_qual_sum = jnp.where(better, qualsB[bi], sec_qual_sum)
    # virtual empty for sec: index 14 unless top took it, then 13
    vidx = jnp.where(top_base == 14, 13, 14)
    vb = ((0 > sec_score) |
          ((sec_score == 0) & (sec_qual_sum <= 0) & (sec_base < vidx)))
    sec_base = jnp.where(vb, vidx, sec_base)

    def take_bin(arrs, idx):
        out = zero
        for bi, b in enumerate(BINS):
            out = jnp.where(idx == b, arrs[bi], out)
        return out

    top_num = take_bin(countsB, top_base)
    top_qual = take_bin(topqB, top_base)
    sec_num = take_bin(countsB, sec_base)
    sec_qsum = take_bin(qualsB, sec_base)

    # early accept (group.cpp:422-428); needToCheckRef rules (:419-467)
    accept_early = (sec_num == 0) & (top_score >= bsr) & (top_qual >= mod)
    nr = (sec_num == 0) & ~accept_early
    nr |= (sec_num == 1) & jnp.where(sec_qsum <= lo,
                                     (top_num < 2) & (top_qual < hi),
                                     (top_num < 3) | (top_qual < hi))
    nr |= (sec_num > 1) & ((top_score * rden < rnum * total_score)
                           | (top_qual < mod))
    nr |= (top_score < bsr) | (top_qual <= lo)
    do_ref = nr & has_ref & ~accept_early

    # ref-consistent evidence (group.cpp:470-501)
    top_base2 = jnp.where(do_ref & high_ref, rb, top_base)
    top_base2 = jnp.where(do_ref & (top_qual < mod), rb, top_base2)
    top_qual2 = jnp.where(do_ref & (top_base2 == rb), ref_qual, top_qual)

    changed = ~accept_early & (out_base != top_base2)
    cand_seq = jnp.where(changed, top_base2, out_base)
    cand_qual = jnp.where(accept_early, top_qual, top_qual2)
    inner = jnp.where(out_base == rb, 1, jnp.where(top_base2 == rb, -1, 0))
    minc_pos = jnp.where(changed & has_ref, inner, 0)
    return cand_seq, cand_qual, changed.astype(I32), minc_pos


def _vote_masked(seq, qual, score, refbase, valid, *, hi, mod, lo,
                 base_score_req, ratio_num, ratio_den):
    """Voting math: seq/qual/score [K, J, L], valid [K, J] (absent members
    are masked to SENTINEL rows with qual=0/score=0), refbase [J, L].
    Returns (cand_seq, cand_qual, changed, minc_pos), each int32 [J, L];
    position masking by job length is applied in the epilogue."""
    invalid = ~(valid.astype(bool))[:, :, None]
    seq = jnp.where(invalid, jnp.uint8(SENTINEL), seq)
    qual = jnp.where(invalid, 0, qual)
    score = jnp.where(invalid, 0, score)
    rb = refbase.astype(I32)
    stats = _member_stats(seq, qual, score, rb, hi)
    return _elect(stats, rb, seq[0].astype(I32), hi, mod, lo,
                  base_score_req, ratio_num, ratio_den)


def _epilogue_core(cseq, cqual, chg, minc_pos, seq0, qual0,
                   job_len, *, hi, mod, lo, base_score_req, ratio_num,
                   ratio_den, out_len=None, sparse=False,
                   n_diffs=SPARSE_DIFFS, n_runs=SPARSE_RUNS, qtable=None):
    """Per-read rollback + output packing. new_seq ships 4-bit packed
    (BAM nibble layout, first base in the high nibble), which halves its
    download bytes; the host unpacks vectorized.

    sparse=True additionally emits a compact encoding (the dense arrays
    stay device-resident for overflow fallback):
      * seq as up to `n_diffs` (position, base) edits vs the template row
        (the consensus equals the template except at changed positions,
        group.cpp:504-516), plus the true edit count; edit bases are
        nibble-PAIRED (2 per byte);
      * qual as up to `n_runs` run-length (start, value) pairs, plus the
        true run count; when `qtable` (a device [16] u8 candidate table,
        see engine._vote_qual_table) is given, run values ship as nibble
        pairs of table indices with a `bad` escape counter — the host
        dense-pulls any bucket whose values escaped the closure.
    Requires out_len <= 256 so positions fit a byte (checked by caller).
    """
    J, L = cseq.shape
    pos_valid = jnp.arange(L, dtype=I32)[None, :] < job_len[:, None]
    tmpl_seq = seq0.astype(I32)
    tmpl_qual = qual0.astype(I32)
    chg = jnp.where(pos_valid, chg, 0)
    minc_pos = jnp.where(pos_valid, minc_pos, 0)
    cseq = jnp.where(pos_valid, cseq, tmpl_seq)
    cqual = jnp.where(pos_valid, cqual, tmpl_qual)
    diff = chg.sum(axis=1)
    minc = minc_pos.sum(axis=1)
    rollback = (minc > 5)[:, None]
    new_seq = jnp.where(rollback, tmpl_seq, cseq).astype(jnp.uint8)
    new_qual = jnp.where(rollback, tmpl_qual, cqual).astype(jnp.uint8)
    ol = L if out_len is None else min(out_len, L)
    new_seq = new_seq[:, :ol]
    new_qual = new_qual[:, :ol]
    pseq = (new_seq[:, 0::2] << 4) | new_seq[:, 1::2]
    if not sparse:
        return pseq, new_qual, diff, minc

    # ---- seq edits vs the template row (final rows, so rollback and
    # out-of-range positions are already template values and never edit)
    emask = (new_seq != seq0.astype(jnp.uint8)[:, :ol]).astype(I32)
    nd = emask.sum(axis=1)
    ranks = jnp.cumsum(emask, axis=1) * emask      # 1..nd at edit positions
    sp = []
    sb = []
    for d in range(1, n_diffs + 1):
        pos = jnp.argmax((ranks == d).astype(I32), axis=1).astype(I32)
        sp.append(pos)
        sb.append(jnp.take_along_axis(new_seq, pos[:, None], axis=1)[:, 0])
    sp = jnp.stack(sp, axis=1).astype(jnp.uint8)
    sb = jnp.stack(sb, axis=1).astype(jnp.uint8)
    # edit bases are 4-bit codes: pair them (n_diffs must be even)
    sbp = (sb[:, 0::2] << 4) | sb[:, 1::2]

    # ---- qual runs
    q = new_qual.astype(I32)
    b = jnp.concatenate(
        [jnp.ones((J, 1), I32), (q[:, 1:] != q[:, :-1]).astype(I32)], axis=1)
    rid = jnp.cumsum(b, axis=1) * b                # run no. (1-based) at starts
    qs = []
    qv = []
    for r in range(1, n_runs + 1):
        pos = jnp.argmax((rid == r).astype(I32), axis=1).astype(I32)
        qs.append(pos)
        qv.append(jnp.take_along_axis(q, pos[:, None], axis=1)[:, 0])
    qs = jnp.stack(qs, axis=1).astype(jnp.uint8)
    qv = jnp.stack(qv, axis=1).astype(jnp.uint8)
    nr = b.sum(axis=1)

    if qtable is not None:
        # run values as nibble-paired table indices; `bad` counts escapes
        # (host falls back to the dense pull for the whole bucket)
        qenc = jnp.zeros(qv.shape, jnp.uint8)
        qdec = jnp.zeros(qv.shape, jnp.uint8)
        for i in range(1, 16):
            hit = qv == qtable[i]
            qenc = jnp.where(hit, jnp.uint8(i), qenc)
            qdec = jnp.where(hit, qtable[i], qdec)
        vrun = jnp.arange(n_runs, dtype=I32)[None, :] < jnp.minimum(
            nr, n_runs)[:, None]
        bad = jnp.sum(((qdec != qv) & vrun).astype(I32))
        qvp = (qenc[:, 0::2] << 4) | qenc[:, 1::2]
        enc = (qvp, qs, jnp.minimum(nr, 255).astype(jnp.uint8),
               sp, sbp, jnp.minimum(nd, 255).astype(jnp.uint8),
               diff.astype(jnp.int16), minc.astype(jnp.int16),
               bad.astype(jnp.int32))
    else:
        enc = (qv, qs, jnp.minimum(nr, 255).astype(jnp.uint8),
               sp, sbp, jnp.minimum(nd, 255).astype(jnp.uint8),
               diff.astype(jnp.int16), minc.astype(jnp.int16),
               jnp.zeros((), jnp.int32))
    return pseq, new_qual, diff, minc, enc


@functools.partial(jax.jit,
                   static_argnames=_VOTE_PARAMS + ("out_len", "sparse"))
def vote(seq, qual, score, valid, job_len, refbase, *, hi, mod, lo,
         base_score_req, ratio_num, ratio_den, out_len=None, sparse=False):
    """Vote over gathered member tensors.

    seq/qual [K, J, L] uint8, score [K, J, L] int8, valid [K, J] (any int),
    job_len [J] int32, refbase [J, L] uint8. Returns (pseq, new_qual, diff,
    minc): pseq is the consensus sequence 4-bit packed (BAM nibble layout,
    [J, out_len//2]); new_qual is raw [J, out_len]. Semantics after host
    unpack match kernels._vote_core (full_bins=False) including rollback.

    sparse=True appends the compact encoding (see _epilogue_core): returns
    (pseq, new_qual, diff, minc, enc).
    """
    kw = dict(hi=hi, mod=mod, lo=lo, base_score_req=base_score_req,
              ratio_num=ratio_num, ratio_den=ratio_den)
    cand = _vote_masked(seq, qual, score, refbase, valid, **kw)
    return _epilogue_core(*cand, seq[0], qual[0], job_len.astype(I32),
                          out_len=out_len, sparse=sparse, **kw)


@functools.partial(jax.jit,
                   static_argnames=_VOTE_PARAMS + ("out_len", "sparse"))
def vote_gathered(seq_dev, qual_dev, score_dev, rows_t, valid, job_len,
                  refbase, qtable=None, *, hi, mod, lo, base_score_req,
                  ratio_num, ratio_den, out_len=None, sparse=False):
    """vote with the member gather from the device-resident read matrices
    fused into the same program. rows_t int32 [K, J] member work rows
    (transposed, template at k=0); other args as vote."""
    kw = dict(hi=hi, mod=mod, lo=lo, base_score_req=base_score_req,
              ratio_num=ratio_num, ratio_den=ratio_den)
    cand = _vote_masked(seq_dev[rows_t], qual_dev[rows_t],
                        score_dev[rows_t], refbase, valid, **kw)
    row0 = rows_t[0]
    return _epilogue_core(*cand, seq_dev[row0], qual_dev[row0],
                          job_len.astype(I32), out_len=out_len,
                          sparse=sparse, qtable=qtable, **kw)


@functools.partial(jax.jit, static_argnames=_VOTE_PARAMS + (
    "classes", "L", "out_len"))
def vote_window(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
                qtable, *class_args, classes, L, hi, mod, lo,
                base_score_req, ratio_num, ratio_den, out_len):
    """EVERY fast vote bucket of one window in ONE device program:
    refbase assembly (genome slice-gather + host rows), per-k-class member
    gather + vote + rollback/sparse-encode epilogue, and the cross-class
    concat into one download buffer. `classes` is a tuple of (K, J2) and
    `class_args` holds (base_row, counts, job_len, ridx) per class.
    Returns (flat u8 buffer, refbase_dev, [per-class (pseq, qual) dense
    fallbacks]). The flat layout matches engine._concat_sparse_fn:
    [qv | qs | nr | sp | sb | nd | df | mc | bads]."""
    kw = dict(hi=hi, mod=mod, lo=lo, base_score_req=base_score_req,
              ratio_num=ratio_num, ratio_den=ratio_den)
    # refbase for ALL fast jobs (engine._refbase_device semantics)
    hm32 = hm.astype(I32)
    g = jax.vmap(lambda s: jax.lax.dynamic_slice(genome, (s,), (L,)))(gp)
    keep = (jnp.arange(L, dtype=I32)[None, :]
            < jp.astype(I32)[:, None])
    g = jnp.where(keep, g, 0)
    h = hr[jnp.clip(hm32, 0, hr.shape[0] - 1)]
    refbase_dev = jnp.where((hm32 < 0)[:, None], g, h)

    n_pad = seq_dev.shape[0]
    parts = [[] for _ in range(8)]
    bads = []
    dense = []
    for ci, (K, _J2) in enumerate(classes):
        base_row, counts, jl, ridx = class_args[4 * ci:4 * ci + 4]
        br = base_row.astype(I32)
        k_iota = jnp.arange(K, dtype=I32)[:, None]
        rows_t = jnp.clip(br[None, :] + k_iota, 0, n_pad - 1)
        valid = k_iota < counts[None, :].astype(I32)
        refbase = refbase_dev[ridx.astype(I32)]
        cand = _vote_masked(seq_dev[rows_t], qual_dev[rows_t],
                            score_dev[rows_t], refbase, valid, **kw)
        res = _epilogue_core(*cand, seq_dev[br], qual_dev[br],
                             jl.astype(I32), out_len=out_len, sparse=True,
                             qtable=qtable, **kw)
        enc = res[4]
        for k in range(8):
            parts[k].append(enc[k])
        bads.append(enc[8].reshape(()))
        dense.append((res[0], res[1]))
    cat = [jnp.concatenate(p, axis=0) if len(p) > 1 else p[0]
           for p in parts]
    qv, qs, nr, sp, sb, nd, df16, mc16 = cat
    flat = jnp.concatenate([
        qv.reshape(-1), qs.reshape(-1), nr.reshape(-1),
        sp.reshape(-1), sb.reshape(-1), nd.reshape(-1),
        jax.lax.bitcast_convert_type(df16, jnp.uint8).reshape(-1),
        jax.lax.bitcast_convert_type(mc16, jnp.uint8).reshape(-1),
        jax.lax.bitcast_convert_type(jnp.stack(bads), jnp.uint8).reshape(-1),
    ])
    return flat, refbase_dev, dense
