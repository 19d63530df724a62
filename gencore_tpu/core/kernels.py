"""Device kernels (JAX/XLA) for the consensus engine.

These reformulate the reference's per-read scalar loops as dense batched
tensor ops:

  * overlap_score_kernel — Pair::computeScore (pair.cpp:70-172) over a batch
    of read pairs [P, L];
  * consensus_kernel — Group::makeConsensus (group.cpp:320-579) over padded
    job tensors [J, K, L] (J merge jobs, K member reads, L positions);
  * duplex_mask_kernel — Cluster::duplexMergeBam (cluster.cpp:199-244) over
    duplex candidate pairs [D, L].

All integer arithmetic is int32 (exact); the single floating-point decision
in the reference (`topScore < ratio * totalScore`, group.cpp:462) is
reformulated as an exact integer cross-multiplication so device float
precision can never flip a branch (see Options ratio fraction).

Everything here is shape-polymorphic over bucketed padded shapes and jit
cached per shape.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32


def ratio_fraction(score_percent_req: float) -> tuple[int, int]:
    """Exact small fraction for the ratio threshold.

    The CLI value is a short decimal (e.g. 0.8); Fraction(str) recovers the
    intended rational. The integer predicate 5*top < 4*total matches the
    C++ double predicate for all reachable magnitudes (|err| of the double
    product < 1/den gap; equality case rounds to the exact integer).
    """
    f = Fraction(str(float(score_percent_req))).limit_denominator(10**6)
    return f.numerator, f.denominator


# --------------------------------------------------------------------------
# Pair overlap scoring
# --------------------------------------------------------------------------

def _qual2score(q, hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """reference pair.cpp:77-86 tiering, vectorized."""
    return jnp.where(q >= hi, s_hi,
                     jnp.where(q >= mod, s_mod,
                               jnp.where(q >= lo, s_lo, s_bad)))


def _overlap_core(lseq, lqual, rseq, rqual, left_start, right_start,
                  cmp_len, llen, rlen, hi, mod, lo, s_hi, s_mod,
                  s_lo, s_bad):
    """Traced overlap-scoring core shared by overlap_score_kernel and
    score_scatter_kernel. See overlap_score_kernel docstring."""
    P, L = lseq.shape
    j = jnp.arange(L, dtype=I32)[None, :]
    ls = left_start[:, None]
    rs = right_start[:, None]
    cl = cmp_len[:, None]

    lq = lqual.astype(I32)
    rq = rqual.astype(I32)

    # overlap membership for left positions / right positions
    in_ov_l = (j >= ls) & (j < ls + cl) & (j < llen[:, None])
    in_ov_r = (j >= rs) & (j < rs + cl) & (j < rlen[:, None])

    # partner gather: for left pos l -> right pos l-ls+rs; clamp for safety
    ridx = jnp.clip(j - ls + rs, 0, L - 1)
    lidx = jnp.clip(j - rs + ls, 0, L - 1)
    r_for_l = jnp.take_along_axis(rseq, ridx, axis=1)
    rq_for_l = jnp.take_along_axis(rq, ridx, axis=1)
    l_for_r = jnp.take_along_axis(lseq, lidx, axis=1)
    lq_for_r = jnp.take_along_axis(lq, lidx, axis=1)

    q2s = lambda q: _qual2score(q, hi, mod, lo, s_hi, s_mod, s_lo, s_bad)

    # ---- left side ----
    match_l = lseq == r_for_l
    avg_l = (lq + rq_for_l) // 2
    ov_match_score_l = q2s(avg_l) + 4
    win_l = lq >= rq_for_l
    ov_mis_score_l = jnp.where(win_l, q2s(lq - rq_for_l) - 3, 0)
    ov_score_l = jnp.where(match_l, ov_match_score_l, ov_mis_score_l)
    lscore = jnp.where(in_ov_l, ov_score_l, q2s(lq))
    new_lqual = jnp.where(in_ov_l & ~match_l,
                          jnp.maximum(0, lq - rq_for_l), lq).astype(jnp.uint8)

    # ---- right side ----
    match_r = rseq == l_for_r
    avg_r = (rq + lq_for_r) // 2
    ov_match_score_r = q2s(avg_r) + 4
    win_r = rq > lq_for_r          # right wins strictly (left wins ties, pair.cpp:161)
    ov_mis_score_r = jnp.where(win_r, q2s(rq - lq_for_r) - 3, 0)
    ov_score_r = jnp.where(match_r, ov_match_score_r, ov_mis_score_r)
    rscore = jnp.where(in_ov_r, ov_score_r, q2s(rq))
    new_rqual = jnp.where(in_ov_r & ~match_r,
                          jnp.maximum(0, rq - lq_for_r), rq).astype(jnp.uint8)

    return lscore.astype(I32), rscore.astype(I32), new_lqual, new_rqual


@functools.partial(jax.jit, static_argnames=("hi", "mod", "lo", "s_hi", "s_mod", "s_lo", "s_bad"))
def overlap_score_kernel(lseq, lqual, rseq, rqual, left_start, right_start,
                         cmp_len, llen, rlen, *, hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """Vectorized Pair::computeScore.

    Args (P pairs, L max read len):
      lseq/rseq  uint8[P, L]  nt16 base codes
      lqual/rqual uint8[P, L]
      left_start/right_start/cmp_len int32[P]  overlap geometry
        (from the first M segments + posDis, pair.cpp:103-119)
      llen/rlen int32[P]
    Returns (lscore, rscore, new_lqual, new_rqual) — scores int32[P, L],
    quals uint8[P, L] with the reference's overlap-mismatch rewrite applied
    (pair.cpp:155-167).
    """
    return _overlap_core(lseq, lqual, rseq, rqual, left_start,
                         right_start, cmp_len, llen, rlen, hi,
                         mod, lo, s_hi, s_mod, s_lo, s_bad)



# --------------------------------------------------------------------------
# Consensus voting
# --------------------------------------------------------------------------

def _vote_core(seq, qual, score, valid, pos_valid, refbase,
               hi, mod, lo, base_score_req, ratio_num, ratio_den,
               full_bins):
    """Traced voting core shared by consensus_kernel and the fused
    on-device pipeline. See consensus_kernel docstring."""
    J, K, L = seq.shape
    present = valid[:, :, None] & pos_valid[:, None, :]       # [J,K,L]
    sc = jnp.where(present, score, 0)
    ql = jnp.where(present, qual.astype(I32), 0)

    # Bin set: BAM nt16 codes. When the batch contains only =ACGTN codes
    # (the overwhelmingly common case; checked host-side), only bins
    # {0,1,2,4,8,15} can be non-empty, and all always-empty bins behave as
    # a single virtual candidate with key (score=0, qual=0, index=14): the
    # original b=0..15 scan equals an argmax of (score, qual, b)
    # lexicographic with later-index tie-wins (see proof in docs), so empty
    # bins are dominated by the largest empty index (14; 15 is a real bin).
    bins = tuple(range(16)) if full_bins else (0, 1, 2, 4, 8, 15)

    def bin_stats(b):
        m = present & (seq == b)
        counts = m.sum(axis=1, dtype=I32)
        bscore = jnp.where(m, sc, 0).sum(axis=1, dtype=I32)
        bqual = jnp.where(m, ql, 0).sum(axis=1, dtype=I32)
        topq = jnp.where(m, ql, 0).max(axis=1)
        return counts, bscore, bqual, topq

    stats = [bin_stats(b) for b in bins]
    countsB = jnp.stack([s[0] for s in stats], axis=-1)     # [J,L,B]
    scoresB = jnp.stack([s[1] for s in stats], axis=-1)
    qualsB = jnp.stack([s[2] for s in stats], axis=-1)
    topqB = jnp.stack([s[3] for s in stats], axis=-1)
    total_score = sc.sum(axis=1, dtype=I32)                  # [J,L]

    neg_inf = jnp.int32(-0x7FFFFFFF)
    zero = jnp.zeros((J, L), dtype=I32)

    # top-base election: argmax of (score, qual, bin-index) lexicographic,
    # later index winning ties — exactly the reference's b-ascending scan
    # with `> || (== && quals[b] >= quals[top])` (group.cpp:394-402)
    top_base = jnp.zeros((J, L), dtype=I32)
    top_score = jnp.full((J, L), neg_inf)
    top_quals_cur = zero
    for bi, b in enumerate(bins):
        better = (scoresB[..., bi] > top_score) | (
            (scoresB[..., bi] == top_score) & (qualsB[..., bi] >= top_quals_cur))
        top_base = jnp.where(better, b, top_base)
        top_score = jnp.where(better, scoresB[..., bi], top_score)
        top_quals_cur = jnp.where(better, qualsB[..., bi], top_quals_cur)
    if not full_bins:
        # virtual always-empty candidate, lexmax key (score=0, qual=0, b=14)
        v_better = (0 > top_score) | ((top_score == 0) & (top_quals_cur <= 0) & (top_base < 14))
        top_base = jnp.where(v_better, 14, top_base)
        top_score = jnp.where(v_better, 0, top_score)
        top_quals_cur = jnp.where(v_better, 0, top_quals_cur)

    # secondary election skipping top (group.cpp:407-416)
    sec_base = jnp.zeros((J, L), dtype=I32)
    sec_score = jnp.full((J, L), neg_inf)
    sec_quals_cur = zero
    for bi, b in enumerate(bins):
        is_top = top_base == b
        better = ~is_top & ((scoresB[..., bi] > sec_score) | (
            (scoresB[..., bi] == sec_score) & (qualsB[..., bi] >= sec_quals_cur)))
        sec_base = jnp.where(better, b, sec_base)
        sec_score = jnp.where(better, scoresB[..., bi], sec_score)
        sec_quals_cur = jnp.where(better, qualsB[..., bi], sec_quals_cur)
    if not full_bins:
        # virtual empty for sec: index 14 unless top took it, then 13
        vidx = jnp.where(top_base == 14, 13, 14)
        v_better = (0 > sec_score) | ((sec_score == 0) & (sec_quals_cur <= 0) & (sec_base < vidx))
        sec_base = jnp.where(v_better, vidx, sec_base)
        sec_score = jnp.where(v_better, 0, sec_score)
        sec_quals_cur = jnp.where(v_better, 0, sec_quals_cur)

    def take_bin(arr, idx):
        out = jnp.zeros((J, L), dtype=arr.dtype)
        for bi, b in enumerate(bins):
            out = jnp.where(idx == b, arr[..., bi], out)
        return out

    top_num = take_bin(countsB, top_base)
    top_qual = take_bin(topqB, top_base)
    sec_num = take_bin(countsB, sec_base)
    sec_qual_sum = take_bin(qualsB, sec_base)

    # early accept (group.cpp:422-428): keep template base, write topQual
    accept_early = (sec_num == 0) & (top_score >= base_score_req) & (top_qual >= mod)

    # needToCheckRef rules (group.cpp:419-467)
    need_ref = (sec_num == 0) & ~accept_early
    nr1 = (sec_num == 1) & jnp.where(
        sec_qual_sum <= lo,
        (top_num < 2) & (top_qual < hi),
        (top_num < 3) | (top_qual < hi))
    need_ref |= nr1
    # ratio test via exact integer cross-multiplication (see ratio_fraction)
    nr2 = (sec_num > 1) & (
        (top_score * ratio_den < ratio_num * total_score) | (top_qual < mod))
    need_ref |= nr2
    need_ref |= (top_score < base_score_req) | (top_qual <= lo)

    has_ref = refbase != 0
    do_ref = need_ref & has_ref & ~accept_early

    # ref-consistent evidence (group.cpp:470-501)
    ref_m = present & (seq == refbase[:, None, :])
    ref_base_qual = jnp.where(ref_m, ql, 0).max(axis=1)
    any_high_ref = (jnp.where(ref_m, ql, 0) >= hi).any(axis=1) & ref_m.any(axis=1)

    rb = refbase.astype(I32)
    top_base2 = jnp.where(do_ref & any_high_ref, rb, top_base)
    top_base2 = jnp.where(do_ref & (top_qual < mod), rb, top_base2)
    top_qual2 = jnp.where(do_ref & (top_base2 == rb), ref_base_qual, top_qual)

    out_base = seq[:, 0, :].astype(I32)
    out_qual_orig = qual[:, 0, :]

    changed = ~accept_early & (out_base != top_base2) & pos_valid
    cand_seq = jnp.where(changed, top_base2, out_base)
    cand_qual = jnp.where(pos_valid,
                          jnp.where(accept_early, top_qual, top_qual2),
                          out_qual_orig.astype(I32))

    diff = changed.sum(axis=1, dtype=I32)
    minc = jnp.where(changed & has_ref,
                     jnp.where(out_base == rb, 1,
                               jnp.where(top_base2 == rb, -1, 0)),
                     0).sum(axis=1, dtype=I32)

    rollback = (minc > 5)[:, None]
    new_seq = jnp.where(rollback, out_base, cand_seq).astype(jnp.uint8)
    new_qual = jnp.where(rollback, out_qual_orig.astype(I32), cand_qual).astype(jnp.uint8)
    return new_seq, new_qual, diff, minc


@functools.partial(jax.jit, static_argnames=(
    "hi", "mod", "lo", "base_score_req", "ratio_num", "ratio_den", "full_bins"))
def consensus_kernel(seq, qual, score, valid, pos_valid, refbase,
                     *, hi, mod, lo, base_score_req, ratio_num, ratio_den,
                     full_bins=True):
    """Vectorized Group::makeConsensus voting (group.cpp:369-526).

    Args (J jobs, K member reads incl. template at k=0, L positions):
      seq   uint8[J, K, L]  member bases, pre-shifted by lenDiff for
                             right-mode jobs (group.cpp:376-385)
      qual  uint8[J, K, L]
      score int32[J, K, L]  per-base scores from overlap scoring
      valid bool[J, K]      member present
      pos_valid bool[J, L]  position < job length
      refbase uint8[J, L]   reference base as nt16 code, 0 = unavailable
                             (host gathers via template ref offsets;
                             group.cpp:430-439)
    Returns:
      new_seq  uint8[J, L]  consensus bases (template positions)
      new_qual uint8[J, L]
      diff        int32[J]  changed-base count
      mismatch_inc int32[J] signed NM delta vs reference
      (rollback handled here: new_seq/new_qual revert to the template row
       when mismatch_inc > 5, group.cpp:538-566)
    """
    return _vote_core(seq, qual, score, valid, pos_valid, refbase,
                      hi, mod, lo, base_score_req, ratio_num,
                      ratio_den, full_bins)



# --------------------------------------------------------------------------
# Fused on-device pipeline: scoring + member-gather + voting, with the big
# read matrices resident on device (uploaded once per window).
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "hi", "mod", "lo", "s_hi", "s_mod", "s_lo", "s_bad"))
def score_map_kernel(seq_all, qual_all, mate_row, my_start, mate_start,
                     cmp_len, my_len, is_left, scored,
                     *, hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """Overlap scoring as a pure per-row gather/map (no scatter).

    Every read row belongs to at most one pair, so instead of computing
    [P, L] pair tensors and scattering them back (score_scatter_kernel),
    each row looks up its mate row and computes its own score/qual in
    place. Semantics per reference Pair::computeScore (pair.cpp:88-172):
    non-overlap qual tiering (pair.cpp:124-131), overlap match avg-qual+4
    (pair.cpp:149-154), overlap mismatch qual rewrite max(0, this-pair)
    with winner qual2score(diff)-3 / loser 0 (pair.cpp:155-167); the left
    mate wins quality ties (pair.cpp:161).

    Args (all [N] except the matrices):
      seq_all/qual_all uint8[N, L]  device-resident read matrices
      mate_row int32[N]   row index of the pair mate (self if unscored)
      my_start/mate_start/cmp_len int32[N]  overlap geometry for this row
      my_len int32[N]     read length of this row
      is_left bool[N]     True for the left mate (wins qual ties)
      scored bool[N]      row participates in scoring; others keep the
                          moderate default (pair.cpp:92) and original quals
    Returns (score_all int8[N, L], qual_all' uint8[N, L]).
    """
    N, L = seq_all.shape
    j = jnp.arange(L, dtype=I32)[None, :]
    ms = my_start[:, None]
    ts = mate_start[:, None]
    cl = cmp_len[:, None]
    q = qual_all.astype(I32)
    in_ov = (j >= ms) & (j < ms + cl) & (j < my_len[:, None])
    # partner alignment p[j] = mate[j + (ts - ms)]: a per-row constant
    # shift, gathered per element. Inside the overlap window the shifted
    # index is in range by construction; positions outside it are masked.
    idx = jnp.clip(j + (ts - ms), 0, L - 1)
    p_seq = jnp.take_along_axis(seq_all[mate_row], idx, axis=1)
    p_q = jnp.take_along_axis(qual_all[mate_row], idx, axis=1).astype(I32)
    q2s = lambda x: _qual2score(x, hi, mod, lo, s_hi, s_mod, s_lo, s_bad)
    match = seq_all == p_seq
    ov_match = q2s((q + p_q) // 2) + 4
    win = (q > p_q) | (is_left[:, None] & (q == p_q))
    ov_mis = jnp.where(win, q2s(q - p_q) - 3, 0)
    score = jnp.where(in_ov, jnp.where(match, ov_match, ov_mis), q2s(q))
    score = jnp.where(scored[:, None], score, s_mod).astype(jnp.int8)
    new_q = jnp.where(scored[:, None] & in_ov & ~match,
                      jnp.maximum(0, q - p_q), q).astype(jnp.uint8)
    return score, new_q


@functools.partial(jax.jit, static_argnames=(
    "hi", "mod", "lo", "s_hi", "s_mod", "s_lo", "s_bad"))
def score_map_kernel_packed(seq_all, qual_all, lens_dev, mate_row, meta,
                            *, hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """score_map_kernel with the per-row geometry packed into one uint32
    (my_start 8b | mate_start 8b | cmp_len 9b | is_left 1b | scored 1b) and
    the read lengths taken from the device-resident lens array — 6 B/row
    on the wire (u32 meta + u16 mate row) instead of 22 B. Semantics
    identical to score_map_kernel; requires w_host <= 256 (the CLI/engine
    only packs then)."""
    meta = meta.astype(jnp.uint32)
    my_start = (meta & 0xFF).astype(I32)
    mate_start = ((meta >> 8) & 0xFF).astype(I32)
    cmp_len = ((meta >> 16) & 0x1FF).astype(I32)
    is_left = ((meta >> 25) & 1).astype(jnp.bool_)
    scored = ((meta >> 26) & 1).astype(jnp.bool_)
    return score_map_kernel(seq_all, qual_all, mate_row.astype(I32),
                            my_start, mate_start, cmp_len,
                            lens_dev.astype(I32), is_left, scored,
                            hi=hi, mod=mod, lo=lo, s_hi=s_hi, s_mod=s_mod,
                            s_lo=s_lo, s_bad=s_bad)


@functools.partial(jax.jit, static_argnames=(
    "hi", "mod", "lo", "s_hi", "s_mod", "s_lo", "s_bad"))
def score_scatter_kernel(seq_all, qual_all, lrow, rrow, ls, rs, cl, llen, rlen,
                         *, hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """Overlap scoring over pair row indices into the device-resident read
    matrices; returns (score_all int8[N, L] with scored rows scattered in,
    qual_all with the overlap-mismatch rewrites applied).

    Unscored rows keep the moderate default (= s_mod; reference memsets the
    arrays to scoreOfNotOverlappedModerateQual, pair.cpp:92)."""
    N, L = seq_all.shape
    lseq = seq_all[lrow]
    rseq = seq_all[rrow]
    lqual = qual_all[lrow]
    rqual = qual_all[rrow]
    lscore, rscore, nlq, nrq = _overlap_core(
        lseq, lqual, rseq, rqual, ls, rs, cl, llen, rlen,
        hi, mod, lo, s_hi, s_mod, s_lo, s_bad)
    score_all = jnp.full((N, L), s_mod, dtype=jnp.int8)
    score_all = score_all.at[lrow].set(lscore.astype(jnp.int8))
    score_all = score_all.at[rrow].set(rscore.astype(jnp.int8))
    qual_new = qual_all.at[lrow].set(nlq).at[rrow].set(nrq)
    return score_all, qual_new


@functools.partial(jax.jit, static_argnames=(
    "hi", "mod", "lo", "base_score_req", "ratio_num", "ratio_den", "full_bins"))
def fused_vote_kernel(seq_all, qual_all, score_all, rows, shifts, valid,
                      job_len, refbase, *, hi, mod, lo, base_score_req,
                      ratio_num, ratio_den, full_bins=True):
    """Gather job members from device-resident matrices (with per-member
    lenDiff shifts, group.cpp:376-385) and vote. Returns final full-row
    outputs (template row with the voted prefix) + diff/minc.

    rows/shifts int32[J, K] (member work-array rows; shift >= 0),
    valid bool[J, K], job_len int32[J], refbase uint8[J, L].
    """
    J, K = rows.shape
    N, L = seq_all.shape
    l = jnp.arange(L, dtype=I32)[None, None, :]
    idx = jnp.clip(shifts[:, :, None].astype(I32) + l, 0, L - 1)
    flat = rows[:, :, None].astype(I32) * L + idx
    gseq = jnp.take(seq_all.reshape(-1), flat)
    gqual = jnp.take(qual_all.reshape(-1), flat)
    gscore = jnp.take(score_all.reshape(-1), flat).astype(I32)
    pos_valid = jnp.arange(L, dtype=I32)[None, :] < job_len[:, None]
    new_seq, new_qual, diff, minc = _vote_core(
        gseq, gqual, gscore, valid, pos_valid, refbase,
        hi, mod, lo, base_score_req, ratio_num, ratio_den, full_bins)
    # _vote_core already yields template values outside pos_valid and on
    # rollback, so new_seq/new_qual are the complete final rows.
    return new_seq, new_qual, diff, minc


@jax.jit
def duplex_mask_kernel(seq1, qual1, seq2, qual2, n):
    """Vectorized Cluster::duplexMergeBam (cluster.cpp:199-244).

    seq/qual uint8[D, L]; n int32[D] = min(len1,len2) per candidate.
    Returns (new_seq1, new_qual1, new_seq2, new_qual2, mismatches int32[D]).
    The abs(len1-len2) term of `diff` is added host-side.
    """
    D, L = seq1.shape
    j = jnp.arange(L, dtype=I32)[None, :]
    in_range = j < n[:, None]
    mism = in_range & (seq1 != seq2)
    N = jnp.uint8(15)
    z = jnp.uint8(0)
    new_seq1 = jnp.where(mism, N, seq1)
    new_seq2 = jnp.where(mism, N, seq2)
    new_qual1 = jnp.where(mism, z, qual1)
    new_qual2 = jnp.where(mism, z, qual2)
    return new_seq1, new_qual1, new_seq2, new_qual2, mism.sum(axis=1, dtype=I32)
