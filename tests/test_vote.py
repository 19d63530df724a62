"""The [K, J, L] vote of core/vote.py (vote + epilogue) must exactly match
the reference XLA vote kernels._vote_core (full_bins=False) on randomized
=ACGTN workloads. chip_smoke.py repeats the comparison on the GPU at real
widths."""

import numpy as np
import pytest

from gencore_tpu.core import kernels, vote


def _batch(rng, J, K, L, with_ref=True, neg=False):
    codes = np.array([0, 1, 2, 4, 8, 15], dtype=np.uint8)
    seq = codes[rng.integers(0, len(codes), size=(K, J, L))]
    qual = rng.integers(0, 42, size=(K, J, L)).astype(np.uint8)
    score = rng.integers(-3 if neg else -1, 13, size=(K, J, L)).astype(np.int8)
    valid = rng.random((K, J)) < 0.8
    valid[0] = True
    job_len = rng.integers(1, L + 1, size=J).astype(np.int32)
    refcodes = np.array([0, 1, 2, 4, 8], dtype=np.uint8)
    refbase = refcodes[rng.integers(0, len(refcodes), size=(J, L))] if with_ref \
        else np.zeros((J, L), dtype=np.uint8)
    return seq, qual, score, valid, job_len, refbase


def _check(rng, J, K, L, **batch_kw):
    seq, qual, score, valid, job_len, refbase = _batch(rng, J, K, L,
                                                       **batch_kw)
    kw = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4, ratio_den=5)
    p = list(vote.vote(seq, qual, score, valid, job_len, refbase, **kw))
    # unpack the 4-bit download encoding of the consensus sequence
    from gencore_tpu.engine import _unpack_nibbles
    p[0] = _unpack_nibbles(np.asarray(p[0]))
    p[1] = np.asarray(p[1])
    # reference: [J, K, L] layout, pos_valid mask
    pos_valid = np.arange(L)[None, :] < job_len[:, None]
    x = kernels.consensus_kernel(
        np.transpose(seq, (1, 0, 2)), np.transpose(qual, (1, 0, 2)),
        np.transpose(score, (1, 0, 2)).astype(np.int32),
        valid.T, pos_valid, refbase, full_bins=False, **kw)
    for a, b, name in zip(p, x, ("seq", "qual", "diff", "minc")):
        assert (np.asarray(a) == np.asarray(b)).all(), name


@pytest.mark.parametrize("trial", range(3))
def test_vote_matches_reference(trial):
    rng = np.random.default_rng(trial)
    _check(rng, 16, 3, 128, with_ref=(trial != 1), neg=(trial == 2))


def test_vote_matches_reference_k256():
    """The deepest k-class of the window program."""
    _check(np.random.default_rng(7), 8, 256, 64)
