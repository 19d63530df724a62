"""Engine on its accelerator path (the [K, J, L] vote of core/vote.py,
bucketed shapes, sparse downloads, device refbase, the fused window
program), run here on the CPU, must match the oracle."""

import pytest

from gencore_tpu.engine import VectorEngine
from tests.test_engine_equivalence import (assert_equivalent,
                                           make_random_workload, run_both)


@pytest.fixture
def accelerator_path(monkeypatch):
    monkeypatch.setattr(VectorEngine, "accelerator_path", True)


def test_pallas_engine_equivalence(tmp_path, accelerator_path):
    sb = make_random_workload(90, n_fragments=60, umi_mode="duplex",
                              contig_len=300_000, n_contigs=1)
    o, v = run_both(sb, tmp_path)
    assert_equivalent(o, v)


def test_pallas_engine_raw_quals(tmp_path, accelerator_path):
    """>15 distinct qual values: qual uploads fall back to raw mode and
    the vote-output nibble packing disables itself (no candidate table);
    output must still match the oracle."""
    import numpy as np
    from tests.datagen import SyntheticBam
    sb = SyntheticBam(seed=93, contig_len=200_000)
    rng = np.random.default_rng(94)
    for k in range(40):
        pos = 1000 + 400 * k
        for _ in range(int(rng.integers(1, 4))):
            qual = rng.integers(5, 41, size=100).astype(np.uint8)
            seq1, cg1 = sb.read_seq(0, pos, 100,
                                    n_errors=int(rng.random() < 0.4))
            seq2, cg2 = sb.read_seq(0, pos + 150, 100)
            qname = sb._qname("ACGT_TTAA")
            sb._add(0, pos, qname, 99, cg1, 0, pos + 150, 250, seq1, qual, 0)
            sb._add(0, pos + 150, qname, 147, cg2, 0, pos, -250, seq2,
                    rng.integers(5, 41, size=100).astype(np.uint8), 0)
    o, v = run_both(sb, tmp_path)
    assert_equivalent(o, v)


def test_pallas_engine_sparse_overflow(tmp_path, accelerator_path):
    """Jobs with more seq edits than the sparse wire cap (SPARSE_DIFFS)
    must round-trip through the dense overflow pull and still match the
    oracle: deep clusters where the template read carries many errors, so
    the consensus corrects >8 positions."""
    import numpy as np
    from tests.datagen import SyntheticBam
    sb = SyntheticBam(seed=95, contig_len=200_000)
    rng = np.random.default_rng(96)
    for k in range(20):
        pos = 1000 + 500 * k
        for d in range(4):
            # first duplicate (the likely template) gets a heavily
            # corrupted low-qual read; the rest are clean high-qual
            n_err = 14 if d == 0 else 0
            qual = 15 if d == 0 else 36
            sb.add_pair(0, pos, pos + 150, read_len=100, umi="AACC_GGTT",
                        n_errors=n_err, qual=qual)
    o, v = run_both(sb, tmp_path)
    assert_equivalent(o, v)


def test_pallas_engine_shifted_members(tmp_path, accelerator_path):
    """Right-mode jobs with lenDiff shifts route through the host re-gather
    + second vote call."""
    from tests.datagen import SyntheticBam
    sb = SyntheticBam(seed=91, contig_len=100_000)
    # mixed-length right reads ending at the same ref pos (right-aligned
    # containment): lengths differ -> lenDiff shifts
    for k in range(10):
        pos1 = 1000 + 400 * k
        end2 = pos1 + 240
        sb.add_pair(0, pos1, end2 - 100, read_len=100)
        # second pair: shorter right read at a later pos, same right end
        qname = sb._qname(None)
        seq1, cg1 = sb.read_seq(0, pos1, 100)
        seq2, cg2 = sb.read_seq(0, end2 - 80, 80)
        sb._add(0, pos1, qname, 99, cg1, 0, end2 - 80, 240, seq1, 35, 0)
        sb._add(0, end2 - 80, qname, 147, cg2, 0, pos1, -240, seq2, 35, 0)
    o, v = run_both(sb, tmp_path)
    assert_equivalent(o, v)
