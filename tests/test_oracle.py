"""Hand-computed scenario tests for the scalar oracle engine.

These pin down the reference semantics (dedup, ref arbitration, duplex,
thresholds, pass-through) that the vectorized engine must then match
exactly (see test_engine_equivalence.py).
"""

import numpy as np

from gencore_tpu.core.oracle import OracleEngine
from gencore_tpu.io import bam
from gencore_tpu.options import Options
from tests.datagen import SyntheticBam


def run_oracle(sb: SyntheticBam, tmp_path, opt: Options | None = None, fasta=True):
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    reader = bam.BamReader(bam_path)
    batch = reader.read_all()
    ref = None
    if fasta:
        fa = str(tmp_path / "ref.fa")
        sb.write_fasta(fa)
        from gencore_tpu.io.fasta import FastaRef
        ref = FastaRef.load(fa)
    opt = opt or Options()
    eng = OracleEngine(opt, reader.header, fasta=ref)
    out = eng.run(batch)
    return eng, out


def test_simple_dedup(tmp_path):
    sb = SyntheticBam(seed=10, contig_len=50_000)
    sb.add_pair(0, 1000, 1100)   # duplicate fragment x2
    sb.add_pair(0, 1000, 1100)
    eng, out = run_oracle(sb, tmp_path)
    # two duplicate pairs collapse into one consensus pair
    assert len(out) == 2
    assert out[0].fr_tag == 2 and out[1].fr_tag == 2
    assert out[0].rr_tag is None
    assert eng.post_stats.sscs_num == 1
    assert eng.pre_stats.read == 4
    # reported post-stats exclude records not yet drained at report time;
    # with <10000 reads no flush tick ever fires, so the reference reports 0
    # here (validated vs the binary — gencore.cpp:21-37 destructor drain)
    assert eng.post_stats.read == 0
    assert eng.pre_stats.molecule == 1
    assert eng.pre_stats.supporting_histogram[2] == 1


def test_error_correction_by_majority_and_ref(tmp_path):
    sb = SyntheticBam(seed=11, contig_len=50_000)
    sb.add_pair(0, 2000, 2150)
    sb.add_pair(0, 2000, 2150)
    sb.add_pair(0, 2000, 2150, n_errors=3)  # erroneous copy
    eng, out = run_oracle(sb, tmp_path)
    assert len(out) == 2
    # consensus sequence equals the true reference at every M position
    for r in out:
        seq = bam.codes_to_seq_str(r.seq)
        assert seq == sb.contigs[0][r.pos:r.pos + 100]
        assert r.fr_tag == 3
    assert eng.post_stats.sscs_num == 1


def test_single_pair_passthrough_consensus(tmp_path):
    # one unique fragment, -s 1: consensus of itself, still emitted with FR=1
    sb = SyntheticBam(seed=12, contig_len=50_000)
    sb.add_pair(0, 3000, 3120)
    eng, out = run_oracle(sb, tmp_path)
    assert len(out) == 2
    assert all(r.fr_tag == 1 for r in out)


def test_supporting_reads_threshold(tmp_path):
    sb = SyntheticBam(seed=13, contig_len=50_000)
    sb.add_pair(0, 1000, 1100)            # singleton -> dropped with -s 2
    sb.add_pair(0, 2000, 2100)
    sb.add_pair(0, 2000, 2100)            # duplicated -> kept
    opt = Options(cluster_size_req=2)
    eng, out = run_oracle(sb, tmp_path, opt)
    assert len(out) == 2
    assert all(r.pos in (2000, 2100) for r in out)
    assert eng.post_stats.sscs_num == 1


def test_mateless_passthrough(tmp_path):
    sb = SyntheticBam(seed=14, contig_len=50_000)
    sb.add_single(0, 5000, flag=0)  # no mate
    eng, out = run_oracle(sb, tmp_path)
    assert len(out) == 1
    assert out[0].fr_tag is None  # passthrough reads get no FR tag
    assert eng.post_stats.molecule == 0


def test_umi_groups_dont_merge(tmp_path):
    sb = SyntheticBam(seed=15, contig_len=50_000)
    sb.add_pair(0, 1000, 1100, umi="AAAA")
    sb.add_pair(0, 1000, 1100, umi="AAAA")
    sb.add_pair(0, 1000, 1100, umi="GGGG")  # different UMI: separate molecule
    eng, out = run_oracle(sb, tmp_path)
    # two consensus pairs (umi_diff(AAAA,GGGG)=4 > threshold 1)
    assert len(out) == 4
    frs = sorted(r.fr_tag for r in out)
    assert frs == [1, 1, 2, 2]
    assert eng.pre_stats.cluster == 1
    assert eng.pre_stats.multi_molecule_cluster == 1


def test_umi_single_mismatch_eof_quirk(tmp_path):
    """Reference quirk (gencore.cpp:409): clusters remaining at EOF are
    grouped with unproperReadsUmiDiffThreshold=0, NOT the CLI
    umi_diff_threshold — so in a small file AAAA/AAAT do NOT merge."""
    sb = SyntheticBam(seed=16, contig_len=50_000)
    sb.add_pair(0, 1000, 1100, umi="AAAA")
    sb.add_pair(0, 1000, 1100, umi="AAAT")  # within umi_diff 1, but EOF path
    eng, out = run_oracle(sb, tmp_path)
    assert len(out) == 4
    assert sorted(r.fr_tag for r in out) == [1, 1, 1, 1]


def test_umi_single_mismatch_merges_via_flush(tmp_path):
    """Same UMIs but with a tick flush (10000 clustered reads) before EOF:
    the flushed cluster uses properReadsUmiDiffThreshold=1 and merges."""
    sb = SyntheticBam(seed=16, contig_len=900_000)
    sb.add_pair(0, 1000, 1100, umi="AAAA")
    sb.add_pair(0, 1000, 1100, umi="AAAT")
    # 4999 trailing fragments -> 9998 reads; with the 2 pairs above the
    # 10000th clustered read lands at a position past the first cluster
    for k in range(4999):
        sb.add_pair(0, 10_000 + 7 * k, 10_100 + 7 * k)
    eng, out = run_oracle(sb, tmp_path)
    first = [r for r in out if r.pos in (1000, 1100)]
    assert len(first) == 2
    assert all(r.fr_tag == 2 for r in first)


def test_duplex_merge(tmp_path):
    sb = SyntheticBam(seed=17, contig_len=50_000)
    sb.add_pair(0, 1000, 1100, umi="AAAA_CCCC")
    sb.add_pair(0, 1000, 1100, umi="AAAA_CCCC")
    sb.add_pair(0, 1000, 1100, umi="CCCC_AAAA")
    sb.add_pair(0, 1000, 1100, umi="CCCC_AAAA")
    eng, out = run_oracle(sb, tmp_path)
    assert eng.post_stats.dcs_num == 1
    assert eng.post_stats.sscs_num == 0
    assert len(out) == 2
    for r in out:
        assert r.fr_tag == 2
        assert r.rr_tag == 2


def test_duplex_disabled(tmp_path):
    sb = SyntheticBam(seed=17, contig_len=50_000)
    sb.add_pair(0, 1000, 1100, umi="AAAA_CCCC")
    sb.add_pair(0, 1000, 1100, umi="CCCC_AAAA")
    opt = Options(disable_duplex=True)
    eng, out = run_oracle(sb, tmp_path, opt)
    assert eng.post_stats.dcs_num == 0
    assert eng.post_stats.sscs_num == 2
    assert len(out) == 4


def test_duplex_only(tmp_path):
    sb = SyntheticBam(seed=18, contig_len=50_000)
    sb.add_pair(0, 1000, 1100, umi="AAAA_CCCC")
    sb.add_pair(0, 2000, 2100, umi="TTTT_GGGG")  # no duplex partner
    opt = Options(duplex_only=True)
    eng, out = run_oracle(sb, tmp_path, opt)
    assert len(out) == 0
    assert eng.post_stats.sscs_num == 0


def test_unmapped_reads_dropped(tmp_path):
    sb = SyntheticBam(seed=19, contig_len=50_000)
    sb.add_pair(0, 1000, 1100)
    sb.add_single(-1, -1, flag=4)  # unmapped, at end of file
    eng, out = run_oracle(sb, tmp_path)
    assert len(out) == 2
    assert eng.pre_stats.read == 3
    assert eng.pre_stats.read_unmapped == 1


def test_secondary_skipped(tmp_path):
    sb = SyntheticBam(seed=20, contig_len=50_000)
    sb.add_pair(0, 1000, 1100)
    sb.add_single(0, 1500, flag=256)  # secondary
    eng, out = run_oracle(sb, tmp_path)
    assert len(out) == 2
    assert eng.pre_stats.read == 3  # secondary still counted in pre-stats


def test_output_sorted(tmp_path):
    sb = SyntheticBam(seed=21, contig_len=200_000, n_contigs=2)
    for pos in (5000, 1000, 9000, 3000):
        sb.add_pair(0, pos, pos + 150)
        sb.add_pair(1, pos + 7, pos + 120)
    eng, out = run_oracle(sb, tmp_path)
    keys = [(r.tid, r.pos) for r in out]
    assert keys == sorted(keys)


def test_overlap_qual_mutation(tmp_path):
    """Overlapping mates with a disagreeing base: quality rewritten to
    max(0, this-pair) in the OUTPUT record (pair.cpp:155-167)."""
    sb = SyntheticBam(seed=22, contig_len=50_000)
    # overlapping pair: fragment 150, read len 100 -> 50bp overlap
    sb.add_pair(0, 1000, 1050, read_len=100, qual=35, qual2=20)
    # introduce one disagreement inside overlap region on the left read
    # records: index 0=left, 1=right after sorting
    eng, out = run_oracle(sb, tmp_path)
    assert len(out) == 2


def test_quit_after_contig(tmp_path):
    sb = SyntheticBam(seed=23, contig_len=50_000, n_contigs=2)
    sb.add_pair(0, 1000, 1100)
    sb.add_pair(1, 1000, 1100)
    opt = Options(max_contig=1)
    eng, out = run_oracle(sb, tmp_path, opt)
    assert all(r.tid == 0 for r in out)
    assert len(out) == 2
