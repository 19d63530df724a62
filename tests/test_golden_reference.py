"""Golden-output equivalence vs the ACTUAL reference binary.

Compiles OpenGene/gencore from /root/reference/src against the htslib API
shim (native/htsshim) and asserts byte-identical output BAM records, order,
and JSON reports. This anchors the whole equivalence pyramid to the real
binary rather than the self-authored oracle (tools/golden_compare.py runs
the wider sweep; this test keeps one fast case in CI).
"""

import os
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from tests.datagen import SyntheticBam  # noqa: E402


def _ref_available():
    import golden_compare as gc
    try:
        gc.build_ref()
    except Exception:
        return False
    return os.path.exists(gc.REF_BIN)


@pytest.mark.skipif(not _ref_available(),
                    reason="reference binary not buildable in this image")
def test_golden_duplex_umi_small():
    import golden_compare as gc
    rng = np.random.default_rng(99)
    sb = SyntheticBam(seed=99, contig_len=150_000, n_contigs=2)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT"]
    for _ in range(150):
        tid = int(rng.integers(0, 2))
        pos1 = int(rng.integers(100, 149_000))
        pos2 = pos1 + int(rng.integers(10, 180))
        a, b = rng.choice(umis, size=2, replace=False)
        for _ in range(1 + int(rng.poisson(2))):
            sb.add_pair(tid, pos1, pos2, read_len=100, umi=f"{a}_{b}",
                        n_errors=int(rng.integers(0, 3)),
                        qual=int(rng.choice([12, 22, 35])))
    with tempfile.TemporaryDirectory() as wd:
        fails = gc.run_case("golden_small", sb, ["-u", "UMI"], wd)
        assert not fails, "\n".join(fails)


@pytest.mark.skipif(not _ref_available(),
                    reason="reference binary not buildable in this image")
def test_golden_contig_mismatch_warnings():
    """A FASTA with one truncated contig and one missing contig: both
    tools must emit the reference's getData stderr warnings
    (reference.cpp:51-65) with identical cadence — 'not found' latches
    one-shot, the length mismatch prints per failed uncached call (its
    latch is never set in the reference) — and still produce identical
    output records (consensus falls back to majority arbitration)."""
    import subprocess
    import golden_compare as gc
    rng = np.random.default_rng(41)
    sb = SyntheticBam(seed=41, contig_len=50_000, n_contigs=2)
    for tid in (0, 1):
        for _ in range(60):
            pos1 = int(rng.integers(42_000, 49_000))
            pos2 = pos1 + int(rng.integers(10, 120))
            for _ in range(2 + int(rng.poisson(1))):
                sb.add_pair(tid, pos1, pos2, read_len=100,
                            n_errors=int(rng.integers(0, 3)),
                            qual=int(rng.choice([14, 35])))
    with tempfile.TemporaryDirectory() as wd:
        bam_in = os.path.join(wd, "warn.bam")
        fa = os.path.join(wd, "warn.fa")
        sb.write_bam(bam_in)
        # chr1 truncated to 40k (header says 50k -> length warning for the
        # 42k+ reads); chr2 absent entirely (missing warning)
        with open(fa, "w") as f:
            f.write(">chr1\n")
            c = sb.contigs[0][:40_000]
            for i in range(0, len(c), 70):
                f.write(c[i:i + 70] + "\n")
        ref_out = os.path.join(wd, "warn.ref.bam")
        eng_out = os.path.join(wd, "warn.eng.bam")
        rp = subprocess.run(
            [gc.REF_BIN, "-i", bam_in, "-r", fa, "-o", ref_out],
            capture_output=True, timeout=600)
        assert rp.returncode == 0, rp.stderr.decode()[-400:]
        tp = subprocess.run(
            [sys.executable, "-c",
             "import sys; from gencore_tpu import cli; "
             "sys.exit(cli.main(sys.argv[1:]))",
             "-i", bam_in, "-r", fa, "-o", eng_out],
            capture_output=True, timeout=600,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert tp.returncode == 0, tp.stderr.decode()[-400:]
        from collections import Counter
        ref_warn = Counter(l for l in rp.stderr.decode().splitlines()
                           if "please make sure your reference" in l)
        eng_warn = Counter(l for l in tp.stderr.decode().splitlines()
                           if "please make sure your reference" in l)
        assert ref_warn == eng_warn
        assert sum("not found" in k for k in ref_warn.elements()) == 1
        _, rrecs = gc.decode_records(ref_out)
        _, trecs = gc.decode_records(eng_out)
        assert sorted(rrecs) == sorted(trecs)


@pytest.mark.skipif(not _ref_available(),
                    reason="reference binary not buildable in this image")
def test_golden_watermark_tick_crossing():
    """>10000 clustered reads so the reference's flush tick fires: checks
    the watermark-gated post-stats quirk (post-report destructor drain)."""
    import golden_compare as gc
    rng = np.random.default_rng(7)
    sb = SyntheticBam(seed=7, contig_len=600_000, n_contigs=1)
    for _ in range(3000):
        pos1 = int(rng.integers(100, 590_000))
        pos2 = pos1 + int(rng.integers(10, 150))
        for _ in range(1 + int(rng.poisson(1))):
            sb.add_pair(0, pos1, pos2, read_len=100,
                        n_errors=int(rng.integers(0, 2)),
                        qual=int(rng.choice([18, 35])))
    with tempfile.TemporaryDirectory() as wd:
        fails = gc.run_case("golden_tick", sb, [], wd)
        assert not fails, "\n".join(fails)


@pytest.mark.skipif(not _ref_available(),
                    reason="reference binary not buildable in this image")
def test_golden_duplex_merge_byte_walk():
    """Duplex-heavy clusters with adjacent consensus mismatches: exercises
    duplexMergeBam's packed-byte walk quirk (cluster.cpp:199-244 — the
    extra i++ on byte equality skips positions after a masked even-position
    mismatch whose low nibbles agree, undercounting d). A strict per-base
    count drops duplexes the reference keeps; outputs must stay
    byte-identical as a multiset and JSON equal."""
    import subprocess
    import golden_compare as gc
    rng = np.random.default_rng(77)
    sb = SyntheticBam(seed=77, contig_len=900_000, n_contigs=2)
    umis = ["ACGT", "TGCA", "GGCC", "AATT", "CGCG"]
    for locus in range(120):
        tid = locus % 2
        pos1 = 1000 + 7000 * (locus // 2) + int(rng.integers(0, 50))
        pos2 = pos1 + 170
        for _ in range(int(rng.integers(4, 40))):
            a, b = rng.choice(umis, size=2, replace=False)
            if rng.random() < 0.5:
                a, b = b, a
            n_err = int(rng.random() < 0.4) * int(rng.integers(1, 3))
            sb.add_pair(tid, pos1, pos2, read_len=120, umi=f"{a}_{b}",
                        n_errors=n_err, qual=int(rng.choice([12, 25, 35])))
    with tempfile.TemporaryDirectory() as wd:
        fails = gc.run_case("golden_duplex_walk", sb, ["-u", "UMI"], wd)
        assert not fails, "\n".join(fails)
