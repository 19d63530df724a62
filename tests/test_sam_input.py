"""SAM text input: parse-to-RecordBatch fidelity and end-to-end CLI
equivalence with the BAM path (reference accepts "sorted bam/sam" via
htslib auto-detection, main.cpp:31)."""

import os
import subprocess
import sys

import numpy as np

from gencore_tpu.io import bam as bamio
from gencore_tpu.io.sam import SamReader, SamWriter, open_alignment, reg2bin
from tests.datagen import SyntheticBam
from tests.test_engine_equivalence import make_random_workload


def _bam_to_sam(bam_path, sam_path):
    rdr = bamio.BamReader(bam_path)
    batch = rdr.read_all()
    w = SamWriter(sam_path, rdr.header)
    for i in range(batch.n):
        w.write_record(batch.record_bytes(i))
    w.close()


def test_reg2bin_spec_values():
    # SAM spec section 5.3 example function; spot values
    assert reg2bin(0, 1) == 4681
    assert reg2bin(0, 1 << 14) == 4681
    assert reg2bin(1 << 14, (1 << 14) + 1) == 4682
    assert reg2bin(0, (1 << 14) + 1) == 585
    assert reg2bin(-1, 0) == 4680  # unmapped (htslib convention)


def test_sam_roundtrip_records(tmp_path):
    """BAM -> SAM text -> RecordBatch: every field matches the original
    (bin recomputed per htslib; datagen writes bin=0, so compare with the
    recomputed value)."""
    sb = make_random_workload(80, n_fragments=60, umi_mode="duplex",
                              contig_len=200_000, n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    sam_path = str(tmp_path / "in.sam")
    sb.write_bam(bam_path)
    _bam_to_sam(bam_path, sam_path)

    a = bamio.BamReader(bam_path).read_all()
    rdr = SamReader(sam_path)
    b = rdr.read_all()
    assert b.n == a.n
    assert rdr.header.names == bamio.BamReader(bam_path).header.names
    for f in ("tid", "pos", "mtid", "mpos", "isize", "flag", "mapq",
              "l_qseq", "n_cigar"):
        assert (getattr(a, f) == getattr(b, f)).all(), f
    for i in range(a.n):
        assert a.qname(i) == b.qname(i)
        assert (a.cigar(i) == b.cigar(i)).all()
        assert (a.seq_codes(i) == b.seq_codes(i)).all()
        assert (a.qual(i) == b.qual(i)).all()
        assert a.aux(i).tobytes() == b.aux(i).tobytes()


def test_open_alignment_detection(tmp_path):
    sb = SyntheticBam(seed=81, contig_len=50_000)
    sb.add_pair(0, 1000, 1100, umi="ACGT")
    bam_path = str(tmp_path / "in.bam")
    sam_path = str(tmp_path / "in.sam")
    sb.write_bam(bam_path)
    _bam_to_sam(bam_path, sam_path)
    assert isinstance(open_alignment(bam_path), bamio.BamReader)
    assert isinstance(open_alignment(sam_path), SamReader)


def test_cli_sam_input_matches_bam_input(tmp_path):
    """gencore-tpu -i in.sam must give byte-identical consensus output to
    -i in.bam for the same records (bin field normalized: datagen BAMs
    carry bin=0 while SAM input recomputes it, so we patch the BAM's bins
    to the htslib values before comparing)."""
    sb = make_random_workload(82, n_fragments=80, umi_mode="duplex",
                              contig_len=200_000, n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    sam_path = str(tmp_path / "in.sam")
    sb.write_bam(bam_path)
    _bam_to_sam(bam_path, sam_path)

    # patch datagen's bin=0 to the recomputed values so both inputs carry
    # identical records
    from gencore_tpu.utils import cigar as cig
    rdr = bamio.BamReader(bam_path)
    batch = rdr.read_all()
    bodies = []
    for i in range(batch.n):
        body = bytearray(batch.record_bytes(i))
        cigar = batch.cigar(i)
        rlen = cig.ref_len(cigar) if len(cigar) else 1
        b = reg2bin(int(batch.pos[i]), int(batch.pos[i]) + max(rlen, 1))
        body[10:12] = int(b).to_bytes(2, "little")
        bodies.append(bytes(body))
    patched = str(tmp_path / "patched.bam")
    w = bamio.BamWriter(patched, rdr.header)
    for body in bodies:
        w.write_record(body)
    w.close()

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    for mode, inp in (("bam", patched), ("sam", sam_path)):
        ob = str(tmp_path / f"{mode}_out.bam")
        cp = subprocess.run(
            [sys.executable, "-m", "gencore_tpu.cli", "-i", inp, "-o", ob,
             "-j", str(tmp_path / f"{mode}.json"),
             "--html", str(tmp_path / f"{mode}.html")],
            capture_output=True, text=True, env=env, cwd=cwd)
        assert cp.returncode == 0, cp.stderr
        outs[mode] = open(ob, "rb").read()
    assert outs["bam"] == outs["sam"]
