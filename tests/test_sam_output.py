"""SAM text output parity checks."""

import os
import subprocess
import sys

from tests.datagen import SyntheticBam


def test_sam_output(tmp_path):
    sb = SyntheticBam(seed=60, contig_len=50_000)
    sb.add_pair(0, 1000, 1100, umi="ACGT")
    sb.add_pair(0, 1000, 1100, umi="ACGT")
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    out_sam = str(tmp_path / "out.sam")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cp = subprocess.run(
        [sys.executable, "-m", "gencore_tpu.cli", "-i", bam_path, "-o", out_sam,
         "-j", str(tmp_path / "r.json"), "--html", str(tmp_path / "r.html")],
        capture_output=True, text=True, env=env, cwd=cwd)
    assert cp.returncode == 0, cp.stderr
    lines = open(out_sam).read().strip().split("\n")
    hdr = [l for l in lines if l.startswith("@")]
    recs = [l for l in lines if not l.startswith("@")]
    assert any(l.startswith("@SQ") for l in hdr)
    assert len(recs) == 2
    f = recs[0].split("\t")
    assert f[2] == "chr1"
    assert f[3] == "1001"  # 1-based
    assert f[5] == "100M"
    assert f[6] == "="
    assert any(t == "FR:i:2" for t in f[11:])
    # seq matches the synthetic reference
    assert f[9] == sb.contigs[0][1000:1100]


def test_stdout_is_bam(tmp_path):
    """`-o -` writes BAM (BGZF) to stdout — the reference only opens text
    mode for names ending in "sam" (gencore.cpp:170-173). The streamed
    records must equal a file-output run byte for byte."""
    sb = SyntheticBam(seed=62, contig_len=50_000)
    for k in range(8):
        sb.add_pair(0, 1000 + 300 * k, 1120 + 300 * k, umi="ACGT")
        sb.add_pair(0, 1000 + 300 * k, 1120 + 300 * k, umi="ACGT")
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cp = subprocess.run(
        [sys.executable, "-m", "gencore_tpu.cli", "-i", bam_path, "-o", "-",
         "-j", str(tmp_path / "r.json"), "--html", str(tmp_path / "r.html")],
        capture_output=True, env=env, cwd=cwd)
    assert cp.returncode == 0, cp.stderr.decode()
    assert cp.stdout[:2] == b"\x1f\x8b", "stdout must be BGZF, not SAM text"
    out_bam = str(tmp_path / "out.bam")
    cp2 = subprocess.run(
        [sys.executable, "-m", "gencore_tpu.cli", "-i", bam_path, "-o", out_bam,
         "-j", str(tmp_path / "r2.json"), "--html", str(tmp_path / "r2.html")],
        capture_output=True, env=env, cwd=cwd)
    assert cp2.returncode == 0, cp2.stderr.decode()
    stdout_path = str(tmp_path / "cap.bam")
    with open(stdout_path, "wb") as f:
        f.write(cp.stdout)
    from gencore_tpu.io import bam
    a = bam.BamReader(stdout_path)
    b = bam.BamReader(out_bam)
    ba, bb = a.read_all(), b.read_all()
    assert ba.n == bb.n and ba.n > 0
    recs_a = [ba.data[ba.off[i]:ba.end[i]].tobytes() for i in range(ba.n)]
    recs_b = [bb.data[bb.off[i]:bb.end[i]].tobytes() for i in range(bb.n)]
    assert recs_a == recs_b


def test_stdin_to_stdout_pipe(tmp_path):
    """The reference's default invocation is a pure pipe: BAM on stdin,
    BAM on stdout (gencore.cpp:164-173). stdin spools in bounded chunks."""
    sb = SyntheticBam(seed=63, contig_len=50_000)
    for k in range(5):
        sb.add_pair(0, 1000 + 400 * k, 1150 + 400 * k, umi="ACGT")
        sb.add_pair(0, 1000 + 400 * k, 1150 + 400 * k, umi="ACGT")
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(bam_path, "rb") as fin:
        cp = subprocess.run(
            [sys.executable, "-m", "gencore_tpu.cli",
             "-j", str(tmp_path / "r.json"), "--html", str(tmp_path / "r.html")],
            stdin=fin, capture_output=True, env=env, cwd=cwd)
    assert cp.returncode == 0, cp.stderr.decode()
    assert cp.stdout[:2] == b"\x1f\x8b"
    out = str(tmp_path / "out.bam")
    with open(out, "wb") as f:
        f.write(cp.stdout)
    from gencore_tpu.io import bam
    b = bam.BamReader(out).read_all()
    assert b.n == 10


def test_unsorted_input_fatal(tmp_path):
    sb = SyntheticBam(seed=61, contig_len=50_000)
    sb.add_pair(0, 2000, 2100)
    sb.add_pair(0, 1000, 1100)
    # force unsorted by bypassing the sort in write_bam
    from gencore_tpu.io.bam import BamWriter
    w = BamWriter(str(tmp_path / "u.bam"), sb.header)
    for _, _, _, body in sb.records:  # insertion order: 2000 first
        w.write_record(body)
    w.close()
    from gencore_tpu.engine import VectorEngine
    from gencore_tpu.io import bam
    from gencore_tpu.options import Options
    r = bam.BamReader(str(tmp_path / "u.bam"))
    eng = VectorEngine(Options(), r.header)
    import pytest
    with pytest.raises(ValueError, match="unsorted"):
        eng.run(r.read_all())
