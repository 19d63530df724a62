"""End-to-end CLI + report tests."""

import json
import re
import os
import subprocess
import sys

from tests.datagen import SyntheticBam


def _make_inputs(tmp_path, with_bed=True):
    sb = SyntheticBam(seed=42, contig_len=100_000)
    for k in range(30):
        pos = 1000 + 310 * k
        sb.add_pair(0, pos, pos + 150, umi="AAAA_CCCC")
        sb.add_pair(0, pos, pos + 150, umi="CCCC_AAAA")
    bam_path = str(tmp_path / "in.bam")
    fa_path = str(tmp_path / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    bed_path = ""
    if with_bed:
        bed_path = str(tmp_path / "t.bed")
        with open(bed_path, "w") as f:
            f.write("chr1\t1000\t20000\tregion1\n")
            f.write("chr1\t30000\t50000\tregion2\n")
    return sb, bam_path, fa_path, bed_path


def test_cli_end_to_end(tmp_path):
    sb, bam_path, fa_path, bed_path = _make_inputs(tmp_path)
    out_bam = str(tmp_path / "out.bam")
    json_path = str(tmp_path / "r.json")
    html_path = str(tmp_path / "r.html")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cp = subprocess.run(
        [sys.executable, "-m", "gencore_tpu.cli",
         "-i", bam_path, "-o", out_bam, "-r", fa_path, "-b", bed_path,
         "-j", json_path, "--html", html_path],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert cp.returncode == 0, cp.stderr
    assert "time used" in cp.stderr
    # output BAM is readable and sorted
    from gencore_tpu.io import bam
    b = bam.BamReader(out_bam).read_all()
    assert b.n == 60  # 30 duplex molecules x 2 reads
    keys = list(zip(b.tid, b.pos))
    assert keys == sorted(keys)
    # JSON has the reference schema. Like the reference's hand-rolled
    # emitter, 0/0 rates print as bare -nan/inf literals (stats.cpp:141-151
    # through a default ostream) — sanitize those before parsing.
    import re
    with open(json_path) as f:
        raw = f.read()
    data = json.loads(re.sub(r"(-?nan|-?inf)", "null", raw))
    assert "summary" in data
    assert data["summary"]["duplex_consensus_sequence"] == 30
    assert "before_processing" in data and "after_processing" in data
    assert "duplication_level_histogram" in data["before_processing"]
    assert len(data["before_processing"]["duplication_level_histogram"]) == 99
    assert "coverage" in data["before_processing"]
    assert "coverage_bed" in data["before_processing"]
    assert "command" in data
    # HTML exists with the main sections
    html = open(html_path).read()
    for section in ("Summary", "Duplication histogram", "Coverage statistics in genome scale",
                    "Coverage statistics in BED", "plotly"):
        assert section in html


def test_cli_unit_test_subcommand():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cp = subprocess.run([sys.executable, "-m", "gencore_tpu.cli", "test"],
                        capture_output=True, text=True, env=env,
                        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert cp.returncode == 0
    assert "PASSED" in cp.stderr


def test_cli_version():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cp = subprocess.run([sys.executable, "-m", "gencore_tpu.cli", "--version"],
                        capture_output=True, text=True, env=env,
                        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert cp.returncode == 0
    assert "gencore-tpu" in cp.stderr


def test_oracle_cli_matches_vector_cli(tmp_path):
    sb, bam_path, fa_path, bed_path = _make_inputs(tmp_path, with_bed=False)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    for mode, extra in (("vec", []), ("orc", ["--oracle"])):
        ob = str(tmp_path / f"{mode}.bam")
        jp = str(tmp_path / f"{mode}.json")
        hp = str(tmp_path / f"{mode}.html")
        cp = subprocess.run(
            [sys.executable, "-m", "gencore_tpu.cli", "-i", bam_path, "-o", ob,
             "-r", fa_path, "-j", jp, "--html", hp] + extra,
            capture_output=True, text=True, env=env, cwd=cwd)
        assert cp.returncode == 0, cp.stderr
        outs[mode] = (open(ob, "rb").read(),
                      json.loads(re.sub(r"(-?nan|-?inf)", "null", open(jp).read())))
    # identical output BAM bytes and JSON stats
    assert outs["vec"][0] == outs["orc"][0]
    assert outs["vec"][1]["summary"] == outs["orc"][1]["summary"]
    assert outs["vec"][1]["before_processing"] == outs["orc"][1]["before_processing"]
    assert outs["vec"][1]["after_processing"] == outs["orc"][1]["after_processing"]


def test_cli_sharded_matches_single(tmp_path):
    sb, bam_path, fa_path, _ = _make_inputs(tmp_path, with_bed=False)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    for mode, extra in (("one", []), ("sh", ["--shards", "3"])):
        ob = str(tmp_path / f"{mode}.bam")
        cp = subprocess.run(
            [sys.executable, "-m", "gencore_tpu.cli", "-i", bam_path, "-o", ob,
             "-r", fa_path, "-j", str(tmp_path / f"{mode}.json"),
             "--html", str(tmp_path / f"{mode}.html")] + extra,
            capture_output=True, text=True, env=env, cwd=cwd)
        assert cp.returncode == 0, cp.stderr
        outs[mode] = (open(ob, "rb").read(),
                      json.loads(re.sub(r"(-?nan|-?inf)", "null",
                                 open(tmp_path / f"{mode}.json").read())))
    assert outs["one"][0] == outs["sh"][0]
    assert outs["one"][1]["before_processing"] == outs["sh"][1]["before_processing"]
    assert outs["one"][1]["after_processing"] == outs["sh"][1]["after_processing"]


def test_cli_pipelined_matches_single(tmp_path):
    """--windows N (overlapped window pipeline) produces a byte-identical
    output BAM and identical JSON stats vs a single-shot run."""
    sb, bam_path, fa_path, _ = _make_inputs(tmp_path, with_bed=False)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    for mode, extra in (("one", ["--windows", "1"]), ("pw", ["--windows", "4"])):
        ob = str(tmp_path / f"{mode}.bam")
        cp = subprocess.run(
            [sys.executable, "-m", "gencore_tpu.cli", "-i", bam_path, "-o", ob,
             "-r", fa_path, "-j", str(tmp_path / f"{mode}.json"),
             "--html", str(tmp_path / f"{mode}.html")] + extra,
            capture_output=True, text=True, env=env, cwd=cwd)
        assert cp.returncode == 0, cp.stderr
        outs[mode] = (open(ob, "rb").read(),
                      json.loads(re.sub(r"(-?nan|-?inf)", "null",
                                 open(tmp_path / f"{mode}.json").read())))
    assert outs["one"][0] == outs["pw"][0]
    assert outs["one"][1]["before_processing"] == outs["pw"][1]["before_processing"]
    assert outs["one"][1]["after_processing"] == outs["pw"][1]["after_processing"]
