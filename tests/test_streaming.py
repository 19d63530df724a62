"""Bounded-memory streaming path: output bytes must be identical to the
in-memory pipeline, with peak residency bounded by the window size."""

import os

import numpy as np
import pytest

from gencore_tpu.io import bam as bamio
from gencore_tpu.io import native
from gencore_tpu.options import Options
from tests.test_engine_equivalence import make_random_workload

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native core unavailable")


def test_block_table_and_ranged_decode(tmp_path):
    sb = make_random_workload(90, n_fragments=150, umi_mode="plain",
                              contig_len=300_000, n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    table, total = native.bgzf_block_table(bam_path)
    full = native.bgzf_read(bam_path)
    assert total == len(full)
    # decode in two halves and compare
    mid = len(table) // 2
    a = native.bgzf_read_blocks(bam_path, 0, mid,
                                int(table[mid, 1]) if mid < len(table)
                                else total)
    b = native.bgzf_read_blocks(bam_path, mid, len(table),
                                total - int(table[mid, 1]))
    assert (np.concatenate([a, b]) == full).all()


def test_incremental_bgzf_writer(tmp_path):
    rng = np.random.default_rng(0)
    parts = [rng.integers(0, 255, rng.integers(10, 200_000),
                          dtype=np.uint8) for _ in range(5)]
    p1 = str(tmp_path / "inc.bgzf")
    assert native.bgzf_write_ex(p1, parts[0], append=False, write_eof=False)
    for p in parts[1:]:
        assert native.bgzf_write_ex(p1, p, append=True, write_eof=False)
    assert native.bgzf_write_ex(p1, np.zeros(0, dtype=np.uint8),
                                append=True, write_eof=True)
    got = native.bgzf_read(p1)
    assert (got == np.concatenate(parts)).all()


@pytest.mark.parametrize("chunk_bytes", [1 << 14, 64 << 20])
def test_streaming_matches_pipeline(tmp_path, chunk_bytes):
    from gencore_tpu.io.fasta import FastaRef
    from gencore_tpu.parallel import pipeline as pipe
    from gencore_tpu.parallel.streaming import run_streaming

    sb = make_random_workload(91, n_fragments=250, umi_mode="duplex",
                              contig_len=500_000, n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    fa = str(tmp_path / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa)
    ref = FastaRef.load(fa)

    # in-memory pipeline output
    rdr = bamio.BamReader(bam_path)
    tables, pre_m, post_m = pipe.run_pipelined(
        Options(), rdr.read_all(), rdr.header, fasta=ref, n_windows=4)
    mem_out = str(tmp_path / "mem.bam")
    w = bamio.BamWriter(mem_out, rdr.header)
    w.write_payload(pipe.merged_payload(tables))
    w.close()

    stream_out = str(tmp_path / "stream.bam")
    _, pre_s, post_s = run_streaming(Options(), bam_path, stream_out,
                                     fasta=ref, n_windows=4,
                                     chunk_bytes=chunk_bytes)

    a = bamio.BamReader(mem_out).read_all()
    b = bamio.BamReader(stream_out).read_all()
    assert a.n == b.n
    for i in range(a.n):
        assert a.record_bytes(i) == b.record_bytes(i), i
    from tests.test_engine_equivalence import STAT_FIELDS
    for f in STAT_FIELDS:
        assert getattr(pre_m, f) == getattr(pre_s, f), ("pre", f)
        assert getattr(post_m, f) == getattr(post_s, f), ("post", f)


def test_streaming_mid_run_error_raises_not_hangs(tmp_path, monkeypatch):
    """A decode/engine error mid-stream must surface as an exception;
    the 3-thread runner (decoder/dispatch/collector) previously could
    deadlock because the shutdown sentinel was withheld once err was
    recorded while a peer blocked in an untimed get()."""
    import threading

    from gencore_tpu.parallel.streaming import StreamingBam, run_streaming
    sb = make_random_workload(52, n_fragments=300, contig_len=500_000,
                              n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)

    orig = StreamingBam.window_batch
    calls = {"n": 0}

    def boom(self, index, idx):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise IOError("synthetic mid-stream decode failure")
        return orig(self, index, idx)

    monkeypatch.setattr(StreamingBam, "window_batch", boom)

    result = {}

    def run():
        try:
            run_streaming(Options(), bam_path, str(tmp_path / "out.bam"),
                          n_windows=4)
            result["outcome"] = "returned"
        except IOError as e:
            result["outcome"] = f"raised: {e}"
        except BaseException as e:  # noqa: BLE001
            result["outcome"] = f"raised-other: {type(e).__name__}"

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "run_streaming hung on a mid-stream error"
    assert result["outcome"].startswith("raised"), result


def test_piped_stdin_stdout_streams(tmp_path):
    """`-i - -o -` takes the streaming path (GENCORE_STREAM_THRESHOLD=1):
    stdin spools to an unlinked seekable temp file, stdout gets the
    incremental BGZF writes, and the bytes match the file->file streaming
    run exactly. Reference streams pipes directly (gencore.cpp:164-173)."""
    import subprocess
    import sys
    sb = make_random_workload(61, n_fragments=400, contig_len=400_000,
                              n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    fa_path = str(tmp_path / "in.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "GENCORE_STREAM_THRESHOLD": "1",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out_file = str(tmp_path / "out_file.bam")
    pf = subprocess.run(
        [sys.executable, "-m", "gencore_tpu.cli", "-i", bam_path,
         "-r", fa_path, "-o", out_file, "--debug",
         "-j", str(tmp_path / "f.json"), "-h", str(tmp_path / "f.html")],
        capture_output=True, timeout=600, env=env, cwd=str(tmp_path))
    assert pf.returncode == 0, pf.stderr.decode()[-800:]
    assert b"[stage] index" in pf.stderr, \
        "file->file run did not take the streaming path"
    with open(bam_path, "rb") as fin:
        pp = subprocess.run(
            [sys.executable, "-m", "gencore_tpu.cli", "-i", "-", "-o", "-",
             "-r", fa_path, "--debug",
             "-j", str(tmp_path / "p.json"), "-h", str(tmp_path / "p.html")],
            stdin=fin, capture_output=True, timeout=600, env=env,
            cwd=str(tmp_path))
    assert pp.returncode == 0, pp.stderr.decode()[-800:]
    assert b"[stage] index" in pp.stderr, \
        "piped run did not take the streaming path"
    with open(out_file, "rb") as f:
        assert pp.stdout == f.read(), "piped output != file->file output"
    # the stdin spool must not survive the run
    leftovers = [p for p in os.listdir("/tmp") if p.endswith(".spool")]
    assert not leftovers, leftovers
