"""Native I/O core tests: identical results to the pure-Python codec."""

import os

import numpy as np
import pytest

from gencore_tpu.io import bgzf, native
from tests.datagen import SyntheticBam

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native lib unavailable")


def test_native_bgzf_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, size=1_000_000, dtype=np.uint8)
    p = str(tmp_path / "x.bgzf")
    assert native.bgzf_write(p, payload)
    back = native.bgzf_read(p)
    assert back is not None and (back == payload).all()
    # python reader can read native-written file and vice versa
    py = np.frombuffer(bgzf.decompress_file(p), dtype=np.uint8)
    assert (py == payload).all()
    p2 = str(tmp_path / "y.bgzf")
    bgzf.compress_to_file(p2, payload.tobytes())
    back2 = native.bgzf_read(p2)
    assert (back2 == payload).all()


def test_native_reader_matches_python(tmp_path):
    sb = SyntheticBam(seed=9, contig_len=100_000)
    for k in range(50):
        sb.add_pair(0, 1000 + 101 * k, 1100 + 101 * k, umi="ACGT")
    path = str(tmp_path / "t.bam")
    sb.write_bam(path)

    from gencore_tpu.io import bam
    r_native = bam.BamReader(path)
    assert r_native._payload_arr is not None, "native path not taken"
    b1 = r_native.read_all()

    os.environ["GENCORE_NO_NATIVE"] = "1"
    try:
        native._lib = None
        native._tried = True  # force fallback
        r_py = bam.BamReader(path)
        b2 = r_py.read_all()
    finally:
        del os.environ["GENCORE_NO_NATIVE"]
        native._tried = False

    assert b1.n == b2.n
    for i in range(b1.n):
        assert b1.record_bytes(i) == b2.record_bytes(i)
    assert (b1.tid == b2.tid).all()
    assert (b1.pos == b2.pos).all()
    assert (b1.l_qseq == b2.l_qseq).all()


def test_tsan_native_core():
    """The threaded native core must be data-race-free: build the TSan
    exerciser and run it (SURVEY.md §5 race-detection row). Skips when
    g++/libtsan is unavailable."""
    import subprocess
    native_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    b = subprocess.run(["make", "-C", native_dir, "tsan"],
                       capture_output=True, text=True, timeout=180)
    if b.returncode != 0:
        pytest.skip(f"tsan build unavailable: {b.stderr[-200:]}")
    r = subprocess.run([os.path.join(native_dir, "test_gcio_tsan"), "/tmp"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "WARNING: ThreadSanitizer" not in r.stderr


def test_zlib_codec_round_trips(tmp_path):
    """The core's zlib BGZF round-trips and interoperates with Python's
    gzip in both directions (a BGZF file is a series of gzip members)."""
    import gzip
    payload = np.random.default_rng(0).integers(
        0, 4, size=300_000).astype(np.uint8)
    native_file = str(tmp_path / "native.bgz")
    assert native.bgzf_write(native_file, payload)
    assert (native.bgzf_read(native_file) == payload).all()
    with open(native_file, "rb") as f:
        assert gzip.decompress(f.read()) == payload.tobytes()
    py_file = str(tmp_path / "py.bgz")
    bgzf.compress_to_file(py_file, payload.tobytes())
    assert (native.bgzf_read(py_file) == payload).all()


def test_mi_flags_matches_numpy_predicate():
    """gc_mi_flags must reproduce the engine's numpy candidate predicate
    ('M','I','Z' inside [aux_off, end-4)) byte for byte."""
    rng = np.random.default_rng(17)
    n = 3000
    parts, aux_off, end = [], np.zeros(n, np.int64), np.zeros(n, np.int64)
    p = 0
    for i in range(n):
        body = rng.integers(0, 256, int(rng.integers(36, 80)), dtype=np.uint8)
        if rng.random() < 0.25:
            k = int(rng.integers(0, len(body) - 4))
            body[k:k + 3] = [ord("M"), ord("I"), ord("Z")]
        aux_off[i] = p + 8
        end[i] = p + len(body)
        parts.append(body)
        p += len(body)
    d = np.concatenate(parts)
    f = native.mi_flags(d, aux_off, end)
    assert f is not None
    ref = np.zeros(n, dtype=np.uint8)
    cand = np.nonzero(d[:-3] == ord("M"))[0]
    pp = cand[(d[cand + 1] == ord("I")) & (d[cand + 2] == ord("Z"))]
    for q in pp:
        i = int(np.searchsorted(end, q, side="right"))
        if i < n and aux_off[i] <= q and q + 3 < end[i]:
            ref[i] = 1
    assert (f == ref).all()


def test_nib_seen_matches_numpy_scan():
    """gc_nib_seen must agree with the full-bins numpy scan: byte values
    within lens/2 full bytes + odd-tail high nibbles."""
    rng = np.random.default_rng(23)
    n, pw = 500, 40
    packed = rng.integers(0, 256, (n, pw), dtype=np.uint8)
    lens = rng.integers(0, 2 * pw + 1, n).astype(np.int32)
    got = native.nib_seen(packed, lens)
    assert got is not None
    s256 = np.zeros(256, dtype=bool)
    s16 = np.zeros(16, dtype=bool)
    for i in range(n):
        nb = int(lens[i]) // 2
        s256[packed[i, :nb]] = True
        if lens[i] % 2:
            s16[packed[i, nb] >> 4] = True
    assert (got[0].astype(bool) == s256).all()
    assert (got[1].astype(bool) == s16).all()


def test_bam_index_matches_recordbatch_columns():
    """gc_bam_index's fused columns + NM must equal the RecordBatch
    gathers + the engine's _extract_nm values."""
    from tests.test_engine_equivalence import make_random_workload
    from gencore_tpu.io import bam as bamio
    from gencore_tpu.engine import VectorEngine
    from gencore_tpu.options import Options
    import tempfile, os
    sb = make_random_workload(43, n_fragments=400, contig_len=200_000,
                              n_contigs=2)
    with tempfile.TemporaryDirectory() as wd:
        p = os.path.join(wd, "x.bam")
        sb.write_bam(p)
        payload = native.bgzf_read(p)
    # find body start by parsing the header
    import struct
    l_text = struct.unpack("<i", payload[4:8].tobytes())[0]
    q = 8 + l_text
    n_ref = struct.unpack("<i", payload[q:q + 4].tobytes())[0]
    q += 4
    for _ in range(n_ref):
        ln = struct.unpack("<i", payload[q:q + 4].tobytes())[0]
        q += 4 + ln + 4
    bi = native.bam_index(payload[q:], 0)
    assert bi is not None
    bounds, cols = bi
    n = len(bounds) - 1
    off = bounds[:n]
    end = np.empty(n, dtype=np.int64)
    end[:-1] = bounds[1:n] - 4
    end[-1] = bounds[-1]
    batch = bamio.RecordBatch(payload[q:], off, end)
    assert batch.n == n and n > 0
    for k in ("tid", "pos", "mtid", "mpos", "isize", "flag", "l_qseq"):
        assert (cols[k] == getattr(batch, k).astype(np.int64)).all(), k
    eng = VectorEngine(Options(), sb.header, fasta=None)
    nm, _ = eng._extract_nm(batch, batch.n)
    assert (cols["nm"].astype(np.int64) == nm).all()
