"""Real jax.distributed multi-process run (CPU coordinator + 2 workers):
output and stats must match a single-process run."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

from gencore_tpu.io import bam as bamio
from gencore_tpu.options import Options
from tests.test_engine_equivalence import make_random_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_jax_distributed_two_processes(tmp_path):
    sb = make_random_workload(95, n_fragments=200, umi_mode="duplex",
                              contig_len=500_000, n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    fa = str(tmp_path / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa)
    out_dir = str(tmp_path / "dist")

    port = _free_port()
    nproc = 2
    worker = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        os.environ["JAX_PLATFORMS"] = "cpu"
        from gencore_tpu.options import Options
        from gencore_tpu.parallel import distributed as dist
        pid = int(sys.argv[1])
        dist.init_runtime("127.0.0.1:{port}", {nproc}, pid)
        r = dist.run_process(Options(), {bam_path!r}, {out_dir!r},
                             fasta_path={fa!r}, n_windows=4)
        if pid == 0:
            pre, post = r
            print("POST_SSCS", post.sscs_num, post.dcs_num, pre.read)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for i in range(nproc)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]

    # single-process reference run
    from gencore_tpu.engine import VectorEngine
    reader = bamio.BamReader(bam_path)
    from gencore_tpu.io.fasta import FastaRef
    eng = VectorEngine(Options(), reader.header, fasta=FastaRef.load(fa))
    table = eng.run(reader.read_all())

    dist_out = bamio.BamReader(os.path.join(out_dir, "out.bam")).read_all()
    single = table.encoded_records()
    assert dist_out.n == len(single)
    for i in range(dist_out.n):
        assert dist_out.record_bytes(i) == single[i], i

    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("POST_SSCS")]
    assert line, outs[0][0]
    _, sscs, dcs, reads = line[0].split()
    assert int(sscs) == eng.post_stats.sscs_num
    assert int(dcs) == eng.post_stats.dcs_num
    assert int(reads) == eng.pre_stats.read


@pytest.mark.parametrize("cards,ids", [(["0", "1"], [1]), (["4", "5"], [1]),
                                       (None, None), ([], None)])
def test_runtime_kwargs_pin_local_card(cards, ids):
    """On a GPU host process p of one machine takes the p-th visible card
    (a local device id, whatever the card's physical index)."""
    from gencore_tpu.parallel import distributed as dist
    kw = dist.runtime_kwargs("localhost:1234", 2, 1, cards)
    assert kw["coordinator_address"] == "localhost:1234"
    assert (kw["num_processes"], kw["process_id"]) == (2, 1)
    assert kw.get("local_device_ids") == ids


def test_runtime_kwargs_refuse_process_without_card():
    from gencore_tpu.parallel import distributed as dist
    with pytest.raises(ValueError, match="one process per card"):
        dist.runtime_kwargs("localhost:1234", 4, 2, ["0", "1"])
