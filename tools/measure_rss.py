"""Peak-RSS demonstration for the bounded-memory streaming mode
(reference comparator: O(window) streaming at
gencore.cpp:205).

Runs the same workload through (a) the in-memory window pipeline and
(b) run_streaming, each in a fresh subprocess, and reports VmHWM from
/proc/self/status plus the decompressed payload size. The streaming
run's peak must stay near-flat as the input grows (it holds one
coordinate window + the per-record index, not the file).

Usage: python tools/measure_rss.py [scale]   (scale x the 40k-fragment
bench workload; default 4)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CHILD = r"""
import os, sys, json, tracemalloc
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
tracemalloc.start()
from gencore_tpu.utils.compile_cache import setup_compile_cache
setup_compile_cache()
from gencore_tpu.options import Options

mode = {mode!r}
bam, fa, out = {bam!r}, {fa!r}, {out!r}
from gencore_tpu.io.fasta import FastaRef
fasta = FastaRef.load(fa)
opt = Options()
opt.input, opt.output, opt.ref_file = bam, out, fa
if mode == "stream":
    from gencore_tpu.parallel.streaming import run_streaming
    run_streaming(opt, bam, out, fasta=fasta)
else:
    from gencore_tpu.io import bam as bamio
    from gencore_tpu.parallel import pipeline as pipe
    from gencore_tpu.parallel.streaming import StreamingBamWriter
    rdr = bamio.BamReader(bam)
    batch = rdr.read_all()
    w = StreamingBamWriter(out, rdr.header)
    pipe.run_pipelined(opt, batch, rdr.header, fasta=fasta, out_writer=w)
    w.close()

kb = None
for line in open("/proc/self/status"):
    if line.startswith("VmHWM:"):
        kb = int(line.split()[1])
# tracemalloc tracks python+numpy allocations but NOT the XLA CPU
# client's buffer pool — on an accelerator host those buffers live in device memory,
# so the traced peak is the honest host-residency number
cur, peak = tracemalloc.get_traced_memory()
print(json.dumps({{"mode": mode, "vmhwm_mb": round(kb / 1024, 1),
                   "py_numpy_peak_mb": round(peak / 1e6, 1)}}))
"""


def run_mode(mode: str, bam: str, fa: str, out: str) -> dict:
    code = CHILD.format(repo=REPO, mode=mode, bam=bam, fa=fa, out=out)
    cp = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=3000)
    if cp.returncode != 0:
        raise RuntimeError(cp.stderr[-2000:])
    return json.loads(cp.stdout.strip().splitlines()[-1])


def main():
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    os.environ["GENCORE_BENCH_FRAGMENTS"] = str(40_000 * scale)
    import bench
    bam, fa = bench.make_workload()
    from gencore_tpu.io import native
    payload_mb = None
    bt = native.bgzf_block_table(bam)
    if bt is not None:
        payload_mb = round(bt[1] / 1e6, 1)
    outs = os.path.join(REPO, "bench_data")
    r_mem = run_mode("memory", bam, fa, os.path.join(outs, "rss_mem.bam"))
    r_str = run_mode("stream", bam, fa, os.path.join(outs, "rss_stream.bam"))
    same = (open(os.path.join(outs, "rss_mem.bam"), "rb").read()
            == open(os.path.join(outs, "rss_stream.bam"), "rb").read())
    print(json.dumps({
        "scale": scale,
        "payload_mb": payload_mb,
        "in_memory_vmhwm_mb": r_mem["vmhwm_mb"],
        "streaming_vmhwm_mb": r_str["vmhwm_mb"],
        "in_memory_py_numpy_peak_mb": r_mem["py_numpy_peak_mb"],
        "streaming_py_numpy_peak_mb": r_str["py_numpy_peak_mb"],
        "outputs_identical": same,
    }))


if __name__ == "__main__":
    main()
