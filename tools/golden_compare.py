"""Golden-output validation: my engine vs the ACTUAL reference binary.

Builds native/htsshim/build/gencore_ref (the real OpenGene/gencore compiled
against the htslib API shim), runs both tools over synthetic workloads,
and compares:
  * output BAM record bodies (decoded; record-equivalence — multiset equal
    AND identical bamComp key order; the only permitted order difference is
    among records with fully equal keys, where the reference tie-breaks on
    heap pointer, gencore.h:35-41)
  * gencore.json bytes (after normalizing the `command` echo)

Usage: python tools/golden_compare.py [--quick]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BIN = os.path.join(REPO, "native", "htsshim", "build", "gencore_ref")


def build_ref():
    """Bring the reference binary up to date (make is incremental). Every
    parallel test worker calls this while it collects, so one worker
    builds at a time: concurrent makes rewrite the same objects and binary,
    and one worker's failed link can delete the binary another worker has
    just found."""
    import fcntl
    shim = os.path.join(REPO, "native", "htsshim")
    os.makedirs(os.path.join(shim, "build"), exist_ok=True)
    with open(os.path.join(shim, "build", ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", shim], check=True, capture_output=True)


def decode_records(path):
    from gencore_tpu.io import bam as bamio
    r = bamio.BamReader(path)
    b = r.read_all()
    out = []
    for i in range(b.n):
        body = b.data[b.off[i]:b.end[i]].tobytes()
        out.append(body)
    return b, out


def record_keys(batch):
    import numpy as np
    tids = batch.tid.astype(np.int64)
    return list(zip(
        [int(x) for x in np.where(tids >= 0, tids, 0x7FFFFFFF)],
        [int(x) for x in batch.pos], [int(x) for x in batch.mtid],
        [int(x) for x in batch.mpos], [int(x) for x in batch.isize]))


def normalize_html(path):
    """HTML byte-comparison surface: version cell, command echo and
    timestamps normalized (everything else must match byte-for-byte)."""
    import re
    with open(path, "rb") as f:
        s = f.read().decode("latin-1")
    s = re.sub(r"gencore report at [0-9: -]+ </title>",
               "gencore report at T </title>", s)
    s = re.sub(r"<p>.*?</p>", "<p></p>", s, flags=re.S)
    s = re.sub(r"gencore(-tpu)? v?[0-9.]+, at [0-9: -]+ </div>",
               "gencore V, at T </div>", s)
    s = re.sub(r"<tr><td class='col1'>gencore(-tpu)? version:</td>"
               r"<td class='col2'>[^<]*",
               "<tr><td class='col1'>gencore version:</td>"
               "<td class='col2'>V", s)
    return s


def normalize_json(path):
    """Byte comparison surface: raw text with the command echo blanked
    (the reference emits non-JSON literals like -nan, so no parsing)."""
    import re
    with open(path, "rb") as f:
        d = f.read().decode("latin-1")
    return re.sub(r'"command": ".*"', '"command": ""', d)


def run_case(name, sb, args, workdir, report=True):
    """Returns list of failure strings (empty = pass)."""
    from gencore_tpu import cli as engcli

    bam_in = os.path.join(workdir, f"{name}.bam")
    fa = os.path.join(workdir, f"{name}.fa")
    sb.write_bam(bam_in)
    sb.write_fasta(fa)
    if "-b" in args:
        # capture-region BED over the first contig
        bed_path = os.path.join(workdir, f"{name}.bed")
        with open(bed_path, "w") as f:
            for k in range(12):
                f.write(f"chr1\t{1000 + 15000 * k}\t{6000 + 15000 * k}\tR{k}\n")
        args = [bed_path if a == "__BED__" else a for a in args]

    ref_out = os.path.join(workdir, f"{name}.ref.bam")
    eng_out = os.path.join(workdir, f"{name}.eng.bam")
    ref_json = os.path.join(workdir, f"{name}.ref.json")
    eng_json = os.path.join(workdir, f"{name}.eng.json")
    ref_html = os.path.join(workdir, f"{name}.ref.html")
    eng_html = os.path.join(workdir, f"{name}.eng.html")

    base = ["-i", bam_in, "-r", fa] + args
    rp = subprocess.run(
        [REF_BIN] + base + ["-o", ref_out, "-j", ref_json, "--html", ref_html],
        capture_output=True, timeout=600)
    if rp.returncode != 0:
        return [f"{name}: reference binary failed rc={rp.returncode}: "
                f"{rp.stderr.decode()[-400:]}"]
    rc = engcli.main(base + ["-o", eng_out, "-j", eng_json, "--html", eng_html])
    if rc != 0:
        return [f"{name}: engine cli failed rc={rc}"]

    fails = []
    rb, rrecs = decode_records(ref_out)
    tb, trecs = decode_records(eng_out)
    if sorted(rrecs) != sorted(trecs):
        rset, tset = set(rrecs), set(trecs)
        only_ref = [r for r in rrecs if r not in tset][:3]
        only_eng = [t for t in trecs if t not in rset][:3]
        fails.append(
            f"{name}: BAM records differ: ref={len(rrecs)} engine={len(trecs)}, "
            f"ref-only={len([r for r in rrecs if r not in tset])} "
            f"engine-only={len([t for t in trecs if t not in rset])}")
        for r in only_ref:
            fails.append(f"  ref-only: {r[:60].hex()}")
        for t in only_eng:
            fails.append(f"  engine-only: {t[:60].hex()}")
    elif record_keys(rb) != record_keys(tb):
        fails.append(f"{name}: record ORDER differs (same multiset)")
    if report and normalize_json(ref_json) != normalize_json(eng_json):
        fails.append(f"{name}: JSON reports differ")
    if report and normalize_html(ref_html) != normalize_html(eng_html):
        fails.append(f"{name}: HTML reports differ")
    return fails


def make_cases(quick=False):
    import numpy as np
    from datagen import SyntheticBam

    cases = []

    def wide_workload(seed, n_frags, dupmean=3, clen=400_000):
        rng = np.random.default_rng(seed)
        sb = SyntheticBam(seed=seed, contig_len=clen, n_contigs=2)
        umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA", "GATC", "CTAG"]
        for _ in range(n_frags):
            tid = int(rng.integers(0, 2))
            pos1 = int(rng.integers(100, clen - 1000))
            frag = int(rng.integers(160, 340))
            read_len = 150
            pos2 = max(pos1, pos1 + frag - read_len)
            a, b = rng.choice(umis, size=2, replace=False)
            ndup = 1 + int(rng.poisson(dupmean - 1))
            for _ in range(ndup):
                n_err = int(rng.random() < 0.3) * int(rng.integers(1, 3))
                sb.add_pair(tid, pos1, pos2, read_len=read_len, umi=f"{a}_{b}",
                            n_errors=n_err, qual=int(rng.choice([18, 30, 36])))
        return sb

    def simple_workload(seed, n_frags, umi=False, clen=200_000):
        rng = np.random.default_rng(seed)
        sb = SyntheticBam(seed=seed, contig_len=clen, n_contigs=1)
        for _ in range(n_frags):
            pos1 = int(rng.integers(100, clen - 1000))
            pos2 = pos1 + int(rng.integers(10, 180))
            u = None
            if umi:
                u = "".join("ACGT"[i] for i in rng.integers(0, 4, 6))
            for _ in range(1 + int(rng.poisson(2))):
                sb.add_pair(0, pos1, pos2, read_len=100, umi=u,
                            n_errors=int(rng.integers(0, 3)),
                            qual=int(rng.choice([12, 22, 35])))
        return sb

    def mi_minority_workload(seed, n_frags, clen=400_000):
        """UMIs in qnames for most reads, MI:Z aux tags on a small minority
        (whose qnames carry NO umi): the reference consults MI per read
        (bamutil.cpp:23-38), so the minority must still group by MI."""
        rng = np.random.default_rng(seed)
        sb = SyntheticBam(seed=seed, contig_len=clen, n_contigs=1)
        umis = ["AAAA_CCCC", "CCCC_AAAA", "GGGG_TTTT", "TTTT_GGGG"]
        for k in range(n_frags):
            pos1 = int(rng.integers(100, clen - 1000))
            pos2 = pos1 + int(rng.integers(20, 180))
            u = str(rng.choice(umis))
            for d in range(1 + int(rng.poisson(1.5))):
                if k % 41 == 17 and d == 0:
                    # MI value embeds the prefix so getUMI parses it
                    # non-empty under -u UMI (bamutil.cpp:44)
                    sb.add_pair_mi(0, pos1, pos2, mi=f"UMI_{u}",
                                   n_errors=int(rng.integers(0, 2)))
                else:
                    sb.add_pair(0, pos1, pos2, read_len=100, umi=u,
                                n_errors=int(rng.integers(0, 2)),
                                qual=int(rng.choice([18, 35])))
        return sb

    n = 300 if quick else 1500
    cases.append(("defaults_noumi", simple_workload(11, n), []))
    cases.append(("mi_minority", mi_minority_workload(18, n), ["-u", "UMI"]))
    cases.append(("duplex_umi", wide_workload(12, n), ["-u", "UMI"]))
    cases.append(("s2_scores", simple_workload(13, n), ["-s", "2", "-c", "8"]))
    cases.append(("umi_singlestrand", simple_workload(14, n, umi=True),
                  ["-u", "UMI", "--no_duplex"]))
    cases.append(("duplex_only", wide_workload(15, n), ["-u", "UMI", "-x"]))
    cases.append(("bed_regions", wide_workload(17, n), ["-b", "__BED__"]))
    if not quick:
        cases.append(("big_mixed", wide_workload(16, 4000, clen=2_000_000), ["-u", "UMI"]))
    return cases


def setup_env():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from gencore_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()


def main():
    quick = "--quick" in sys.argv
    build_ref()
    setup_env()
    failures = []
    with tempfile.TemporaryDirectory() as wd:
        for name, sb, args in make_cases(quick):
            f = run_case(name, sb, args, wd)
            status = "OK " if not f else "FAIL"
            print(f"[{status}] {name}", flush=True)
            failures.extend(f)
    for f in failures:
        print(f, file=sys.stderr)
    print(f"{'PASS' if not failures else 'FAIL'}: golden comparison vs "
          f"reference binary ({REF_BIN})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
