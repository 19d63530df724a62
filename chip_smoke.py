"""Smoke test of the consensus engine on the GPU, through the entry points
a user calls.

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --devices 4    # the CLI's --devices 4 path only

Phases; a failure in any of them exits nonzero before the result line:

 1. Device gate: JAX's devices are GPUs (kind and count printed), the
    card's name and power limit, and the native I/O core loaded (no GPU
    number is ever taken on the pure-Python codec).
 2. Kernels at real widths, compiled for the card: the whole-window vote
    program (core/vote.py) over every k-class it uses, {4, 16, 32, 64, 128,
    256}, with thousands of jobs per class, and score_map_kernel over a
    window's rows, each equal to the plain reference (kernels.
    consensus_kernel with full_bins=False, kernels.score_map_kernel) run on
    the CPU in this process. The device path is int32 arithmetic with no
    float op, so equality is exact.
 3. End to end through gencore_tpu.cli.main: a seeded duplex-UMI targeted
    panel (2x150 reads, two-part UMIs, a capture BED, per-read qualities,
    sequencing errors, >= 1M reads, so the streaming path runs many
    windows) on the GPU, and the same command in a subprocess with
    JAX_PLATFORMS=cpu: identical output BAM records and JSON stats. A
    small workload on the GPU equals the scalar --oracle run.
 4. The `gpu`-marked tests (tests/test_gpu.py), run in this process.

With --devices 4, after phase 1 only: phase 3's panel through the CLI's
--devices 4 (windows round-robined over four cards) against a one-card
run: byte-identical output BAM and equal JSON stats, and every card holds
memory afterwards (the windows did not all land on card 0).

Cuts from a real deployment: the read count (a panel sample holds tens of
millions of reads) and the genome, 2 x 8 Mbp synthetic contigs (genome
offsets are int32; a human-sized genome waits on ROADMAP Reach 1).

The last line of standard output is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "bench_data", "smoke")
K_CLASSES = (4, 16, 32, 64, 128, 256)
VOTE_KW = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4,
               ratio_den=5)
SCORE_KW = dict(hi=30, mod=20, lo=15, s_hi=12, s_mod=10, s_lo=8, s_bad=6)
PANEL_FRAGMENTS = 175_000   # x ~3 duplicates x 2 mates ~ 1.05M reads
MIN_PANEL_READS = 1_000_000


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- phase 1
def device_gate(jax):
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (default device platform {devs[0].platform})")
    log(f"[gate] jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    cp = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, timeout=60)
    check(cp.returncode == 0, f"nvidia-smi failed: {cp.stderr.strip()}")
    card = cp.stdout.strip()
    log(f"[gate] card: {card}")
    from gencore_tpu.io import native
    lib = native.get_lib()
    log(f"[gate] native I/O core loaded: {lib is not None}")
    check(lib is not None, "native I/O core (native/libgcio.so) did not "
          "build or load")
    return devs, card


# ---------------------------------------------------------------- phase 2
def vote_window_inputs(rng, L, classes):
    """One window's worth of fast vote jobs: for each (K, J) class, J jobs
    whose K member rows are contiguous in the read matrices (template
    first), reads drawn from a random genome with errors, per-read
    qualities and random scores; ~10% of jobs take host refbase rows."""
    import numpy as np
    G = 1 << 22
    genome = rng.choice(np.array([1, 2, 4, 8], np.uint8), size=G + 4096)
    nrows = sum(K * J for K, J in classes) + 1
    seq = np.zeros((nrows, L), np.uint8)
    qual = np.zeros((nrows, L), np.uint8)
    score = rng.integers(-3, 13, size=(nrows, L)).astype(np.int8)
    jobs = []
    row = 0
    for K, J in classes:
        gp = rng.integers(0, G - L, size=J)
        truth = genome[gp[:, None] + np.arange(L)[None, :]]
        var = rng.random(truth.shape) < 0.02
        truth[var] = rng.choice(np.array([1, 2, 4, 8], np.uint8),
                                size=int(var.sum()))
        rand_job = rng.random(J) < 0.3          # contested, noisy jobs
        for k in range(K):
            r = np.arange(J) * K + row + k
            s = truth.copy()
            err = rng.random(s.shape) < np.where(rand_job, 0.5, 0.03)[:, None]
            s[err] = rng.choice(np.array([0, 1, 2, 4, 8, 15], np.uint8),
                                size=int(err.sum()))
            seq[r] = s
            qual[r] = rng.choice(np.array([18, 30, 36], np.uint8),
                                 size=J)[:, None]
        # a window job's member count ships as u8 (the engine sends
        # deeper groups down its per-bucket path)
        counts = rng.integers(1, min(K, 255) + 1, size=J)
        job_len = rng.integers(L // 2, L + 1, size=J)
        jobs.append(dict(K=K, J=J, base=row + np.arange(J) * K,
                         counts=counts, job_len=job_len, gp=gp))
        row += K * J
    nj = sum(J for _, J in classes)
    H = 64
    hr = rng.choice(np.array([0, 1, 2, 4, 8], np.uint8), size=(H, L))
    gp_all = np.concatenate([j["gp"] for j in jobs]).astype(np.int32)
    jl_all = np.concatenate([j["job_len"] for j in jobs])
    hm = np.where(rng.random(nj) < 0.1, rng.integers(0, H, size=nj),
                  -1).astype(np.int32)
    g = genome[gp_all[:, None] + np.arange(L)[None, :]]
    g[np.arange(L)[None, :] >= jl_all[:, None]] = 0
    refbase = np.where((hm < 0)[:, None], g, hr[np.clip(hm, 0, H - 1)])
    return dict(seq=seq, qual=qual, score=score, genome=genome, gp=gp_all,
                hr=hr, hm=hm, jp=jl_all.astype(np.uint16), refbase=refbase,
                jobs=jobs)


def check_vote_window(jax, L, classes, seed, out_len, show_memory=False):
    """The whole-window vote program on the default device vs
    kernels.consensus_kernel on the CPU, class by class; returns the
    number of jobs compared."""
    import numpy as np

    from gencore_tpu.core import kernels, vote
    from gencore_tpu.engine import _unpack_nibbles
    rng = np.random.default_rng(seed)
    d = vote_window_inputs(rng, L, classes)
    class_args = []
    off = 0
    for j in d["jobs"]:
        J = j["J"]
        class_args += [j["base"].astype(np.uint32),
                       j["counts"].astype(np.uint8),
                       j["job_len"].astype(np.uint16),
                       (off + np.arange(J)).astype(np.uint32)]
        off += J
    args = (d["seq"], d["qual"], d["score"], d["genome"], d["gp"], d["hr"],
            d["hm"], d["jp"], None, *class_args)
    kw = dict(classes=tuple(classes), L=L, out_len=out_len, **VOTE_KW)
    if show_memory:
        compiled = vote.vote_window.lower(*args, **kw).compile()
        log(f"[kernels] window program memory_analysis: "
            f"{compiled.memory_analysis()}")
    t0 = time.perf_counter()
    flat, _, dense = vote.vote_window(*args, **kw)
    flat = np.asarray(jax.block_until_ready(flat))
    dt = time.perf_counter() - t0
    R, C = vote.SPARSE_RUNS, vote.SPARSE_DIFFS
    nj = sum(J for _, J in classes)
    df_at = nj * (2 * R + 1 + C + C // 2 + 1)
    df = flat[df_at:df_at + 2 * nj].view(np.int16)
    mc = flat[df_at + 2 * nj:df_at + 4 * nj].view(np.int16)
    cpu = jax.devices("cpu")[0]
    off = 0
    for (K, J), j, (pseq, pqual) in zip(classes, d["jobs"], dense):
        rows = j["base"][:, None] + np.arange(K)[None, :]
        valid = np.arange(K)[None, :] < j["counts"][:, None]
        pos_valid = np.arange(L)[None, :] < j["job_len"][:, None]
        with jax.default_device(cpu):
            ref = kernels.consensus_kernel(
                d["seq"][rows], d["qual"][rows],
                d["score"][rows].astype(np.int32), valid, pos_valid,
                d["refbase"][off:off + J], full_bins=False, **VOTE_KW)
            ref = [np.asarray(x) for x in ref]
        got_seq = _unpack_nibbles(np.asarray(pseq))
        for name, a, b in (("seq", got_seq, ref[0][:, :out_len]),
                           ("qual", np.asarray(pqual), ref[1][:, :out_len]),
                           ("diff", df[off:off + J], ref[2]),
                           ("minc", mc[off:off + J], ref[3])):
            bad = int((a != b).sum())
            check(bad == 0, f"vote K={K} J={J} L={L}: {bad} {name} "
                  "mismatches against the CPU reference")
        log(f"[kernels] vote K={K:3d} J={J} L={L}: equal to the CPU "
            "reference")
        off += J
    log(f"[kernels] window program ({nj} jobs) ran in {dt:.3f}s "
        "including compile")
    return nj


def check_score_map(jax, N, L, seed):
    """score_map_kernel on the default device vs the same kernel on the
    CPU, over N rows of mate pairs with random overlap geometry."""
    import numpy as np

    from gencore_tpu.core import kernels
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.array([0, 1, 2, 4, 8, 15], np.uint8), size=(N, L))
    qual = rng.integers(2, 42, size=(N, L)).astype(np.uint8)
    mate = (np.arange(N) ^ 1).astype(np.int32)
    d = rng.integers(0, 150, size=N // 2)
    my_start = np.zeros(N, np.int32)
    mate_start = np.zeros(N, np.int32)
    my_start[0::2] = d
    mate_start[1::2] = d
    cmp_len = np.repeat(150 - d, 2).astype(np.int32)
    lens = np.full(N, 150, np.int32)
    is_left = np.arange(N) % 2 == 0
    scored = rng.random(N) < 0.9
    args = (seq, qual, mate, my_start, mate_start, cmp_len, lens, is_left,
            scored)
    got = [np.asarray(x) for x in kernels.score_map_kernel(*args, **SCORE_KW)]
    with jax.default_device(jax.devices("cpu")[0]):
        ref = [np.asarray(x)
               for x in kernels.score_map_kernel(*args, **SCORE_KW)]
    for name, a, b in zip(("score", "qual"), got, ref):
        bad = int((a != b).sum())
        check(bad == 0, f"score_map N={N} L={L}: {bad} {name} mismatches")
    log(f"[kernels] score_map N={N} L={L}: equal to the CPU reference")


def kernel_phase(jax):
    from gencore_tpu.engine import LANE, _bucket_rows
    L = ((150 + LANE - 1) // LANE) * LANE      # the engine's padded width
    classes = [(K, 4096 if K <= 32 else 2048) for K in K_CLASSES]
    check_vote_window(jax, L, classes, seed=1, out_len=152,
                      show_memory=True)
    check_score_map(jax, _bucket_rows(40_001), L, seed=2)


# ---------------------------------------------------------------- phase 3
def make_panel(n_fragments, seed, tag):
    """Seeded duplex-UMI targeted panel (bench.py's read recipe, on-target
    fragments drawn from a capture BED). Returns (bam, fasta, bed)."""
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from datagen import SyntheticBam
    os.makedirs(WORK, exist_ok=True)
    bam = os.path.join(WORK, f"{tag}.bam")
    fa = os.path.join(WORK, f"{tag}.fa")
    bed = os.path.join(WORK, f"{tag}.bed")
    rng = np.random.default_rng(seed)
    clen = 8_000_000
    sb = SyntheticBam(seed=seed, contig_len=clen, n_contigs=2)
    regions = [(t, 100_000 + 195_000 * k, 100_000 + 195_000 * k + 40_000)
               for t in range(2) for k in range(40)]
    with open(bed, "w") as f:
        for i, (t, a, b) in enumerate(regions):
            f.write(f"chr{t + 1}\t{a}\t{b}\tT{i}\n")
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA", "GATC", "CTAG"]
    for _ in range(n_fragments):
        if rng.random() < 0.85:                 # on target
            tid, a, b = regions[int(rng.integers(0, len(regions)))]
            pos1 = int(rng.integers(a, b))
        else:
            tid = int(rng.integers(0, 2))
            pos1 = int(rng.integers(100, clen - 400))
        frag = int(rng.integers(160, 340))
        pos2 = max(pos1, pos1 + frag - 150)
        u1, u2 = rng.choice(umis, size=2, replace=False)
        for _ in range(1 + int(rng.poisson(2))):
            n_err = int(rng.random() < 0.3) * int(rng.integers(1, 3))
            sb.add_pair(tid, pos1, pos2, read_len=150, umi=f"{u1}_{u2}",
                        n_errors=n_err, qual=int(rng.choice([18, 30, 36])))
    sb.write_bam(bam)
    sb.write_fasta(fa)
    return bam, fa, bed, len(sb.records)


def run_cli(argv):
    """gencore_tpu.cli.main in this process; returns (wall seconds,
    captured stderr)."""
    from gencore_tpu import cli
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}: "
          f"{err.getvalue()[-2000:]}")
    return dt, err.getvalue()


def cli_args(bam, fa, bed, out_prefix, extra=()):
    return ["-i", bam, "-r", fa, "-b", bed, "-u", "UMI",
            "-o", out_prefix + ".bam", "-j", out_prefix + ".json",
            "-h", out_prefix + ".html", *extra]


def same_records(a, b):
    from gencore_tpu.io import bam as bamio
    ra = bamio.BamReader(a).read_all()
    rb = bamio.BamReader(b).read_all()
    if ra.n != rb.n:
        return f"record count {ra.n} vs {rb.n}"
    for i in range(ra.n):
        if ra.record_bytes(i) != rb.record_bytes(i):
            return f"record {i} differs"
    return None


def json_stats(path):
    """The JSON report without its "command" line (the output names)."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith('\t"command"')]


def panel():
    t0 = time.perf_counter()
    bam, fa, bed, n = make_panel(PANEL_FRAGMENTS, seed=5, tag="panel")
    log(f"[e2e] panel: {n} reads, {os.path.getsize(bam) / 1e6:.1f} MB BAM, "
        f"generated in {time.perf_counter() - t0:.1f}s")
    check(n >= MIN_PANEL_READS, f"panel has only {n} reads")
    return bam, fa, bed, n


def stage_lines(stderr):
    return [ln for ln in stderr.splitlines() if ln.startswith("[stage]")]


def e2e_phase(card):
    bam, fa, bed, n = panel()
    gpu = os.path.join(WORK, "gpu")
    cold, _ = run_cli(cli_args(bam, fa, bed, gpu))
    warm, err = run_cli(cli_args(bam, fa, bed, gpu, ["--debug"]))
    log(f"[e2e] GPU run on {card}: cold (compile included) {cold:.2f}s, "
        f"warm {warm:.2f}s = {n / warm:,.0f} reads/s")
    for ln in stage_lines(err)[:15]:
        log(f"[e2e]   {ln}")
    cpu = os.path.join(WORK, "cpu")
    t0 = time.perf_counter()
    cp = subprocess.run(
        [sys.executable, "-m", "gencore_tpu.cli",
         *cli_args(bam, fa, bed, cpu, ["--debug"])],
        capture_output=True, text=True, cwd=REPO, timeout=900,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    check(cp.returncode == 0, f"CPU run failed: {cp.stderr[-2000:]}")
    log(f"[e2e] CPU run (JAX_PLATFORMS=cpu subprocess): "
        f"{time.perf_counter() - t0:.2f}s")
    diff = same_records(gpu + ".bam", cpu + ".bam")
    check(diff is None, f"GPU and CPU output BAMs differ: {diff}")
    check(json_stats(gpu + ".json") == json_stats(cpu + ".json"),
          "GPU and CPU JSON stats differ")
    log("[e2e] GPU output BAM records and JSON stats equal the CPU run's")

    sbam, sfa, sbed, sn = make_panel(1_500, seed=6, tag="small")
    sg = os.path.join(WORK, "small_gpu")
    so = os.path.join(WORK, "small_oracle")
    run_cli(cli_args(sbam, sfa, sbed, sg))
    run_cli(cli_args(sbam, sfa, sbed, so, ["--oracle"]))
    diff = same_records(sg + ".bam", so + ".bam")
    check(diff is None, f"GPU and --oracle outputs differ: {diff}")
    check(json_stats(sg + ".json") == json_stats(so + ".json"),
          "GPU and --oracle JSON stats differ")
    log(f"[e2e] small workload ({sn} reads): GPU records and stats equal "
        "the --oracle run's")


# ---------------------------------------------------------------- phase 4
class _Outcomes:
    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome,
                                                          0) + 1


def gpu_tests_phase():
    import pytest
    seen = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[seen])
    log(f"[tests] gpu-marked tests: {seen.counts}")
    check(rc == 0 and seen.counts.get("passed", 0) > 0
          and set(seen.counts) == {"passed"},
          f"gpu-marked tests did not all pass (rc {rc}, {seen.counts})")


# ---------------------------------------------------------------- --devices 4
def four_card_phase(jax, n_cards):
    check(len(jax.devices()) >= n_cards,
          f"--devices {n_cards} needs {n_cards} cards, JAX sees "
          f"{len(jax.devices())}")
    bam, fa, bed, n = panel()
    one = os.path.join(WORK, "dev1")
    many = os.path.join(WORK, f"dev{n_cards}")
    t1, _ = run_cli(cli_args(bam, fa, bed, one, ["--devices", "1"]))
    tn, _ = run_cli(cli_args(bam, fa, bed, many,
                             ["--devices", str(n_cards)]))
    log(f"[devices] one card {t1:.2f}s, {n_cards} cards {tn:.2f}s "
        "(both cold: compile included)")
    with open(one + ".bam", "rb") as a, open(many + ".bam", "rb") as b:
        check(a.read() == b.read(),
              f"--devices {n_cards} output BAM is not byte-identical to "
              "the one-card run")
    check(json_stats(one + ".json") == json_stats(many + ".json"),
          f"--devices {n_cards} JSON stats differ from the one-card run")
    used = []
    for d in jax.devices()[:n_cards]:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
        used.append(peak)
        log(f"[devices] {d}: peak_bytes_in_use {peak}")
    # each card holds its own genome copy (2 x 8 Mbp) while it votes
    check(all(p >= 8_000_000 for p in used),
          "not every card was used: windows did not spread over the cards")
    log(f"[devices] --devices {n_cards} output is byte-identical to the "
        "one-card run")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the CLI's --devices N path against one "
                         "card")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import jax

    from gencore_tpu.utils.compile_cache import setup_compile_cache
    log(f"[gate] compile cache: {setup_compile_cache()}")
    devs, card = device_gate(jax)
    t0 = time.perf_counter()
    if args.devices > 1:
        four_card_phase(jax, args.devices)
    else:
        kernel_phase(jax)
        e2e_phase(card)
        gpu_tests_phase()
    log(f"[done] phases took {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
