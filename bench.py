"""End-to-end benchmark: BAM -> consensus BAM reads/sec.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N}

Baseline: measured single-core reference gencore throughput when
available (bench_data/baseline_ref.json, written by
`python tools/measure_baseline.py` which builds the actual reference
binary against native/htsshim and runs it on this exact workload).
Fallback: env GENCORE_BASELINE_RPS, else a documented 200k reads/s
estimate (see BENCH_NOTES.md).

Workload: synthetic ultra-deep paired-end panel (duplicates + UMIs +
errors), cached under bench_data/. The timed region is the full
end-to-end path: BGZF/BAM decode -> clustering -> device kernels on the
GPU -> duplex -> output BAM encode+write. Kernel compilation is excluded
via a download-free warm pass (warm_only); median of N_RUNS timed runs is
reported, with per-run values and stage timers in `detail`, beside the
device it ran on. A run that finds no GPU exits nonzero: no number from
another device is ever reported.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BENCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_data")
N_FRAGMENTS = int(os.environ.get("GENCORE_BENCH_FRAGMENTS", 40_000))
DUP_MEAN = 3  # mean duplicates per fragment -> ~40000*3*2 = 240k reads
# SAME run count and SAME statistic (median) for every config, so no
# config's vs_baseline is flattered relative to the headline (the
# per-config reference baselines stay best-of-5, conservative for us)
N_RUNS = int(os.environ.get("GENCORE_BENCH_RUNS", 5))


def resolve_baseline():
    """(reads_per_sec, source_string). Prefers the measured reference run."""
    p = os.path.join(BENCH_DIR, "baseline_ref.json")
    if os.path.exists(p):
        try:
            with open(p) as f:
                d = json.load(f)
            if d.get("reads_per_sec"):
                return float(d["reads_per_sec"]), "measured:" + d.get(
                    "binary", "reference")
        except Exception:
            pass
    env = os.environ.get("GENCORE_BASELINE_RPS")
    if env:
        return float(env), "env"
    return 200_000.0, "assumed"


def make_workload():
    os.makedirs(BENCH_DIR, exist_ok=True)
    bam_path = os.path.join(BENCH_DIR, f"bench_{N_FRAGMENTS}.bam")
    fa_path = os.path.join(BENCH_DIR, "bench_ref.fa")
    if os.path.exists(bam_path) and os.path.exists(fa_path):
        return bam_path, fa_path
    import numpy as np

    from tests.datagen import SyntheticBam
    rng = np.random.default_rng(7)
    sb = SyntheticBam(seed=7, contig_len=8_000_000, n_contigs=2)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA", "GATC", "CTAG"]
    for k in range(N_FRAGMENTS):
        tid = int(rng.integers(0, 2))
        pos1 = int(rng.integers(100, 7_900_000))
        frag = int(rng.integers(160, 340))
        read_len = 150
        pos2 = max(pos1, pos1 + frag - read_len)
        a, b = rng.choice(umis, size=2, replace=False)
        umi = f"{a}_{b}"
        ndup = 1 + int(rng.poisson(DUP_MEAN - 1))
        for _ in range(ndup):
            n_err = int(rng.random() < 0.3) * int(rng.integers(1, 3))
            sb.add_pair(tid, pos1, pos2, read_len=read_len, umi=umi,
                        n_errors=n_err, qual=int(rng.choice([18, 30, 36])))
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    return bam_path, fa_path


def make_ultradeep_workload():
    """Ultra-deep amplicon-style workload (BASELINE.md config 5): loci
    with >1000-pair position clusters, so the low-complexity threshold
    paths, deep greedy UMI grouping, and large-k vote buckets all engage.
    ~120k reads (large enough that the reference-baseline FASTA-load
    subtraction noise is negligible)."""
    os.makedirs(BENCH_DIR, exist_ok=True)
    bam_path = os.path.join(BENCH_DIR, "bench_ultradeep.bam")
    # the ultradeep workload draws reads from its OWN contigs (seed 21) —
    # it must ship its own FASTA, not the seed-7 bench_ref.fa
    fa_path = os.path.join(BENCH_DIR, "bench_ultradeep_ref.fa")
    if os.path.exists(bam_path) and os.path.exists(fa_path):
        return bam_path, fa_path
    import numpy as np

    from tests.datagen import SyntheticBam
    rng = np.random.default_rng(21)
    sb = SyntheticBam(seed=21, contig_len=8_000_000, n_contigs=2)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA", "GATC", "CTAG"]
    for locus in range(40):
        tid = locus % 2
        pos1 = 200_000 + 380_000 * (locus // 2)
        pos2 = pos1 + 160
        for _ in range(1500):
            a, b = rng.choice(umis, size=2, replace=False)
            n_err = int(rng.random() < 0.3) * int(rng.integers(1, 3))
            sb.add_pair(tid, pos1, pos2, read_len=150, umi=f"{a}_{b}",
                        n_errors=n_err, qual=int(rng.choice([18, 30, 36])))
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    return bam_path, fa_path


def make_bed(bam_ignored=None):
    """Capture-region BED over the bench contigs (config 4 full report)."""
    p = os.path.join(BENCH_DIR, "bench_regions.bed")
    if not os.path.exists(p):
        with open(p, "w") as f:
            for k in range(20):
                f.write(f"chr1\t{100_000 + 390_000 * k}\t"
                        f"{150_000 + 390_000 * k}\tR{k}\n")
    return p


# BASELINE.md tracked configs: (name, Options kwargs, reference CLI flags,
# workload). Workload None = the canonical 240k-read deep-panel workload.
def bench_configs():
    return [
        ("defaults", {}, [], None),
        ("s2_scores", {"cluster_size_req": 2, "base_score_req": 8},
         ["-s", "2", "-c", "8"], None),
        ("umi_sscs", {"umi_prefix": "UMI", "disable_duplex": True},
         ["-u", "UMI", "--no_duplex"], None),
        ("duplex_full", {"umi_prefix": "UMI", "bed_file": "__BED__",
                         "has_bed_file": True},
         ["-u", "UMI", "-b", "__BED__"], None),
        ("ultradeep", {"umi_prefix": "UMI"}, ["-u", "UMI"], "ultradeep"),
    ]


def require_gpu(jax):
    """The device every number is taken on: (platform, device_kind,
    count). Exits nonzero when JAX's default device is not a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {devs[0].platform}")
    return devs[0].platform, devs[0].device_kind, len(devs)


def main():
    import jax

    from gencore_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    platform, device_kind, device_count = require_gpu(jax)

    t_setup = time.time()
    bam_path, fa_path = make_workload()

    from gencore_tpu.io import bam as bamio
    from gencore_tpu.io.fasta import FastaRef
    from gencore_tpu.options import Options
    from gencore_tpu.parallel import pipeline as pipe

    n_windows = int(os.environ.get("GENCORE_BENCH_WINDOWS", 0))

    fasta = FastaRef.load(fa_path)
    reader = bamio.BamReader(bam_path)
    n_reads = reader.read_all().n
    setup_s = time.time() - t_setup

    from gencore_tpu.io import native as gnative
    use_stream = (gnative.get_lib() is not None
                  and not os.environ.get("GENCORE_BENCH_NO_STREAM"))
    out_path = os.path.join(BENCH_DIR, "bench_out.bam")

    # warm pass: dispatch+compile every kernel with NO device->host
    # transfers (engine warm_only path) so compilation is excluded from the
    # timed runs. Uses the same window plan as the timed runs so bucket
    # shapes match.
    t0 = time.time()
    if use_stream:
        from gencore_tpu.parallel import streaming as stream
        stream.run_streaming(Options(), bam_path, out_path, fasta=fasta,
                             n_windows=n_windows, warm_only=True)
    else:
        pipe.run_pipelined(Options(), reader.read_all(), reader.header,
                           fasta=fasta, n_windows=n_windows, warm_only=True)
    warm_s = time.time() - t0

    # timed runs: full end-to-end. The default path is the streaming
    # window pipeline (the CLI default for file->file BAM): pass-1 index
    # (threaded inflate + native record scan) then per-window ranged
    # decode -> engine -> incremental BGZF write, so BGZF inflate overlaps
    # device compute with no serial whole-file decode prefix.
    runs = []
    stage_tables = []
    n_out = 0
    for _ in range(max(N_RUNS, 1)):
        t1 = time.time()
        stage_sum: dict = {}
        if use_stream:
            _, pre_stats, post_stats = stream.run_streaming(
                Options(), bam_path, out_path, fasta=fasta,
                n_windows=n_windows, stage_totals=stage_sum)
            n_out = int(stage_sum.pop("out.records", 0))
            t_dec = t_wr = 0.0
        else:
            td0 = time.time()
            rdr = bamio.BamReader(bam_path)
            b = rdr.read_all()
            t_dec = time.time() - td0
            tables, pre_stats, post_stats = pipe.run_pipelined(
                Options(), b, rdr.header, fasta=fasta, n_windows=n_windows,
                stage_totals=stage_sum)
            t_wr = time.time()
            payload = pipe.merged_payload(tables)
            w = bamio.BamWriter(out_path, rdr.header)
            w.write_payload(payload)
            w.close()
            t_wr = time.time() - t_wr
            n_out = sum(len(t) for t in tables)
        runs.append(time.time() - t1)
        # summed per-window stage times: wall-clock overlap means these
        # exceed elapsed; they attribute where time goes, not the critical path
        st = {k: round(v, 3) for k, v in sorted(stage_sum.items(),
                                                key=lambda kv: -kv[1])}
        if not use_stream:
            st["decode"] = round(t_dec, 3)
            st["write"] = round(t_wr, 3)
        stage_tables.append(st)

    med = statistics.median(runs)
    med_idx = runs.index(med) if med in runs else 0
    rps = n_reads / med
    baseline_rps, baseline_src = resolve_baseline()

    # ---- all five BASELINE.md configs ----
    per_cfg_base = {}
    try:
        with open(os.path.join(BENCH_DIR, "baseline_ref.json")) as f:
            per_cfg_base = json.load(f).get("configs", {})
    except Exception:
        pass
    configs_out = [{
        "name": "defaults", "reads_per_sec": round(rps, 1),
        "elapsed_s": round(med, 2),
        "runs_s": [round(r, 2) for r in runs],
        "best_rps": round(n_reads / min(runs), 1),
        "stages_s": stage_tables[med_idx],
        "vs_baseline": round(rps / float(per_cfg_base.get(
            "defaults", baseline_rps)), 3)}]
    cfg_budget = float(os.environ.get("GENCORE_BENCH_BUDGET_S", 420))
    t_cfg0 = time.time()
    if use_stream and not os.environ.get("GENCORE_BENCH_NO_CONFIGS"):
        from gencore_tpu.io.bed import BedRegions
        for name, kw, _flags, wl in bench_configs():
            if name == "defaults":
                continue
            if time.time() - t_cfg0 > cfg_budget:
                configs_out.append({"name": name, "skipped": "time budget"})
                continue
            if wl is None:
                bpath, cfg_fasta = bam_path, fasta
            else:
                bpath, cfa = make_ultradeep_workload()
                cfg_fasta = FastaRef.load(cfa)
            kw2 = dict(kw)
            mkbed = kw2.get("bed_file") == "__BED__"
            if mkbed:
                kw2["bed_file"] = make_bed()
            nr_c = (n_reads if wl is None
                    else bamio.BamReader(bpath).read_all().n)

            def mk():
                o = Options(**kw2)
                bed = (BedRegions.load(kw2["bed_file"], reader.header.names)
                       if mkbed else None)
                return o, bed

            # same path-selection as the CLI: streaming two-pass for files
            # over the threshold, in-memory window pipeline below it (the
            # ultradeep amplicon pile compresses far below the threshold
            # and pays a needless serial index pass under streaming)
            from gencore_tpu.parallel.streaming import (
                DEFAULT_STREAM_THRESHOLD)
            thr = int(os.environ.get("GENCORE_STREAM_THRESHOLD",
                                     DEFAULT_STREAM_THRESHOLD))
            cfg_stream = os.path.getsize(bpath) >= thr
            from gencore_tpu.parallel.streaming import StreamingBamWriter

            def run_cfg(stage_totals=None, warm_only=False):
                o, bed = mk()
                if cfg_stream:
                    stream.run_streaming(o, bpath, out_path, fasta=cfg_fasta,
                                         bed=bed, n_windows=n_windows,
                                         warm_only=warm_only,
                                         stage_totals=stage_totals)
                    return
                rdr = bamio.BamReader(bpath)
                b = rdr.read_all()
                ow = (None if warm_only
                      else StreamingBamWriter(out_path, rdr.header))
                tables, _, _ = pipe.run_pipelined(
                    o, b, rdr.header, fasta=cfg_fasta, bed=bed,
                    n_windows=n_windows, warm_only=warm_only,
                    stage_totals=stage_totals, out_writer=ow)
                if ow is not None:
                    ow.close()

            run_cfg(warm_only=True)
            cfg_runs = []
            cfg_stages = []
            for _ in range(max(N_RUNS, 1)):
                cst: dict = {}
                t1 = time.time()
                run_cfg(stage_totals=cst)
                cfg_runs.append(time.time() - t1)
                cst.pop("out.records", None)
                cfg_stages.append({k: round(v, 3) for k, v in sorted(
                    cst.items(), key=lambda kv: -kv[1])})
            el = statistics.median(cfg_runs)
            ci = cfg_runs.index(el) if el in cfg_runs else 0
            crps = nr_c / el
            cw = cfg_stages[ci]
            ch2 = cw.pop("wire.h2dMB", None)
            cd2 = cw.pop("wire.d2hMB", None)
            entry = {"name": name, "reads_per_sec": round(crps, 1),
                     "elapsed_s": round(el, 2), "n_reads": nr_c,
                     "runs_s": [round(r, 2) for r in cfg_runs],
                     "best_rps": round(nr_c / min(cfg_runs), 1),
                     "stages_s": cw}
            if ch2 is not None:
                entry["wire"] = {
                    "h2d_B_per_read": round(ch2 * 1e6 / max(nr_c, 1), 1),
                    "d2h_B_per_read": round((cd2 or 0) * 1e6 / max(nr_c, 1),
                                            1)}
            if name in per_cfg_base:
                entry["vs_baseline"] = round(
                    crps / float(per_cfg_base[name]), 3)
            configs_out.append(entry)
    wire = {}
    for st in stage_tables:
        h2 = st.pop("wire.h2dMB", None)
        d2 = st.pop("wire.d2hMB", None)
        if h2 is not None and not wire:
            wire = {"h2d_B_per_read": round(h2 * 1e6 / max(n_reads, 1), 1),
                    "d2h_B_per_read": round((d2 or 0) * 1e6 / max(n_reads, 1), 1),
                    "h2d_MB": round(h2, 1), "d2h_MB": round(d2 or 0, 1)}
    result = {
        "metric": "consensus_reads_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / baseline_rps, 4),
        "detail": {
            "platform": platform,
            "device_kind": device_kind,
            "device_count": device_count,
            "n_reads": n_reads,
            "n_output_records": n_out,
            "runs_s": [round(r, 2) for r in runs],
            "elapsed_s": round(med, 2),
            "best_rps": round(n_reads / min(runs), 1),
            "warm_s": round(warm_s, 2),
            "setup_s": round(setup_s, 2),
            "wire": wire,
            "configs": configs_out,
            "stages_s": stage_tables[med_idx],
            "baseline_rps": baseline_rps,
            "baseline_source": baseline_src,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
