"""Command-line interface, flag-compatible with the reference gencore CLI.

Flag table mirrors reference src/main.cpp:29-87 (same long/short names,
defaults and help semantics); `test` and `--version` subcommands mirror
main.cpp:18-27.
"""

from __future__ import annotations

import argparse
import sys
import time

from gencore_tpu import __version__
from gencore_tpu.options import OptionError, Options


def build_parser() -> argparse.ArgumentParser:
    # add_help=False: the reference assigns -h to --html (main.cpp:54);
    # --help is registered manually below
    p = argparse.ArgumentParser(
        prog="gencore-tpu", add_help=False,
        description="consensus read engine on JAX (gencore-compatible)")
    p.add_argument("--help", action="help",
                   help="show this help message and exit")
    p.add_argument("-i", "--in", dest="input", default="-",
                   help="input sorted bam/sam file. STDIN will be read from if it's not specified")
    p.add_argument("-o", "--out", dest="output", default="-",
                   help="output bam/sam file. STDOUT will be written to if it's not specified")
    p.add_argument("-r", "--ref", dest="ref", required=False, default="",
                   help="reference fasta file name (should be an uncompressed .fa/.fasta file)")
    p.add_argument("-b", "--bed", dest="bed", default="",
                   help="bed file to specify the capturing region, none by default")
    p.add_argument("-x", "--duplex_only", action="store_true",
                   help="only output duplex consensus sequences")
    p.add_argument("--no_duplex", action="store_true",
                   help="don't merge single stranded consensus sequences to duplex")
    p.add_argument("-u", "--umi_prefix", default="auto",
                   help="the prefix for UMI, if it has. None by default.")
    p.add_argument("-s", "--supporting_reads", type=int, default=1)
    p.add_argument("-a", "--ratio_threshold", type=float, default=0.8)
    p.add_argument("-c", "--score_threshold", type=int, default=6)
    p.add_argument("-d", "--umi_diff_threshold", type=int, default=1)
    p.add_argument("-D", "--duplex_diff_threshold", type=int, default=2)
    p.add_argument("--high_qual", type=int, default=30)
    p.add_argument("--moderate_qual", type=int, default=20)
    p.add_argument("--low_qual", type=int, default=15)
    p.add_argument("--coverage_sampling", type=int, default=10000)
    p.add_argument("-j", "--json", default="gencore.json")
    p.add_argument("-h", "--html", default="gencore.html",
                   help="the html format report file name")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--quit_after_contig", type=int, default=0)
    # engine knobs (no reference counterpart)
    p.add_argument("--oracle", action="store_true",
                   help="use the scalar oracle engine (debugging)")
    p.add_argument("--windows", type=int, default=0,
                   help="pipeline over N coordinate windows (0 = auto; 1 = "
                        "single-shot). Host prep of window k+1 overlaps "
                        "device voting of window k")
    p.add_argument("--devices", type=int, default=1,
                   help="round-robin pipeline windows over N local devices")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory mode: decode/process/write per "
                        "coordinate window (peak RSS ~ one window, not the "
                        "file); BAM-file input+output only")
    p.add_argument("--shards", type=int, default=1,
                   help="process in N coordinate shards (bounds peak memory; "
                        "same outputs as a single pass)")
    p.add_argument("--checkpoint_dir", default="",
                   help="persist completed shards for crash resume (with --shards)")
    return p


def options_from_args(args) -> Options:
    opt = Options(
        input=args.input, output=args.output, ref_file=args.ref,
        bed_file=args.bed, umi_prefix=args.umi_prefix,
        cluster_size_req=args.supporting_reads,
        base_score_req=args.score_threshold,
        score_percent_req=args.ratio_threshold,
        max_contig=args.quit_after_contig,
        high_quality=args.high_qual, moderate_quality=args.moderate_qual,
        low_quality=args.low_qual, coverage_step=args.coverage_sampling,
        proper_reads_umi_diff_threshold=args.umi_diff_threshold,
        duplex_mismatch_threshold=args.duplex_diff_threshold,
        debug=args.debug, duplex_only=args.duplex_only,
        disable_duplex=args.no_duplex,
        json_file=args.json, html_file=args.html,
    )
    opt.validate()
    return opt


def run_unit_tests() -> bool:
    """`gencore test` equivalent (reference main.cpp:18-22, unittest.cpp:10-16)."""
    from gencore_tpu.utils.umi import get_umi_from_qname, umi_diff, is_duplex
    ok = True
    vectors = [
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404", "", ""),
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404:UMI_GAGCATAC", "UMI", "GAGCATAC"),
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404:UMI_GAGC_ATAC", "UMI", "GAGC_ATAC"),
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404:GAGC_ATAC", "", "GAGC_ATAC"),
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404:UMI_X", "UMI", ""),
        ("@V300034954L1C001R0040000002/1:UMI_ATG_AAT", "UMI", "ATG_AAT"),
        ("@V300034954L1C001R0040000002:UMI_ATG_AAT /1", "UMI", "ATG_AAT"),
    ]
    for q, p, e in vectors:
        ok &= get_umi_from_qname(q, p) == e
    ok &= umi_diff("ATCGATCG", "ATCGATCG") == 0
    ok &= umi_diff("ATCGATCG", "ATCGTTC") == 2
    ok &= is_duplex("ATCG_CTAG", "CTAG_ATCG") is True
    ok &= is_duplex("CTAG", "CCCAGG") is False
    return ok


def _print_stage_totals(stage_sum):
    """--debug stage timers summed over windows; the record count and the
    wire.*MB byte counters ride in the same dict and print in their units."""
    if not stage_sum:
        return
    for k in sorted(stage_sum, key=lambda k: -stage_sum[k]):
        if k == "out.records":
            print(f"[stage] {k}: {int(stage_sum[k])}", file=sys.stderr)
        elif k.startswith("wire."):
            print(f"[stage] {k}: {stage_sum[k]:.3f}", file=sys.stderr)
        else:
            print(f"[stage] {k}: {stage_sum[k]:.3f}s (summed over "
                  "windows)", file=sys.stderr)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and argv[0] == "test":
        if run_unit_tests():
            print("PASSED", file=sys.stderr)
            return 0
        print("FAILED", file=sys.stderr)
        return 1
    if len(argv) == 1 and argv[0] in ("-v", "--version"):
        print(f"gencore-tpu {__version__}", file=sys.stderr)
        return 0

    args = build_parser().parse_args(argv)
    try:
        opt = options_from_args(args)
    except OptionError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return -1

    import os
    from gencore_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    command = "gencore-tpu " + " ".join(argv)
    t1 = time.time()

    # piped stdin: spool once to an unlinked seekable temp file so every
    # downstream path (streaming two-pass included) treats it as a file;
    # the spool is deleted on exit automatically (io/sam.spool_stdin).
    # The reference streams pipes directly (gencore.cpp:164-173).
    stdin_keeper = None
    stdin_is_bam = True
    if opt.input == "-":
        from gencore_tpu.io.sam import spool_stdin
        opt.input, stdin_keeper, stdin_is_bam = spool_stdin()

    from gencore_tpu.io import bam as bamio
    from gencore_tpu.io.bed import BedRegions
    from gencore_tpu.io.fasta import FastaRef
    from gencore_tpu.report import write_html_report, write_json_report

    fasta = None
    if opt.ref_file:
        print("loading reference data:", file=sys.stderr)
        fasta = FastaRef.load(opt.ref_file, opt.max_contig)
        for name, contig in fasta.contigs.items():
            print(f"{name}: {len(contig)} bp", file=sys.stderr)

    # Streaming (bounded-memory windowed decode/process/write) is the
    # DEFAULT for file->file BAM runs: the reference's only mode is
    # O(window) residency (gencore.cpp:205), and the windowed ranged
    # decode overlaps BGZF inflate with device compute. --stream forces
    # it; small inputs and unsupported shapes use the in-memory pipeline.
    # pipes stream too: stdin is already a seekable spool (above) and
    # stdout takes sequential incremental BGZF writes (no seek needed)
    stream_ok = not (opt.input.endswith("sam") or not stdin_is_bam
                     or opt.output.endswith("sam") or args.oracle
                     or args.shards > 1 or opt.max_contig > 0)
    use_stream = args.stream
    # auto-selection additionally skips --windows 1 (an explicit request
    # for a single-shot run); explicit --stream honors it
    if (not use_stream and stream_ok and args.windows != 1
            and not os.environ.get("GENCORE_NO_STREAM")):
        from gencore_tpu.io import native as _nat
        from gencore_tpu.parallel.streaming import DEFAULT_STREAM_THRESHOLD
        thr = int(os.environ.get("GENCORE_STREAM_THRESHOLD",
                                 DEFAULT_STREAM_THRESHOLD))
        try:
            use_stream = (_nat.get_lib() is not None
                          and os.path.getsize(opt.input) >= thr)
        except OSError:
            use_stream = False
    if use_stream:
        if not stream_ok:
            print("ERROR: --stream requires BAM input and output "
                  "(no SAM/--oracle/--shards/--quit_after_contig)",
                  file=sys.stderr)
            return -1
        from gencore_tpu.parallel.streaming import StreamingBam, run_streaming
        try:
            sb0 = StreamingBam(opt.input)
        except (ValueError, RuntimeError, OSError):
            if args.stream:
                raise
            sb0 = None  # auto-selected but not BGZF: in-memory path below
            use_stream = False
    if use_stream:
        from gencore_tpu.io.bed import BedRegions
        buf0, _ = sb0._read_span(0, min(1 << 20, sb0.total))
        sb0._parse_header(buf0)
        bed = None
        if opt.bed_file:
            bed = BedRegions.load(opt.bed_file, sb0.header.names)
            opt.has_bed_file = True
        devices = None
        if args.devices > 1:
            import jax
            devices = jax.local_devices()[:args.devices]
        stage_sum = {} if opt.debug else None
        out_path = opt.output
        if out_path == "-":
            # incremental BGZF writes are sequential appends: route them
            # straight to stdout (reference gencore.cpp:170-173)
            sys.stdout.flush()
            out_path = "/dev/stdout"
        from gencore_tpu.utils.tracing import maybe_jax_trace
        with maybe_jax_trace():
            header, pre_stats, post_stats = run_streaming(
                opt, opt.input, out_path, fasta=fasta, bed=bed,
                n_windows=args.windows, devices=devices,
                stage_totals=stage_sum)
        _print_stage_totals(stage_sum)
        print("----Before gencore processing:", file=sys.stderr)
        pre_stats.print_summary(sys.stderr)
        print("\n----After gencore processing:", file=sys.stderr)
        post_stats.print_summary(sys.stderr)
        write_json_report(opt.json_file, opt, pre_stats, post_stats, command)
        write_html_report(opt.html_file, opt, pre_stats, post_stats, command)
        t2 = time.time()
        print(f"\n{command}", file=sys.stderr)
        print(f"gencore-tpu v{__version__}, time used: {t2 - t1:.1f} seconds",
              file=sys.stderr)
        return 0

    from gencore_tpu.io.sam import open_alignment
    reader = open_alignment(opt.input)
    header = reader.header

    bed = None
    if opt.bed_file:
        bed = BedRegions.load(opt.bed_file, header.names)
        opt.has_bed_file = True

    class _MergedResult:
        def __init__(self, pre, post):
            self.pre_stats = pre
            self.post_stats = post

    # only a name ending in "sam" gets text mode; `-o -` writes BAM to
    # stdout exactly like the reference (gencore.cpp:170-173)
    sam_out = opt.output.endswith("sam")
    from gencore_tpu.utils.tracing import maybe_jax_trace
    _trace_ctx = maybe_jax_trace()
    _trace_ctx.__enter__()
    if args.shards > 1 and not args.oracle:
        from gencore_tpu.parallel import windows as win

        tables, pre_stats, post_stats = win.run_sharded(
            opt, reader.read_all(), header, fasta=fasta, bed=bed,
            n_shards=args.shards,
            checkpoint_dir=args.checkpoint_dir or None)
        engine = _MergedResult(pre_stats, post_stats)
        outs = win.merged_records(tables)
    elif args.oracle:
        from gencore_tpu.core.oracle import OracleEngine as EngineCls
        engine = EngineCls(opt, header, fasta=fasta, bed=bed)
        outs = engine.run(reader.read_all())
    else:
        from gencore_tpu.engine import VectorEngine
        batch = reader.read_all()
        use_pipeline = (args.windows != 1 and opt.max_contig == 0
                        and (args.windows > 1 or args.devices > 1
                             or batch.n >= 80_000))
        if use_pipeline:
            from gencore_tpu.io import native as _native
            from gencore_tpu.parallel import pipeline as pipe
            devices = None
            if args.devices > 1:
                import jax
                devices = jax.local_devices()[:args.devices]
            stage_sum = {} if opt.debug else None
            out_writer = None
            if (not sam_out and opt.output != "-"
                    and _native.get_lib() is not None):
                # incremental per-window BGZF writes overlap compression
                # with later windows' host/device work
                from gencore_tpu.parallel.streaming import StreamingBamWriter
                out_writer = StreamingBamWriter(opt.output, header)
            try:
                tables, pre_stats, post_stats = pipe.run_pipelined(
                    opt, batch, header, fasta=fasta, bed=bed,
                    n_windows=args.windows, devices=devices,
                    stage_totals=stage_sum, out_writer=out_writer)
            except BaseException:
                # the incremental writer truncated the output at start;
                # don't leave a corrupt EOF-less partial file behind
                if out_writer is not None:
                    try:
                        os.remove(opt.output)
                    except OSError:
                        pass
                raise
            _print_stage_totals(stage_sum)
            engine = _MergedResult(pre_stats, post_stats)
            if out_writer is not None:
                out_writer.close()
                outs = None
            elif sam_out:
                from gencore_tpu.parallel import windows as win
                outs = win.merged_records(tables)
            else:
                outs = pipe.merged_payload(tables)
        else:
            engine = VectorEngine(opt, header, fasta=fasta, bed=bed)
            outs = engine.run(batch)
    _trace_ctx.__exit__(None, None, None)

    if outs is not None:
        if sam_out:
            from gencore_tpu.io.sam import SamWriter
            writer = SamWriter(opt.output, header)
        else:
            writer = bamio.BamWriter(opt.output, header)
        import numpy as _np
        if isinstance(outs, _np.ndarray):
            writer.write_payload(outs)
        elif hasattr(outs, "build_payload"):
            writer.write_table(outs)
        elif outs and isinstance(outs[0], bytes):
            for body in outs:
                writer.write_record(body)
        else:
            for r in outs:
                writer.write_record(r.encode())
        writer.close()

    if opt.debug and hasattr(engine, "timer"):
        for line in engine.timer.report_lines():
            print(line, file=sys.stderr)

    print("----Before gencore processing:", file=sys.stderr)
    engine.pre_stats.print_summary(sys.stderr)
    print("\n----After gencore processing:", file=sys.stderr)
    engine.post_stats.print_summary(sys.stderr)

    write_json_report(opt.json_file, opt, engine.pre_stats, engine.post_stats, command)
    write_html_report(opt.html_file, opt, engine.pre_stats, engine.post_stats, command)

    t2 = time.time()
    print(f"\n{command}", file=sys.stderr)
    print(f"gencore-tpu v{__version__}, time used: {t2 - t1:.1f} seconds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
