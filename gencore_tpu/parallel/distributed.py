"""Multi-process execution on the jax.distributed runtime.

Every process runs the same program, initialized with (coordinator,
num_processes, process_id); on one GPU host process p drives the p-th
visible card. This
module is that program for the consensus engine:

  * window ownership: coordinate windows round-robined over processes
    (the window plan is a pure function of the input, so no coordination
    is needed to agree on it — same trick as the global tick checkpoint);
  * each process runs the in-process window pipeline on its windows and
    writes its shard payload + bamComp keys to the shared output
    directory;
  * stats merge across processes with an allgather over the global
    device mesh (jax.experimental.multihost_utils.process_allgather),
    then process 0 merges and writes the final BAM + reports.

The subprocess-based form (parallel/multihost.py) remains for
environments without a coordinator; tests drive THIS module with real
multi-process jax.distributed on CPU (tests/test_distributed.py).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from gencore_tpu.options import Options
from gencore_tpu.stats import Stats


def runtime_kwargs(coordinator: str, num_processes: int, process_id: int,
                   cards) -> dict:
    """jax.distributed.initialize arguments. cards: the visible GPUs
    (multihost.visible_cards), None or empty off the GPU. On a GPU host
    process p takes the p-th visible card: without local_device_ids every
    process would claim every card. The processes share one machine, so a
    process id past its cards is refused rather than left to ask for a
    card that does not exist."""
    kw = dict(coordinator_address=coordinator, num_processes=num_processes,
              process_id=process_id)
    if cards:
        if process_id >= len(cards):
            raise ValueError(
                f"process {process_id} has no card: this machine shows "
                f"{len(cards)} GPUs, one process per card")
        kw["local_device_ids"] = [process_id]
    return kw


def init_runtime(coordinator: str, num_processes: int, process_id: int):
    """Bring up the jax.distributed runtime (once per process)."""
    import jax
    from gencore_tpu.parallel.multihost import visible_cards
    jax.distributed.initialize(**runtime_kwargs(
        coordinator, num_processes, process_id, visible_cards()))


def _allgather_blobs(blob: bytes):
    """Allgather one variable-length byte blob per process over the
    jax.distributed global mesh (fixed-width padded uint8 + length)."""
    import jax
    from jax.experimental import multihost_utils
    n = np.int64(len(blob))
    all_n = np.asarray(multihost_utils.process_allgather(n))
    width = int(all_n.max())
    buf = np.zeros(width, dtype=np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    all_buf = np.asarray(multihost_utils.process_allgather(buf))
    return [all_buf[i, :int(all_n[i])].tobytes()
            for i in range(all_buf.shape[0])]


def run_process(opt: Options, bam_path: str, out_dir: str,
                fasta_path: str = "", n_windows: int = 0,
                write_output: bool = True):
    """One process's share of a distributed run. Requires init_runtime
    first. Returns (pre, post) global stats on process 0, else None."""
    import jax

    pid = jax.process_index()
    nproc = jax.process_count()

    from gencore_tpu.engine import VectorEngine
    from gencore_tpu.io import bam as bamio
    from gencore_tpu.io.fasta import FastaRef
    from gencore_tpu.parallel import pipeline as pipe
    from gencore_tpu.parallel import windows as win

    fasta = FastaRef.load(fasta_path) if fasta_path else None
    reader = bamio.BamReader(bam_path)
    batch = reader.read_all()
    header = reader.header

    if opt.umi_prefix == "auto":
        qn0 = batch.qname(0).decode("latin-1") if batch.n else ""
        opt.umi_prefix = ("umi" if "umi_" in qn0
                          else "UMI" if "UMI_" in qn0 else "")

    ck = win.global_checkpoint(batch)
    wm = win.global_watermark(batch, header.lengths)
    if n_windows <= 0:
        n_windows = max(nproc, min(64, batch.n // 40_000))
    wins = pipe.plan_windows(batch, header.lengths, n_windows)

    # local windows -> local pipeline (local devices only)
    my = [w for w in range(len(wins)) if w % nproc == pid]
    local_pre = Stats(opt.coverage_step, header.names, header.lengths)
    local_post = Stats(opt.coverage_step, header.names, header.lengths,
                       is_post=True)
    os.makedirs(out_dir, exist_ok=True)
    for w in my:
        idx = wins[w]
        sub = win.subset_batch(batch, idx)
        eng = VectorEngine(Options(**{f.name: getattr(opt, f.name)
                                      for f in opt.__dataclass_fields__
                                      .values()}),
                           header, fasta=fasta)
        eng._suppress_contig_dbg = True
        table = eng.run_collect(eng.run_dispatch(
            sub, checkpoint=ck, watermark=wm, count_pre_reads=False))
        pipe._merge_window_stats(local_pre, local_post, eng)
        table.build_payload().tofile(
            os.path.join(out_dir, f"win_{w}.payload"))
        np.save(os.path.join(out_dir, f"win_{w}.keys.npy"),
                table.record_keys())

    # per-read pre-stats computed once (process 0's share of the merge)
    if pid == 0:
        probe = VectorEngine(opt, header, fasta=None)
        nm, _ = probe._extract_nm(batch, batch.n)
        local_pre.add_reads_vectorized(batch.tid.astype(np.int64),
                                       batch.pos.astype(np.int64),
                                       batch.l_qseq.astype(np.int64), nm)

    # stats reduction: allgather each process's stats blob, everyone
    # merges deterministically by process id
    blobs = _allgather_blobs(pickle.dumps((local_pre, local_post)))
    pre = Stats(opt.coverage_step, header.names, header.lengths)
    post = Stats(opt.coverage_step, header.names, header.lengths,
                 is_post=True)
    for blob in blobs:
        spre, spost = pickle.loads(blob)
        pre.cluster += spre.cluster
        pre.multi_molecule_cluster += spre.multi_molecule_cluster
        pre.molecule += spre.molecule
        pre.molecule_se += spre.molecule_se
        pre.molecule_pe += spre.molecule_pe
        pre.supporting_histogram += spre.supporting_histogram
        pre.uncounted_supporting_reads += spre.uncounted_supporting_reads
        pre.read += spre.read
        pre.base += spre.base
        pre.read_unmapped += spre.read_unmapped
        pre.base_unmapped += spre.base_unmapped
        pre.base_mismatches += spre.base_mismatches
        pre.read_with_mismatches += spre.read_with_mismatches
        for c in range(len(pre.genome_depth)):
            pre.genome_depth[c] += spre.genome_depth[c]
        post.merge_from(spost)

    if pid != 0:
        return None
    if write_output:
        recs = []
        for w in range(len(wins)):
            pp = os.path.join(out_dir, f"win_{w}.payload")
            if not os.path.exists(pp):
                # every window was assigned to some process; a missing
                # payload after the barrier means a failed shard write or
                # shared-FS visibility lag — silent record loss either way
                raise IOError(
                    f"window {w} payload missing after allgather barrier: "
                    f"{pp}")
            payload = np.fromfile(pp, dtype=np.uint8)
            keys = np.load(os.path.join(out_dir, f"win_{w}.keys.npy"))
            shard = win.LoadedShard(payload, keys)
            for body, key in zip(shard.encoded_records(), keys):
                recs.append((tuple(key), body))
        recs.sort(key=lambda kb: kb[0])
        writer = bamio.BamWriter(os.path.join(out_dir, "out.bam"), header)
        for _, body in recs:
            writer.write_record(body)
        writer.close()
    return pre, post
