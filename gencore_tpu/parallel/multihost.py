"""Multi-host (multi-process) window-sharded execution.

Each "host" process owns a subset of coordinate shards: it decodes the BAM,
computes the global checkpoint (deterministic from the stream, so no
coordination needed), runs its shards, and writes payload/keys/stats files.
A merger concatenates outputs in bamComp order and sums stats — the
cross-host reduction that an allreduce would perform.

This is the host-level scaling entry point (SURVEY.md §2 parallelism
inventory: coordinate-window data parallelism); the in-process form lives
in parallel/windows.py.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

from gencore_tpu.options import Options
from gencore_tpu.stats import Stats


def run_host(opt: Options, bam_path: str, fasta_path: str, shard_ids: list,
             n_shards: int, out_dir: str, host_id: int):
    """Run one host's shards; writes shard_<k>.{payload,keys.npy,stats.pkl}
    plus host_<h>.time (in-process wall of decode+compute, excluding
    interpreter/jax import — the scaling-efficiency numerator)."""
    import time as _time
    _t0 = _time.perf_counter()
    from gencore_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    from gencore_tpu.engine import VectorEngine
    from gencore_tpu.io import bam as bamio
    from gencore_tpu.io.fasta import FastaRef
    from gencore_tpu.parallel import windows

    fasta = FastaRef.load(fasta_path) if fasta_path else None
    reader = bamio.BamReader(bam_path)
    batch = reader.read_all()
    header = reader.header

    if opt.umi_prefix == "auto":
        qn0 = batch.qname(0).decode("latin-1") if batch.n else ""
        opt.umi_prefix = ("umi" if "umi_" in qn0
                          else "UMI" if "UMI_" in qn0 else "")

    ck = windows.global_checkpoint(batch)
    wm = windows.global_watermark(batch, header.lengths)
    kind, left = windows.cluster_left_keys(batch)
    tlen = np.array(header.lengths, dtype=np.int64)
    base = np.zeros(len(tlen) + 1, dtype=np.int64)
    np.cumsum(tlen, out=base[1:])
    coord = base[np.clip(batch.tid.astype(np.int64), 0, len(tlen) - 1)] + left
    span = (int(base[-1]) + n_shards - 1) // n_shards
    shard = np.clip(coord // max(span, 1), 0, n_shards - 1)

    os.makedirs(out_dir, exist_ok=True)
    for s in shard_ids:
        own = (kind > 0) & (shard == s)
        idx = np.nonzero(own)[0]
        if len(idx) == 0:
            continue
        sub = windows.subset_batch(batch, idx)
        eng = VectorEngine(opt, header, fasta=fasta)
        table = eng.run(sub, checkpoint=ck, watermark=wm, count_pre_reads=False)
        table.build_payload().tofile(os.path.join(out_dir, f"shard_{s}.payload"))
        np.save(os.path.join(out_dir, f"shard_{s}.keys.npy"), table.record_keys())
        with open(os.path.join(out_dir, f"shard_{s}.stats.pkl"), "wb") as f:
            pickle.dump((eng.pre_stats, eng.post_stats), f)

    with open(os.path.join(out_dir, f"host_{host_id}.time"), "w") as f:
        f.write(f"{_time.perf_counter() - _t0:.6f}")

    # host 0 also records the global per-read pre-stats
    if host_id == 0:
        probe = VectorEngine(opt, header, fasta=None)
        nm, _ = probe._extract_nm(batch, batch.n)
        pre = Stats(opt.coverage_step, header.names, header.lengths)
        pre.add_reads_vectorized(batch.tid.astype(np.int64),
                                 batch.pos.astype(np.int64),
                                 batch.l_qseq.astype(np.int64), nm)
        with open(os.path.join(out_dir, "global_pre.pkl"), "wb") as f:
            pickle.dump(pre, f)


def merge_hosts(out_dir: str, n_shards: int, header):
    """Merge shard outputs into (sorted record bodies, pre, post stats)."""
    from gencore_tpu.parallel.windows import LoadedShard

    with open(os.path.join(out_dir, "global_pre.pkl"), "rb") as f:
        pre = pickle.load(f)
    post = Stats(pre.coverage_step, header.names, header.lengths, is_post=True)
    recs = []
    for s in range(n_shards):
        pp = os.path.join(out_dir, f"shard_{s}.payload")
        if not os.path.exists(pp):
            continue
        payload = np.fromfile(pp, dtype=np.uint8)
        keys = np.load(os.path.join(out_dir, f"shard_{s}.keys.npy"))
        with open(os.path.join(out_dir, f"shard_{s}.stats.pkl"), "rb") as f:
            spre, spost = pickle.load(f)
        pre.cluster += spre.cluster
        pre.multi_molecule_cluster += spre.multi_molecule_cluster
        pre.molecule += spre.molecule
        pre.molecule_se += spre.molecule_se
        pre.molecule_pe += spre.molecule_pe
        pre.supporting_histogram += spre.supporting_histogram
        pre.uncounted_supporting_reads += spre.uncounted_supporting_reads
        post.merge_from(spost)
        shard_obj = LoadedShard(payload, keys)
        for body, key in zip(shard_obj.encoded_records(), keys):
            recs.append((tuple(key), body))
    recs.sort(key=lambda kb: kb[0])
    return [b for _, b in recs], pre, post


def host_envs(n_hosts: int, env=None, cards=None):
    """One environment per host process. On a GPU host each process takes
    its own card (CUDA_VISIBLE_DEVICES=cards[h]): a JAX process reserves
    most of a card's memory when it starts, so two on one card fail.
    cards None (a CPU run, JAX_PLATFORMS=cpu) leaves the devices alone."""
    base = dict(os.environ if env is None else env)
    if cards is None:
        return [dict(base) for _ in range(n_hosts)]
    if n_hosts > len(cards):
        raise ValueError(f"{n_hosts} host processes but only {len(cards)} "
                         "GPUs: one process per card")
    return [dict(base, CUDA_VISIBLE_DEVICES=cards[h]) for h in range(n_hosts)]


def visible_cards(env=None) -> list[str] | None:
    """The cards this process may hand out, as CUDA_VISIBLE_DEVICES
    entries: None when JAX_PLATFORMS names another platform than the GPU;
    the inherited CUDA_VISIBLE_DEVICES list when that is set (a job given
    cards 4-7 hands out 4-7, not 0-3); else the cards nvidia-smi lists
    (none if it cannot run). Asked without importing JAX, so this process
    never opens a card."""
    env = os.environ if env is None else env
    plat = env.get("JAX_PLATFORMS", "").split(",")[0]
    if plat not in ("", "gpu", "cuda"):
        return None
    if "CUDA_VISIBLE_DEVICES" in env:
        return [c.strip() for c in env["CUDA_VISIBLE_DEVICES"].split(",")
                if c.strip()]
    try:
        cp = subprocess.run(["nvidia-smi", "--query-gpu=index",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return cp.stdout.split() if cp.returncode == 0 else []


def spawn_hosts(opt_kwargs: dict, bam_path: str, fasta_path: str,
                n_hosts: int, n_shards: int, out_dir: str, env=None,
                pin_cores=None):
    """Launch n_hosts subprocesses, round-robin shard assignment; wait.
    Host h runs on the h-th visible card (see host_envs). pin_cores: optional list of
    CPU core ids — host h is pinned to pin_cores[h] via taskset, giving
    disjoint-core scaling numbers."""
    envs = host_envs(n_hosts, env, visible_cards(env))
    procs = []
    for h in range(n_hosts):
        shard_ids = list(range(h, n_shards, n_hosts))
        code = (
            "import sys, json;"
            "sys.path.insert(0, %r);"
            "from gencore_tpu.options import Options;"
            "from gencore_tpu.parallel.multihost import run_host;"
            "run_host(Options(**json.loads(%r)), %r, %r, %r, %r, %r, %r)"
            % (os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
               __import__("json").dumps(opt_kwargs), bam_path, fasta_path,
               shard_ids, n_shards, out_dir, h))
        argv = [sys.executable, "-c", code]
        if pin_cores is not None:
            argv = ["taskset", "-c", str(pin_cores[h % len(pin_cores)])] + argv
        procs.append(subprocess.Popen(argv, env=envs[h]))
    for p in procs:
        rc = p.wait()
        if rc != 0:
            raise RuntimeError(f"host process failed with {rc}")


def host_times(out_dir: str, n_hosts: int):
    """Per-host in-process wall times written by run_host."""
    out = []
    for h in range(n_hosts):
        p = os.path.join(out_dir, f"host_{h}.time")
        with open(p) as f:
            out.append(float(f.read()))
    return out
