"""Device-mesh sharding for the consensus engine.

The reference is single-threaded (SURVEY.md §2: no parallelism of any kind);
this module is the engine's device scaling layer:

  * data parallelism: consensus jobs (the [J, K, L] cluster tensors) are
    sharded over the mesh's "jobs" axis — jobs are embarrassingly parallel;
  * genome-axis parallelism ("sequence parallelism" for this domain):
    coordinate windows shard over the "win" axis; each window's stats are
    partial sums merged with psum-style collectives (XLA inserts them from
    the sharding annotations — the recommended pattern over hand-written
    collectives);
  * multi-host: each host feeds its own genomic windows (io-level sharding);
    cross-host stat merging reuses the same reductions.

Kernels themselves (core.kernels) are elementwise/reduction dataflow over
the J axis, so sharding J is a pure scale-out: no cross-job communication
exists until the final stat reduction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gencore_tpu.core import kernels


def make_mesh(n_devices: int | None = None, axis: str = "jobs") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def job_sharding(mesh: Mesh):
    """Jobs sharded over every mesh axis (J is the leading dim of all job
    tensors)."""
    return NamedSharding(mesh, P(mesh.axis_names))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


@functools.partial(jax.jit, static_argnames=("opt_key",))
def _consensus_with_stats(seq, qual, score, valid, pos_valid, refbase, opt_key):
    hi, mod, lo, bsr, rnum, rden = opt_key
    new_seq, new_qual, diff, minc = kernels.consensus_kernel(
        seq, qual, score, valid, pos_valid, refbase,
        hi=hi, mod=mod, lo=lo, base_score_req=bsr, ratio_num=rnum, ratio_den=rden)
    # global reductions over the sharded J axis -> XLA inserts psum
    total_diff = diff.sum()
    total_minc_rolled_back = (minc > 5).sum()
    return new_seq, new_qual, diff, minc, total_diff, total_minc_rolled_back


def sharded_consensus_step(mesh: Mesh, seq, qual, score, valid, pos_valid,
                           refbase, opt):
    """Run the voting kernel with job tensors sharded over the mesh.

    J must be a multiple of the mesh size (callers pad with invalid jobs).
    """
    rnum, rden = kernels.ratio_fraction(opt.score_percent_req)
    opt_key = (opt.high_quality, opt.moderate_quality, opt.low_quality,
               opt.base_score_req, rnum, rden)
    js = job_sharding(mesh)
    put = lambda x: jax.device_put(x, js)
    args = [put(x) for x in (seq, qual, score, valid, pos_valid, refbase)]
    return _consensus_with_stats(*args, opt_key=opt_key)


def stats_psum(mesh: Mesh, partials):
    """All-reduce partial stat vectors across the mesh (collectives)."""
    js = NamedSharding(mesh, P(mesh.axis_names[0]))

    @jax.jit
    def reduce_fn(x):
        return x.sum(axis=0)

    x = jax.device_put(jnp.asarray(partials), js)
    return reduce_fn(x)


# NOTE: production multi-chip runs shard coordinate WINDOWS over chips
# (parallel.pipeline round-robin / parallel.distributed across hosts) with
# each window's device programs pinned per chip — that layout keeps the
# resident read matrices chip-local, so no intra-window collective exists
# to express here. This module therefore carries only what production and
# the driver dryrun actually use: mesh construction, job-axis sharding for
# the standalone consensus kernel (sharded_consensus_step — the pure
# scale-out form, validated by tests/test_parallel.py), and the psum stat
# reduction.
