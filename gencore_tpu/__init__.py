"""gencore_tpu — a consensus-read engine on JAX.

A JAX/XLA framework with the capabilities of OpenGene/gencore:
it streams a coordinate-sorted BAM, clusters reads by mapping position and UMI,
collapses each cluster into an error-suppressed consensus read via
quality-weighted per-position base voting with reference-genome arbitration,
merges forward/reverse single-strand consensuses into duplex consensus reads,
and emits a processed BAM (with FR/RR tags) plus JSON/HTML QC reports.

Reformulated as batch dataflow for an accelerator:
  * host-side C++ BGZF/BAM/FASTA I/O core (native/gcio.cpp) with a pure-Python
    fallback codec,
  * vectorized hash-and-sort position+UMI clustering,
  * dense consensus kernels (JAX/XLA) over padded read-cluster tensors,
  * on-device statistics merged across a jax.sharding.Mesh via collectives.

Reference behavior spec: /root/reference (OpenGene/gencore); layer map and
component inventory in SURVEY.md.
"""

__version__ = "0.1.0"
