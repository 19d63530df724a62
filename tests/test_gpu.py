"""Card-only checks: the device programs compiled for the GPU equal the
plain reference run on the CPU, and the engine on the GPU equals the
oracle. They skip without a GPU; `python chip_smoke.py` runs them on the
card (its phase 2 repeats the kernel checks at real widths)."""

import pytest

from chip_smoke import check_score_map, check_vote_window
from tests.test_engine_equivalence import (assert_equivalent,
                                           make_random_workload, run_both)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("L", [160, 256])
def test_gpu_vote_window_matches_cpu_reference(gpu_device, L):
    import jax
    with jax.default_device(gpu_device):
        classes = [(K, 64) for K in (4, 16, 32, 64, 128, 256)]
        assert check_vote_window(jax, L, classes, seed=L,
                                 out_len=L - 8) == 6 * 64


def test_gpu_score_map_matches_cpu_reference(gpu_device):
    import jax
    with jax.default_device(gpu_device):
        check_score_map(jax, 4096, 160, seed=3)


def test_gpu_engine_matches_oracle(gpu_device, tmp_path):
    """The engine takes its accelerator path on the card by itself."""
    import jax

    from gencore_tpu.engine import VectorEngine
    with jax.default_device(gpu_device):
        sb = make_random_workload(90, n_fragments=60, umi_mode="duplex",
                                  contig_len=300_000, n_contigs=1)
        o, v = run_both(sb, tmp_path)
    assert VectorEngine.accelerator_path is None
    assert v[0]._accelerated()
    assert_equivalent(o, v)
