"""``launch.ranks.RankPool``: ranks started once that run one function
after another in one process group (gloo, on the CPU), and ``run_ranks``,
a pool of one function."""
import os

import pytest
import torch

from repro_torch.launch.ranks import RankPool, run_ranks


def _sum_of_ranks(rank: int, scale: int):
    """Every rank's (rank + 1) * scale, summed over the group."""
    x = torch.tensor([float((rank + 1) * scale)])
    torch.distributed.all_reduce(x)
    return rank, os.getpid(), float(x)


def _fail_on(rank: int, bad: int):
    if rank == bad:
        raise ValueError(f'planted failure on rank {rank}')
    return rank


def test_pool_runs_functions_in_turn_on_the_same_ranks(tmp_path):
    with RankPool(2, store_dir=tmp_path, timeout_s=60) as pool:
        first = pool.run(_sum_of_ranks, (1,))
        second = pool.run(_sum_of_ranks, (10,))
    # results in rank order, the group's collectives working in both
    assert [r[0] for r in first] == [0, 1] and [r[0] for r in second] == [0, 1]
    assert [r[2] for r in first] == [3.0, 3.0]
    assert [r[2] for r in second] == [30.0, 30.0]
    # the same processes ran both
    assert [r[1] for r in first] == [r[1] for r in second]
    assert len({r[1] for r in first}) == 2
    assert pool.closed


@pytest.mark.parametrize('bad', [0, 1])
def test_a_failed_rank_fails_the_run_and_closes_the_pool(tmp_path, bad):
    pool = RankPool(2, store_dir=tmp_path, timeout_s=60)
    assert pool.run(_fail_on, (-1,)) == [0, 1]
    with pytest.raises(RuntimeError, match=f'rank {bad} failed'):
        pool.run(_fail_on, (bad,))
    assert pool.closed
    assert not any(p.is_alive() for p in pool._procs)
    with pytest.raises(RuntimeError, match='closed'):
        pool.run(_fail_on, (-1,))


def test_run_ranks_starts_ranks_for_one_function(tmp_path):
    out = run_ranks(_sum_of_ranks, 2, store_dir=tmp_path, args=(2,),
                    timeout_s=60)
    assert [(r[0], r[2]) for r in out] == [(0, 6.0), (1, 6.0)]
    with pytest.raises(RuntimeError, match='rank 1 failed'):
        run_ranks(_fail_on, 2, store_dir=tmp_path, args=(1,), timeout_s=60)


def test_submit_returns_at_once_and_collect_waits(tmp_path):
    """``submit`` starts a function and returns while the ranks work;
    ``collect`` gives its results in rank order; a second ``submit``
    before that ``collect``, and a ``collect`` with nothing submitted,
    raise."""
    with RankPool(2, store_dir=tmp_path, timeout_s=60) as pool:
        pool.submit(_sum_of_ranks, (4,))
        with pytest.raises(RuntimeError, match='collect'):
            pool.submit(_sum_of_ranks, (1,))
        assert [(r[0], r[2]) for r in pool.collect()] == [(0, 12.0),
                                                          (1, 12.0)]
        with pytest.raises(RuntimeError, match='no function submitted'):
            pool.collect()
        assert [r[2] for r in pool.run(_sum_of_ranks, (1,))] == [3.0, 3.0]
