"""multiprocessing.Pool + joblib backend shims of ray_tpu_torch (copies of
tests/test_ecosystem_shims.py; reference analogues:
``python/ray/util/multiprocessing`` and ``python/ray/util/joblib``)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.multiprocessing import Pool


@pytest.fixture
def rtpu_init():
    """The port's runtime per test, as conftest's is ray_tpu's."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


def _sq(x):
    return x * x


def _addmul(a, b):
    return a + b, a * b


def _flaky(x):
    if x == 3:
        raise ValueError("three is right out")
    return x


def test_pool_map(rtpu_init):
    with Pool(processes=4) as p:
        assert p.map(_sq, range(10)) == [x * x for x in range(10)]


def test_pool_starmap_and_apply(rtpu_init):
    with Pool(processes=2) as p:
        assert p.starmap(_addmul, [(1, 2), (3, 4)]) == [(3, 2), (7, 12)]
        assert p.apply(_sq, (6,)) == 36


def test_pool_async_and_callbacks(rtpu_init):
    got = []
    with Pool(processes=2) as p:
        res = p.map_async(_sq, range(6), callback=got.append)
        assert res.get(timeout=60) == [0, 1, 4, 9, 16, 25]
        assert res.successful()
        assert got and got[0] == [0, 1, 4, 9, 16, 25]

        r2 = p.apply_async(_sq, (7,))
        assert r2.get(timeout=60) == 49


def test_pool_imap_ordered_and_unordered(rtpu_init):
    with Pool(processes=2) as p:
        assert list(p.imap(_sq, range(8), chunksize=2)) == \
            [x * x for x in range(8)]
        assert sorted(p.imap_unordered(_sq, range(8), chunksize=2)) == \
            sorted(x * x for x in range(8))


def test_pool_error_propagates(rtpu_init):
    with Pool(processes=2) as p:
        res = p.map_async(_flaky, range(5))
        with pytest.raises(Exception):
            res.get(timeout=60)
        assert not res.successful()


def test_pool_closed_rejects(rtpu_init):
    p = Pool(processes=2)
    p.close()
    with pytest.raises(ValueError):
        p.map(_sq, [1])


def test_joblib_backend(rtpu_init):
    import joblib
    from joblib import Parallel, delayed

    from ray_tpu_torch.util.joblib_backend import register_rtpu

    register_rtpu()
    with joblib.parallel_backend("rtpu", n_jobs=4):
        out = Parallel()(delayed(_sq)(i) for i in range(12))
    assert out == [i * i for i in range(12)]


def test_tqdm_ray_driver_and_worker(rtpu_init, capsys):
    """tqdm shim (reference: experimental/tqdm_ray.py): bars work on
    the driver, and worker bars ride the log channel as magic lines
    that render in place instead of interleaving raw prints."""
    from ray_tpu_torch.util import tqdm_ray

    # driver-side: iterate + manual update
    out = list(tqdm_ray.tqdm(range(5), desc="drv"))
    assert out == [0, 1, 2, 3, 4]
    bar = tqdm_ray.tqdm(total=10, desc="manual")
    bar.update(7)
    assert bar.n == 7
    bar.close()

    # magic-line protocol: recognized lines render, others pass through
    assert tqdm_ray.render_magic_line(
        tqdm_ray.MAGIC + '{"id": "x", "n": 3, "total": 9, '
        '"desc": "w", "closed": false}')
    assert not tqdm_ray.render_magic_line("ordinary worker print")

    # worker-side: the magic line must NOT appear as raw driver stdout
    @ray_tpu_torch.remote
    def work():
        from ray_tpu_torch.util import tqdm_ray as tq
        for _ in tq.tqdm(range(3), desc="wkr"):
            pass
        print("done-marker")
        return True

    assert ray_tpu_torch.get(work.remote())
    time.sleep(1.5)          # let the log tailer pump the lines
    captured = capsys.readouterr()
    assert tqdm_ray.MAGIC not in captured.out
