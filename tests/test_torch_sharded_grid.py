"""The tick engine's sharded grid: ``torch_engine.run_grid(sharded=)`` at 2
gloo ranks, the twin of the reference's ``_get_sharded_runner`` (the cell
axis split over a 1-D mesh; ``tests/test_jax_engine.py``'s
``test_sharded_grid_parity_subprocess``, whose engine does not import under
the installed jax).

Both ranks run in processes of their own (``tests/torch_dist_workers.py``,
a gloo group through a ``FileStore``) on four zoo scenarios of three archs
over 120 ticks under ``portfolio``.  Cells never communicate, so every cell
of a sharded run must equal the unsharded run's bit for bit, on every rank.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import pytest

import torch_dist_workers as workers
from repro_torch.core.sim import torch_engine as te
from repro_torch.distributed import device_mesh


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks returned, by (cells, sharded)."""
    out = str(tmp_path_factory.mktemp("grid"))
    workers.finish(workers.start_ranks("grid", 2, out), out)
    res = []
    for rank in range(2):
        with open(os.path.join(out, f"grid.rank{rank}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def assert_bit_equal(a, b, path="cell"):
    """Equal leaf by leaf: arrays by ``assert_array_equal`` (NaN equal to
    NaN), numbers by ``==``."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_bit_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{path}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("n_cells", [2, 4])
def test_sharded_grid_is_bit_equal_to_one_dispatch(ranks, n_cells):
    unsharded = ranks[0][(n_cells, False)]["cells"]
    assert len(unsharded) == n_cells
    for res in ranks:
        assert_bit_equal(res[(n_cells, True)]["cells"], unsharded)
        assert_bit_equal(res[(n_cells, False)]["cells"], unsharded)


@pytest.mark.parametrize("n_cells", [2, 4])
def test_each_rank_runs_its_own_contiguous_cells(ranks, n_cells):
    half = n_cells // 2
    for rank, res in enumerate(ranks):
        assert res[(n_cells, True)]["ran"] == [(rank * half, (rank + 1) * half)]
        assert res[(n_cells, False)]["ran"] == [(0, n_cells)]


def test_auto_mode_shards_when_the_ranks_divide_the_cells(ranks):
    for rank, res in enumerate(ranks):
        assert res[(4, None)]["ran"] == [(2 * rank, 2 * rank + 2)]
        assert_bit_equal(res[(4, None)]["cells"], ranks[0][(4, False)]["cells"])


def test_indivisible_cells_run_whole_by_the_rule_and_refuse_sharded(ranks):
    for res in ranks:
        assert res[(3, None)]["ran"] == [(0, 3)]
        assert_bit_equal(res[(3, None)]["cells"], ranks[0][(4, False)]["cells"][:3])
        assert res[(3, True)]["cells"].startswith("ValueError: sharded run_grid needs a cell count (3)")
        assert res[(3, True)]["ran"] == []


def test_device_mesh_is_one_axis_over_the_group(ranks):
    for res in ranks:
        assert res["mesh"] == (("grid",), 2, "cpu")


def test_without_a_group_the_grid_is_one_dispatch_and_sharded_raises():
    arrs, seeds = workers.grid_inputs()
    wl = workers.grid_workload()
    assert device_mesh() is None
    with pytest.raises(ValueError, match="process group"):
        te.run_grid(arrs[:2], wl, "portfolio", seeds=seeds[:2], sharded=True, device="cpu")
    auto = te.run_grid(arrs[:2], wl, "portfolio", seeds=seeds[:2], device="cpu")
    assert_bit_equal(auto, te.run_grid(arrs[:2], wl, "portfolio", seeds=seeds[:2],
                                       sharded=False, device="cpu"))
