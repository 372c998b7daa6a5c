"""The port's multi-process layer (``parallel/multihost.py``) and the
multi-process evaluator, on the CPU under gloo.

- ``process_slice`` and ``shard_items`` are JAX's partition over a grid of
  (n, p); one process is rank 0 of 1 and joins no group;
- two real ranks (``tests/torch_dist_worker.py``, run under ``python -O``
  so that no check is an assert): ``all_processes_agree`` holds on equal
  arrays and fails on different ones, ``broadcast_from_zero`` gives rank 0's
  value, and an epoch plan that drifted on one rank raises in
  ``place_plan_on_mesh`` on both;
- ``lstm_cli`` and ``classical_cli`` over two ranks on a split of three
  test datasets (unequal shares) write the files one process writes and
  score once (rank 0); run again, they find the predictions (rank 0's
  decision, broadcast) and score; ``--fill_missing`` with two ranks raises.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_tpu.parallel import multihost as jmh
from trajnetplusplusbaselines_torch.evaluator import lstm_cli
from trajnetplusplusbaselines_torch.models.lstm import LSTMPredictor
from trajnetplusplusbaselines_torch.parallel import multihost
from trajnetplusplusbaselines_torch.utils.checkpoint import save_predictor
from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

from . import torch_dist_worker as worker
from .helpers import make_synthetic_dataset

DATASETS = ("a", "b", "c")  # three test datasets: ranks of two get 2 and 1


@pytest.mark.parametrize("p", [1, 2, 3, 4, 7])
def test_process_slice_and_shard_items_match_jax(p):
    for n in range(0, 23):
        items = list(range(n))
        shares = [multihost.shard_items(items, r, p) for r in range(p)]
        for r in range(p):
            assert multihost.process_slice(n, r, p) == jmh.process_slice(n, r, p)
            assert shares[r] == jmh.shard_items(items, r, p)
        assert sum(shares, []) == items  # every item once, in order
        assert max(map(len, shares)) - min(map(len, shares)) <= 1


def test_one_process_pays_nothing(monkeypatch):
    """Without the launcher's environment, or with a world of one, no
    process group starts: rank 0 of 1, the device as asked, the
    collectives' host decisions as they are."""
    for world in (None, "1"):
        if world is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", world)
        assert multihost.init_from_env("cpu") == torch.device("cpu")
        assert not torch.distributed.is_initialized()
        assert multihost.process_info() == (0, 1)
        assert multihost.all_processes_agree(np.arange(3))
        assert multihost.broadcast_from_zero("x") == "x"
        assert multihost.collective_route("cpu") is None
        assert multihost.shard_items([1, 2, 3]) == [1, 2, 3]


def test_a_rank_without_its_card_raises(monkeypatch):
    """Under the launcher, a rank asked for a card where there is none
    raises: it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.init_from_env("cuda")
    assert not torch.distributed.is_initialized()


class _Rank:
    """Rank (data 1, model 0) of a (2, 2) layout, without a process group."""

    shape = {"data": 2, "model": 2}
    index = {"data": 1, "model": 0}
    device = torch.device("cpu")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_put_global_is_this_ranks_block(as_tensor):
    """``put_global`` of a host array or a tensor: the rank's block along
    the sharded axis (the shard JAX's ``put_global`` materialises), the
    whole array where replicated; an axis that does not divide raises."""
    from trajnetplusplusbaselines_torch.parallel import mesh

    xy = np.arange(4 * 4 * 2, dtype=np.float32).reshape(4, 4, 2)
    arr = torch.from_numpy(xy) if as_tensor else xy
    got = multihost.put_global(mesh.batch_sharding(_Rank()), arr)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), xy[:, 2:4])
    np.testing.assert_array_equal(
        multihost.put_global(mesh.scene_sharding(_Rank()), arr).numpy(), xy[2:4])
    np.testing.assert_array_equal(
        multihost.put_global(mesh.replicated(_Rank()), arr).numpy(), xy)
    tree = multihost.put_global_tree(lambda leaf: mesh.Sharding(_Rank(), 1, "model"),
                                     {"w": arr, "b": [arr]})
    np.testing.assert_array_equal(tree["b"][0].numpy(), xy[:, 0:2])  # model index 0
    with pytest.raises(ValueError, match="does not divide"):
        multihost.put_global(mesh.scene_sharding(_Rank()), arr[:3])


def _write_split(root):
    """DATA_BLOCK/split with test datasets ``DATASETS`` (``make_synthetic_dataset``'s
    scenes, 3, 4 and 5 of them) and a model pickle beside it."""
    for k, name in enumerate(DATASETS):
        tmp = os.path.join(root, "tmp_" + name)
        make_synthetic_dataset(tmp, n_scenes=3 + k)
        for subset in ("test", "test_private"):
            dest = os.path.join(root, "DATA_BLOCK", "split", subset)
            os.makedirs(dest, exist_ok=True)
            shutil.move(os.path.join(tmp, subset, "synth.ndjson"),
                        os.path.join(dest, name + ".ndjson"))
        shutil.rmtree(tmp)
    save_predictor(LSTMPredictor(worker.lstm_model(),
                                 params_from_jax(worker.initial_params("lstm"))),
                   os.path.join(root, "model.pkl"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("ranks"))
    with open(os.path.join(outdir, "inputs.pkl"), "wb") as f:
        pickle.dump({"lstm": worker.initial_params("lstm")}, f)
    _write_split(os.path.join(outdir, "serve"))
    worker.launch(2, outdir, ["agree", "plan_drift", "serve"], python_flags=("-O",))
    return outdir


def test_all_processes_agree_in_two_ranks(two_ranks):
    for rank in range(2):
        got = worker.result(two_ranks, "agree", rank)
        assert got["info"] == (rank, 2)
        assert got["equal"] and not got["different"] and not got["reshaped"]
        assert got["broadcast"] == {"rank": 0}


def test_plan_drift_raises_under_python_O(two_ranks):
    for rank in range(2):
        assert worker.result(two_ranks, "plan_drift", rank) == (
            "epoch plan differs across processes (seed drift?)")


def test_driver_over_two_ranks_writes_what_one_rank_writes(two_ranks, tmp_path, monkeypatch):
    _write_split(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    want = lstm_cli.main(["--path", "split", "--output", "model.pkl", "--device", "cpu",
                          "--batch_scenes", "2"])
    pred = "DATA_BLOCK/split/test_pred/model_modes1"
    assert sorted(os.listdir(pred)) == [d + ".ndjson" for d in DATASETS]
    for name in DATASETS:
        with open(os.path.join(pred, name + ".ndjson")) as f:
            one = f.read().splitlines()
        with open(os.path.join(two_ranks, "serve", pred, name + ".ndjson")) as f:
            two = f.read().splitlines()
        assert two == one and one
    assert not os.path.exists(os.path.join(two_ranks, "serve", pred + ".tmp"))
    served = [worker.result(two_ranks, "serve", rank) for rank in range(2)]
    assert served[0]["scored"] and not served[1]["scored"]  # rank 0 scores, once
    assert served[0]["results"] == want.results
    # run again, the predictions found (rank 0's decision, broadcast): scored only
    assert served[0]["again"] == want.results and served[1]["again"] is None


def test_classical_cli_over_two_ranks_writes_what_one_rank_writes(two_ranks, tmp_path,
                                                                    monkeypatch):
    from trajnetplusplusbaselines_torch.evaluator import classical_cli

    _write_split(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    want = classical_cli.main(["--path", "split", "--cv", "--device", "cpu"])
    pred = "DATA_BLOCK/split/test_pred/cv_modes1"
    for name in DATASETS:
        with open(os.path.join(pred, name + ".ndjson")) as f, \
                open(os.path.join(two_ranks, "serve", pred, name + ".ndjson")) as g:
            assert g.read() == f.read()
    served = [worker.result(two_ranks, "serve", rank)["cv"] for rank in range(2)]
    assert served[0] == want.results and served[1] is None


def test_fill_missing_with_two_ranks_raises(two_ranks):
    for rank in range(2):
        assert worker.result(two_ranks, "serve", rank)["fill_missing"] == (
            "--fill_missing is a single-process backfill mode")
