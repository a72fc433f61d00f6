"""The port's ``train/hiplogs.py`` against the JAX package's on one tree of
``hip.log`` files written by the port's ``Logger`` (two small offline runs,
each with its train and eval rows and its ``config.json``): the same
datapoints, CSV and JSON, the same summary records, the same CLI output."""

import json

import pytest
import torch

from controllable_agent_tpu.train import hiplogs as jax_hiplogs
from controllable_agent_torch.train import hiplogs
from torch_small_run import small_run


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("hip")
    small_run(root / "runs" / "a")
    small_run(root / "runs" / "b", "seed=2", steps=15)
    return root / "runs"


def _points(exp) -> list:
    return [(dp.uid, dp.from_uid, dp.values) for dp in exp.datapoints]


@pytest.mark.parametrize("step", [1, 2])
def test_load_matches_jax(tree, tmp_path, step) -> None:
    got, want = hiplogs.load(tree, step=step), jax_hiplogs.load(tree, step=step)
    assert _points(got) == _points(want)
    assert {dp.values["experiment"] for dp in got.datapoints} == {"a", "b"}
    assert any("train_fps" in dp.values for dp in got.datapoints)
    assert any("eval_episode_reward" in dp.values for dp in got.datapoints)
    assert got.to_json() == want.to_json()
    got.to_csv(tmp_path / "got.csv")
    want.to_csv(tmp_path / "want.csv")
    assert (tmp_path / "got.csv").read_text() == (tmp_path / "want.csv").read_text()


def test_aggregate_tree_and_hiplog_match_jax(tree) -> None:
    got = hiplogs.aggregate_tree(tree)
    assert got == jax_hiplogs.aggregate_tree(tree) and len(got) == 2
    log = tree / "a" / "hip.log"
    assert hiplogs.HipLog(log).read() == jax_hiplogs.HipLog(log).read()
    assert hiplogs.HipLog(log).last() == jax_hiplogs.HipLog(log).last()


def test_csv_experiment_matches_jax(tree) -> None:
    path = tree / "a" / "eval.csv"
    assert _points(hiplogs.create_csv_experiment(path)) == \
        _points(jax_hiplogs.create_csv_experiment(path))


def test_cli_matches_jax(tree, capsys) -> None:
    hiplogs.main([str(tree), "--step", "2"])
    printed = capsys.readouterr().out
    files = {name: (tree / name).read_text()
             for name in ("hiplot_experiment.csv", "hiplot_experiment.json")}
    jax_hiplogs.main([str(tree), "--step", "2"])
    assert capsys.readouterr().out == printed
    for name, text in files.items():
        assert (tree / name).read_text() == text
    assert printed.startswith("merged 2 experiments")
    assert len(json.loads(files["hiplot_experiment.json"])["datapoints"]) > 2
    hiplogs.main(["--help"])
    assert "usage: python -m controllable_agent_torch.train.hiplogs" in capsys.readouterr().out
