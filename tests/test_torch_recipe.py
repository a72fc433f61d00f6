"""The recipe mode of ``tools/online_curve.py``: the stored runs' configs
resolved through the port's and the JAX package's config classes, the keys
the mode replaces, the comparison rule, and the mode end to end on the CPU
at tiny depth (cheetah ``pretrain``, two cycles)."""

import glob
import json
from pathlib import Path

import pytest
import torch

from controllable_agent_tpu.agents.registry import default_config as jax_default_config
from controllable_agent_tpu.config import apply_overrides as jax_apply_overrides
from controllable_agent_tpu.config import to_flat_dict as jax_to_flat_dict
from controllable_agent_tpu.train.workspace import WorkspaceConfig as JaxWorkspaceConfig
from controllable_agent_torch.config import to_flat_dict
from controllable_agent_torch.tools import online_curve
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RECIPES = sorted(Path(p).parent for p in glob.glob(str(ROOT / "results" / "*" / "config.json")))
SMALL = ["agent.hidden_dim=32", "agent.backward_hidden_dim=32", "agent.feature_dim=16",
         "agent.z_dim=8", "agent.batch_size=32", "agent.num_inference_steps=64"]
TINY = ["num_train_frames=400", "episode_length=100", "num_seed_frames=200",
        "eval_every_steps=200", "final_tests=2", "num_eval_episodes=2", "num_envs=2",
        "replay_buffer_episodes=8", "z_inference_draws=2", "use_console=false", *SMALL]


def _plain(value):
    return list(value) if isinstance(value, tuple) else value


def _jax_resolve(args):
    """The JAX package's workspace and agent configs for the same arguments."""
    name = next(a.split("=", 1)[1] for a in args if a.startswith("agent="))
    ws_args = [a for a in args if not a.startswith("agent")]
    agent_args = [a[len("agent."):] for a in args if a.startswith("agent.")]
    return (jax_apply_overrides(JaxWorkspaceConfig(agent_name=name), ws_args),
            jax_apply_overrides(jax_default_config(name), agent_args))


def test_there_are_recipes() -> None:
    names = {r.name for r in RECIPES}
    assert {"quad_one", "cheetah_one"} <= names and len(RECIPES) >= 8


@pytest.mark.parametrize("recipe", RECIPES, ids=[r.name for r in RECIPES])
def test_stored_config_resolves_as_in_jax(recipe) -> None:
    """Every key both packages define resolves to the same value, and every
    stored key the mode does not replace keeps its stored value."""
    args, _ = online_curve.recipe_args(recipe, ["folder=unused"])
    cfg, agent_cfg = online_curve.resolve(args)
    jcfg, jagent_cfg = _jax_resolve(args)
    for port, jax in ((to_flat_dict(cfg), jax_to_flat_dict(jcfg)),
                      (to_flat_dict(agent_cfg), jax_to_flat_dict(jagent_cfg))):
        common = set(port) & set(jax)
        assert len(common) >= 10
        assert {k: _plain(port[k]) for k in common} == {k: _plain(jax[k]) for k in common}
    resolved = {**to_flat_dict(cfg), **to_flat_dict(agent_cfg, "agent.")}
    stored = json.loads((recipe / "config.json").read_text())
    for key, value in stored.items():
        if key not in online_curve.RECIPE_REPLACED:
            assert _plain(resolved[key]) == value, key


@pytest.mark.parametrize("recipe", RECIPES, ids=[r.name for r in RECIPES])
def test_replaced_keys_touch_no_learning(recipe) -> None:
    """The mode replaces exactly the listed keys, adds bf16 where the file has
    no dtype, and puts the checkpoint period above the frames."""
    stored = json.loads((recipe / "config.json").read_text())
    args, replaced = online_curve.recipe_args(recipe)
    assert set(replaced) == set(online_curve.RECIPE_REPLACED) == {
        "folder", "checkpoint_every", "save_eval_video", "use_tb", "use_wandb",
        "load_model", "agent.use_pallas_loss"}
    cfg, agent_cfg = online_curve.resolve(args)
    assert cfg.checkpoint_every > cfg.num_train_frames == stored["num_train_frames"]
    assert (cfg.save_eval_video, cfg.use_tb, cfg.use_wandb, cfg.load_model) == (
        False, False, False, None)
    assert cfg.folder == f"exp_local/{recipe.name}" and agent_cfg.use_pallas_loss
    assert agent_cfg.compute_dtype == stored.get("agent.compute_dtype", "bfloat16")
    assert (cfg.seed, cfg.num_grad_steps, cfg.replay_buffer_episodes) == (
        stored["seed"], stored["num_grad_steps"], stored["replay_buffer_episodes"])


@pytest.mark.parametrize("key", ["no_such_key", "agent.no_such_key"])
def test_unknown_stored_key_raises(tmp_path, key) -> None:
    stored = json.loads((ROOT / "results" / "quad_one" / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps({**stored, key: 1}))
    with pytest.raises(ValueError, match="Unknown override keys"):
        online_curve.recipe_args(tmp_path)


def test_later_arguments_override_the_recipe() -> None:
    args, _ = online_curve.recipe_args(ROOT / "results" / "quad_one",
                                       ["folder=elsewhere", "seed=2"])
    cfg, _ = online_curve.resolve(args)
    assert (cfg.folder, cfg.seed) == ("elsewhere", 2)
    assert sum(a.startswith("folder=") for a in args) == 1


def _battery(mean: float) -> list:
    return [mean - 1.0, mean + 1.0]


@pytest.mark.parametrize("port,jax,verdict", [
    (960.0, 999.0, "inside"),       # 10% of 999 = 99.9
    (899.0, 999.0, "outside"),
    (900.0, 1000.0, "inside"),      # at the boundary, 0.10 x 1000
    (1100.0, 1000.0, "inside"),
    (1100.5, 1000.0, "outside"),
    (237.0, 187.0, "inside"),       # at the boundary of the floor, 50
    (137.0, 187.0, "inside"),
    (136.0, 187.0, "outside"),
])
def test_compare_rule(port, jax, verdict) -> None:
    check = online_curve.compare({"t": _battery(port)}, {"t": _battery(jax)},
                                 [port] * 5, [jax] * 5)
    assert check["battery"]["t"]["verdict"] == check["curve"]["verdict"] == verdict
    assert check["battery"]["t"]["band"] == online_curve.band(jax) == max(50.0, 0.1 * jax)
    assert check["inside"] == (verdict == "inside")


def test_compare_missing_rows() -> None:
    """A task on one side only and a curve of fewer than five rows are
    "missing", and then the whole is not inside."""
    check = online_curve.compare({"a": _battery(500.0), "port_only": [1.0]},
                                 {"a": _battery(510.0), "jax_only": [2.0]},
                                 [500.0] * 4, [510.0] * 5)
    verdicts = {task: row["verdict"] for task, row in check["battery"].items()}
    assert verdicts == {"a": "inside", "jax_only": "missing", "port_only": "missing"}
    assert check["curve"]["verdict"] == "missing" and not check["inside"]
    rows = [{"frame": str(f), "episode_reward": str(f / 1000)}
            for f in range(1_700_000, 2_000_001, 50_000)]
    assert online_curve.late_curve(rows) == [1800.0, 1850.0, 1900.0, 1950.0, 2000.0]


def test_recipe_mode_end_to_end_on_cpu(tmp_path, capsys) -> None:
    """Two cycles of cheetah_one's ``pretrain`` at tiny depth: the run's
    records, ``check.json`` with every stored task, no checkpoint left; and
    without ``device=cpu`` the tool refuses to run where there is no card."""
    folder = tmp_path / "run"
    recipe = ROOT / "results" / "cheetah_one"
    rc = online_curve.main([f"recipe={recipe}", "entry=pretrain", "device=cpu",
                            f"folder={folder}", *TINY])
    assert rc == 0
    out = capsys.readouterr().out
    assert "agent.use_pallas_loss: None -> true" in out and "eval frame 400:" in out
    check = json.loads((folder / "check.json").read_text())
    stored = json.loads((recipe / "test_rewards.json").read_text())
    assert list(check["battery"]) == list(stored)
    assert check["frames"] == 400 and check["updates"] == 100 and check["launches_equal"]
    assert check["curve"]["verdict"] == "missing" and check["curve"]["port"] == []
    assert check["entry"] == "pretrain" and check["card"] == "cpu"
    saved = json.loads((folder / "config.json").read_text())
    assert saved["agent.use_pallas_loss"] and saved["agent.compute_dtype"] == "bfloat16"
    assert saved["task"] == "cheetah_walk" and saved["checkpoint_every"] == 2_000_011
    assert len(json.loads((folder / "cycle_timings.json").read_text())) == 2
    assert not (folder / "models").exists()
    if not torch.cuda.is_available():
        assert online_curve.main([f"recipe={recipe}", "entry=pretrain",
                                  f"folder={tmp_path / 'card'}"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        assert not (tmp_path / "card").exists()
