"""The harness's side of the system under test: building the port's agent
and replay from the benchmark's inputs, and reading its first updates,
with the rows and the noise each drew.

With the online driver's set-up and the fused loss's launch counters
(``harness.Context``), this is where the harness touches
``controllable_agent_torch``: it reads the agent's state and the trainer's
metrics, and changes nothing but the weights and the replay, which the
benchmark makes. For the three checked updates alone it wraps the
trainer's sampler and the agent's noise draw, to keep what they return.
"""

from __future__ import annotations

import dataclasses
import importlib
import typing as tp

import torch

from .reference.nets import Shapes

Tensor = torch.Tensor


def shapes(config: tp.Mapping[str, tp.Any]) -> Shapes:
    """The widths; the backward map (FB's B, SF's φ) reads the goal columns
    where the configuration names a goal space, the observation where not."""
    a, env = config["agent_config"], config["env"]
    goal = env["goal"] if a.get("goal_space") else env["observation"]
    return Shapes(obs=env["observation"], action=env["action"], goal=goal,
                  z=a["z_dim"], hidden=a["hidden_dim"], feature=a["feature_dim"],
                  backward_hidden=a["backward_hidden_dim"])


def agent(config: tp.Mapping[str, tp.Any], device: torch.device) -> tp.Any:
    from controllable_agent_torch.agents import agent_classes
    cfg_cls, agent_cls = agent_classes(config["agent"])
    env = config["env"]
    goal = env["goal"] if config["agent_config"].get("goal_space") else None
    return agent_cls(cfg_cls(**config["agent_config"]), env["observation"], env["action"],
                     goal_dim=goal, device=device, seed=0)


@torch.no_grad()
def load_weights(agent: tp.Any, weights: tp.Mapping[str, Tensor]) -> None:
    """Copy the benchmark's weights into the agent, by name; every
    parameter of the agent must be among them, at the same shape."""
    state = agent.state_dict()
    params = {k for k, _ in agent.named_parameters()}
    missing = sorted(params - set(weights))
    if missing:
        raise ValueError(f"the benchmark makes no weights for {missing}")
    for k, v in weights.items():
        if k not in state or tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: the agent holds {tuple(state[k].shape) if k in state else None}"
                             f", the benchmark made {tuple(v.shape)}")
        state[k].copy_(v)


def replay_state(storage: tp.Dict[str, Tensor], length: int) -> tp.Any:
    """The port's replay state over the benchmark's episodes, all full."""
    from controllable_agent_torch.data.replay import ReplayState
    episodes = next(iter(storage.values())).shape[0]
    device = next(iter(storage.values())).device
    return ReplayState(storage=storage,
                       ep_lengths=torch.full((episodes,), length, dtype=torch.int64,
                                             device=device),
                       n_episodes=episodes, idx=0, max_episodes=episodes,
                       max_episode_length=length)


def trainer(agent: tp.Any, replay: tp.Mapping[str, tp.Any], steps_per_call: int) -> tp.Any:
    from controllable_agent_torch.data.replay import SampleConfig
    from controllable_agent_torch.train.loops import OfflineTrainer
    return OfflineTrainer(agent, SampleConfig(discount=replay["discount"],
                                              future=replay["future"]),
                          agent.cfg.batch_size, steps_per_call)


class FirstSteps(tp.NamedTuple):
    losses: tp.List[tp.Dict[str, float]]
    grad_nu_sums: tp.Dict[str, float]
    grad_abs: tp.Dict[str, Tensor]  # |g| of each element of the first gradient, on the host
    change_norms: tp.Dict[str, float]
    batches: tp.List[tp.Dict[str, Tensor]]  # each update's batch, as the program sampled it
    noises: tp.List[tp.Dict[str, Tensor]]  # each update's noise, as the program drew it


BATCH_FIELDS = ("obs", "action", "next_obs", "discount", "goal", "next_goal")


class Recorder:
    """While open, keeps the batch that ``trainer``'s sampler returns and the
    noise that the configuration's ``program_noise`` class draws, the latest
    of each; ``take`` copies them. Inside a captured update these are the
    graph's own tensors, which each replay fills anew, so a copy after each
    call is that call's update. Nothing is added to the update's work."""

    def __init__(self, trainer: tp.Any, noise_class: str) -> None:
        module, name = noise_class.rsplit(".", 1)
        self._noise_cls = getattr(importlib.import_module(module), name)
        self._trainer = trainer
        self.batch: tp.Any = None
        self.noise: tp.Any = None

    def __enter__(self) -> "Recorder":
        sample, draw = self._trainer._sample, self._noise_cls.__dict__["draw"]
        self._draw = draw

        def sampled(*args: tp.Any, **kwargs: tp.Any) -> tp.Any:
            self.batch = sample(*args, **kwargs)
            return self.batch

        def drawn(cls: tp.Any, *args: tp.Any, **kwargs: tp.Any) -> tp.Any:
            self.noise = draw.__func__(cls, *args, **kwargs)
            return self.noise

        self._trainer._sample = sampled
        self._noise_cls.draw = classmethod(drawn)
        return self

    def __exit__(self, *exc: tp.Any) -> None:
        del self._trainer._sample
        self._noise_cls.draw = self._draw

    def take(self) -> tp.Tuple[tp.Dict[str, Tensor], tp.Dict[str, Tensor]]:
        if self.batch is None or self.noise is None:
            raise RuntimeError("the program's update drew no batch or no noise through "
                               "the sampler and the noise class the configuration names")
        batch = {k: getattr(self.batch, k).clone() for k in BATCH_FIELDS
                 if getattr(self.batch, k, None) is not None}
        noise = {f.name: getattr(self.noise, f.name).clone()
                 for f in dataclasses.fields(self.noise)
                 if isinstance(getattr(self.noise, f.name), Tensor)}
        return batch, noise


def first_steps(call: tp.Callable[[], tp.Mapping[str, Tensor]], trainer: tp.Any, agent: tp.Any,
                config: tp.Mapping[str, tp.Any], ref: tp.Any, weights: tp.Mapping[str, Tensor],
                steps: int = 3) -> FirstSteps:
    """``steps`` calls of one update each through the window's own call;
    each step's losses, batch and noise, Adam's second moment after the
    first (summed by leaf, and the gradient's magnitudes it holds element
    by element) and each leaf's change from the benchmark's weights after
    the last."""
    losses, nu, grad_abs, batches, noises = [], {}, {}, [], []
    recorder = Recorder(trainer, config["program_noise"])
    for i in range(steps):
        with recorder:
            metrics = call()
        batch, noise = recorder.take()
        batches.append(batch)
        noises.append(noise)
        losses.append({k: float(metrics[k]) for k in ref.LOSSES})
        if i == 0:
            for opt, prefix in ref.OPTIMIZERS.items():
                optimizer = getattr(agent, opt)
                for rel, v in optimizer.nu.items():
                    nu[f"{prefix}.{rel}"] = float(v.double().sum())
                    grad_abs[f"{prefix}.{rel}"] = (v / (1.0 - optimizer.b2)).sqrt().cpu()
    state = agent.state_dict()
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(state[k].float() - w))
                  for k, w in weights.items()}
    return FirstSteps(losses, nu, grad_abs, change, batches, noises)
