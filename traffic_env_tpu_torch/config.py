"""Configuration: a frozen, hashable dataclass with fixed-point
derivations (the port's copy of ``traffic_env_tpu/config.py:Config``,
``derive``, ``entry_spec``, ``derive_spawn_rate`` and the CLI parser
``parse_flags``).

Derivation callbacks rewrite derived fields until the config stops
changing.  Field names and defaults are the JAX package's, so one
``settings.json`` snapshot configures either package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, Optional

# Registered derivation callbacks: Config -> dict of field overrides.
_DERIVATIONS: list[Callable[["Config"], dict]] = []

# The config the last parse_flags() call returned and the flags it saw
# explicitly on the command line (restore mode lets these override the
# settings.json snapshot even when their value equals the dataclass
# default).
_EXPLICIT_CLI: dict = {"config": None, "flags": set()}


def explicit_cli_flags(cfg: "Config") -> set:
    """The flags given explicitly on the command line that produced
    ``cfg``: those of the last ``parse_flags`` call when ``cfg`` is the
    config it returned, else none (a config built in code, e.g. by
    another caller in the same process, has no command line)."""
    if cfg != _EXPLICIT_CLI["config"]:
        return set()
    return set(_EXPLICIT_CLI["flags"])


def add_derivation(fn: Callable[["Config"], dict]) -> Callable:
    _DERIVATIONS.append(fn)
    return fn


@dataclasses.dataclass(frozen=True)
class Config:
    # -- simulator -------------------------------------------------------
    local_cars_per_sec: float = 0.12
    rate: float = 0.5            # seconds of simulated time per tick
    poisson: bool = True
    entry: str = "all"           # all | one | random
    learn_switch: bool = False

    # -- time structure --------------------------------------------------
    episode_secs: int = 600
    light_secs: int = 5
    warmup_lights: int = 0

    # -- reward shaping --------------------------------------------------
    local_weight: int = 1
    squish_rewards: bool = False
    remi: bool = True

    # -- shared RL flags -------------------------------------------------
    restore: bool = False
    grad_summary: bool = False
    print_discounted: bool = True
    use_avg: bool = False
    print_avg: bool = False
    render: bool = False
    render_ticks: bool = False
    render_live: bool = False
    episode_len: int = 800       # derived: episode_secs / light_secs
    save_rate: int = 1000
    logdir: str = "summaries"
    gamma: float = 0.8
    learning_rate: float = 0.00025
    summary_rate: int = 10
    validate_rate: int = 20
    trainer: str = "qlearn"
    exploration: str = "e_greedy"   # e_greedy | boltzman | proportional
    batch_size: int = 30
    mode: str = "train"             # train | validate
    spacing: int = 3
    start_eps: float = 0.8
    end_eps: float = 0.08
    start_temp: float = 500.0
    end_temp: float = 1.0
    annealing_episodes: float = 20000
    history: int = 1
    target_update_rate: int = 10
    buffer_size: int = 10000
    trace_size: int = 8
    threads: int = 4     # actor-worker count -> env-batch floor
    lam: float = 1.0
    debug: bool = False
    train_rate: int = 1
    total_episodes: Optional[int] = None
    best_threshold: float = 30.0
    interactive: bool = False
    single_agent: bool = False
    beta: float = 0.001

    # -- grid workload ---------------------------------------------------
    grid_m: int = 3
    grid_n: int = 3
    road_length: float = 250.0

    # -- extensions ------------------------------------------------------
    env_name: str = "traffic"
    occupancy_obs: bool = False
    num_envs: int = 1024            # lockstep env batch size
    seed: int = 0
    exact: bool = False             # bit-exact parity mode (host spawn streams)
    conv_gru: bool = False
    mesh_shape: str = ""
    platform: str = ""
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = 0
    decel_penalty: bool = False
    entropy_coef: float = 0.001
    reward_scale: float = 100.0
    norm_adv: bool = False
    bc_episodes: int = 0
    bc_gated: bool = False
    bc_expert: str = "greedy"
    bc_expert_ckpt: str = ""
    finetune_lr: float = 0.0
    bc_anchor: float = 0.0
    bc_anchor_gated: bool = False
    sil: bool = False
    num_tries: int = 1

    # -- derived (filled by derive()) ------------------------------------
    light_iterations: int = 10
    episode_ticks: int = 1200
    cars_per_sec: float = 1.44

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def derive(self) -> "Config":
        """Apply registered derivations to a fixed point."""
        cfg = self
        for _ in range(10):
            updates: dict = {}
            for fn in _DERIVATIONS:
                updates.update(fn(cfg))
            new = cfg.replace(**updates) if updates else cfg
            if new == cfg:
                return cfg
            cfg = new
        raise RuntimeError("Could not find settings fixed point")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4,
                          separators=(",", ": "))

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields}).derive()


@add_derivation
def _time_derivations(cfg: Config) -> dict:
    """episode_len / light_iterations / episode_ticks from wall-clock
    settings."""
    out = {
        "episode_len": int(cfg.episode_secs / cfg.light_secs),
        "light_iterations": int(cfg.light_secs / cfg.rate),
        "episode_ticks": int(cfg.episode_secs / cfg.rate),
    }
    if cfg.trainer == "polgrad_rnn":
        out["use_avg"] = True
    return out


@add_derivation
def _std_derivations(cfg: Config) -> dict:
    out: dict = {}
    if (cfg.render_ticks or cfg.render_live) and not cfg.render:
        out["render"] = True
    if cfg.render:
        out["mode"] = "validate"
    if cfg.use_avg:
        out["print_avg"] = True
    if cfg.num_envs < cfg.threads:
        out["num_envs"] = cfg.threads
    return out


@add_derivation
def _qlearn_derivations(cfg: Config) -> dict:
    """qlearn stacks 20 frames of history; avg-reward mode sets gamma=1."""
    out: dict = {}
    if cfg.trainer == "qlearn":
        out["history"] = 20
        if cfg.use_avg:
            out["gamma"] = 1.0
    return out


def entry_spec(cfg: Config, rng=None) -> int:
    """4-bit boundary mask from the --entry flag."""
    if cfg.entry == "random":
        import numpy as np
        r = rng if rng is not None else np.random
        return int(r.randint(0b1111))
    if cfg.entry == "one":
        return 0b1110
    return 0


def derive_spawn_rate(cfg: Config, open_sides: int) -> Config:
    """cars_per_sec = local_cars_per_sec * m * open_sides."""
    return cfg.replace(
        cars_per_sec=cfg.local_cars_per_sec * cfg.grid_m * open_sides)


def parse_flags(argv=None) -> Config:
    """Every Config field as a ``--flag``; returns the derived Config.
    ``allow_abbrev=False``: an abbreviated flag would be recorded under
    its abbreviation, so a --restore run would let the settings.json
    snapshot win over the user's explicit override."""
    parser = argparse.ArgumentParser(description="traffic_env_tpu_torch",
                                     allow_abbrev=False)
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if f.type in ("bool", bool):
            parser.add_argument(
                name, nargs="?", const=True, default=f.default,
                type=lambda s: s in (True, "True", "true", "1"))
        elif f.name == "total_episodes":
            parser.add_argument(name, type=int, default=None)
        else:
            typ = {"int": int, "float": float, "str": str}.get(f.type, str)
            parser.add_argument(name, type=typ, default=f.default)
    ns = parser.parse_args(argv)
    argv = sys.argv[1:] if argv is None else argv
    cfg = Config(**vars(ns)).derive()
    _EXPLICIT_CLI["config"] = cfg
    _EXPLICIT_CLI["flags"] = {tok[2:].split("=", 1)[0] for tok in argv
                              if tok.startswith("--")}
    return cfg
