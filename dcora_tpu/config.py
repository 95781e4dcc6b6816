"""Unified runtime configuration for every driver.

The reference's configuration surface is three parameter structs with C++
defaults and ``operator<<`` reproducibility dumps (AgentParameters
Agent.h:113-185, ROptParameters DCORA_types.h:152-200,
RobustCostParameters DCORA_robust.h:25-84) plus constants hard-coded in
each example.  This module is this build's single equivalent: one
dataclass aggregating every tunable (optimizer, robust cost, staircase,
RBCD driver, agent), loadable from a JSON file, overridable from the CLI
with dotted keys, and dumped at driver startup so every run is
reproducible from its log.

Usage in a driver::

    ap = argparse.ArgumentParser()
    DcoraConfig.add_cli(ap)          # adds --config FILE and --set K=V
    args = ap.parse_args()
    cfg = DcoraConfig.from_cli(args)  # file -> overrides -> defaults
    logger.info("config:\n%s", cfg.dump())

CLI examples::

    driver ... --set ropt.gradnorm_tol=1e-6 --set staircase.r_max=12
    driver ... --config run.json --set robust.costType=GNC_TLS
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Iterator, Optional, Tuple

from dcora_tpu.types import ROptParameters, RobustCostParameters


@dataclasses.dataclass
class StaircaseConfig:
    """Riemannian staircase / certification (reference driver constants:
    MultiRobotExample.cpp:123-133, SingleRobotExample_RASLAM.cpp:55-77)."""

    r_min: int = 5
    r_max: int = 100
    min_eig_num_tol: float = 1e-3  # eta
    gradient_tolerance: float = 1e-6
    preconditioned_gradient_tolerance: float = 1e-6
    num_lanczos: int = 64
    refine: bool = True


@dataclasses.dataclass
class RBCDConfig:
    """Distributed RBCD driver loop (reference:
    MultiRobotExample.cpp:119-135, Agent.h:113-148)."""

    num_iters: int = 1000
    rgrad_norm_tol: float = 0.1
    acceleration: bool = True
    restart_interval: int = 30
    block_selection_rule: str = "Greedy"  # or "Uniform"
    max_num_iters: int = 500  # per-agent termination (Agent.h:122)
    rel_change_tol: float = 5e-3  # Agent.h:123
    robust_opt_inner_iters: int = 30  # Agent.h:121
    robust_opt_num_weight_updates: int = 10  # Agent.h:119
    robust_opt_min_convergence_ratio: float = 0.8  # Agent.h:123


@dataclasses.dataclass
class DcoraConfig:
    """Aggregate of every tunable, with the reference's defaults."""

    ropt: ROptParameters = dataclasses.field(
        default_factory=lambda: ROptParameters(
            gradnorm_tol=1e-4, RTR_iterations=200, RTR_tCG_iterations=200
        )
    )
    robust: RobustCostParameters = dataclasses.field(
        default_factory=RobustCostParameters
    )
    staircase: StaircaseConfig = dataclasses.field(
        default_factory=StaircaseConfig
    )
    rbcd: RBCDConfig = dataclasses.field(default_factory=RBCDConfig)

    # ------------------------------------------------------------- dotted
    def items(self) -> Iterator[Tuple[str, Any]]:
        """(dotted_key, value) for every leaf field."""
        for f in dataclasses.fields(self):
            sub = getattr(self, f.name)
            for sf in dataclasses.fields(sub):
                yield f"{f.name}.{sf.name}", getattr(sub, sf.name)

    def dump(self) -> str:
        """Startup reproducibility dump (the operator<< analogue)."""
        lines = []
        for key, val in self.items():
            if isinstance(val, enum.Enum):
                val = val.name
            lines.append(f"  {key} = {val}")
        return "\n".join(lines)

    def override(self, dotted_key: str, value: str) -> None:
        """Set a leaf field from a string (CLI --set key=value)."""
        try:
            group_name, field_name = dotted_key.split(".", 1)
        except ValueError:
            raise KeyError(
                f"config key {dotted_key!r} must be group.field "
                f"(groups: {[f.name for f in dataclasses.fields(self)]})"
            ) from None
        group = getattr(self, group_name, None)
        if group is None or not dataclasses.is_dataclass(group):
            raise KeyError(f"unknown config group {group_name!r}")
        fields = {f.name: f for f in dataclasses.fields(group)}
        if field_name not in fields:
            raise KeyError(
                f"unknown config field {dotted_key!r} "
                f"(have: {sorted(fields)})"
            )
        current = getattr(group, field_name)
        setattr(group, field_name, _coerce(value, current))

    # ---------------------------------------------------------------- CLI
    @staticmethod
    def add_cli(parser) -> None:
        parser.add_argument(
            "--config", default="", metavar="FILE",
            help="JSON config file of dotted keys, e.g. "
                 '{"ropt.gradnorm_tol": 1e-6}')
        parser.add_argument(
            "--set", action="append", default=[], metavar="KEY=VALUE",
            dest="config_overrides",
            help="override one config field, e.g. "
                 "--set staircase.r_max=12 (repeatable)")

    @classmethod
    def from_cli(cls, args) -> "DcoraConfig":
        cfg = cls()
        path = getattr(args, "config", "")
        if path:
            with open(path) as fh:
                for key, val in json.load(fh).items():
                    cfg.override(key, json.dumps(val)
                                 if not isinstance(val, str) else val)
        for item in getattr(args, "config_overrides", []) or []:
            key, _, val = item.partition("=")
            if not _:
                raise ValueError(f"--set needs KEY=VALUE, got {item!r}")
            cfg.override(key.strip(), val.strip())
        return cfg


def _coerce(value: str, current: Any) -> Any:
    """Parse a CLI string to the type of the current field value."""
    if isinstance(current, enum.Enum):
        enum_cls = type(current)
        try:
            return enum_cls[value]
        except KeyError:
            raise ValueError(
                f"{value!r} is not one of {[e.name for e in enum_cls]}"
            ) from None
    if isinstance(current, bool):
        low = value.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {value!r}")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, str):
        return value
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return value


def resolve(flag_value: Optional[Any], config_value: Any) -> Any:
    """Driver precedence rule: an explicitly passed driver flag wins over
    the config value (drivers declare such flags with default=None)."""
    return config_value if flag_value is None else flag_value
