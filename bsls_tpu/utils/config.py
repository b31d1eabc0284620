"""Config system: one dataclass, presets for the five benchmark configs.

(SURVEY.md §5 config/flag system; presets mirror BASELINE.json:6-12.)
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["RunConfig", "PRESETS", "load_config"]


@dataclass
class RunConfig:
    # instance
    config: str = "tiny"  # tiny | medium | traffic | large | <path.npz>
    seed: int = 0
    instance_kwargs: dict = field(default_factory=dict)
    # solver
    method: str = "pgd"  # pgd | apgd | lbfgs | eg | frank_wolfe | afw
    line_search: str = "exact"  # exact | bb | bbm | fixed | pava
    tol: float = 1e-6
    max_iter: int = 10_000
    chunk: int = 100
    unroll: int = 1  # lax.scan unroll inside a chunk
    step_size: float = 0.0
    refine: int = 0  # post-solve f64-anchored polish rounds (solve(refine=K))
    refine_tol: float | None = None  # certified adaptive refine target
    dtype: str = "float32"
    equilibrate: bool = True
    # mesh
    mesh_block: int = 0  # 0 = no mesh (single device)
    mesh_scenario: int = 1
    # harness
    oracle: bool = False  # compute CPU float64 oracle for parity metrics
    profile_dir: Optional[str] = None  # enable jax.profiler traces
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # chunks between checkpoints (0 = off)
    resume: bool = False
    metrics_path: Optional[str] = None  # JSONL metrics output

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "RunConfig":
        return RunConfig(**d)


PRESETS = {
    # the five benchmark configs of BASELINE.json:6-12
    "tiny": RunConfig(config="tiny", method="pgd", line_search="exact"),
    "medium-pgd": RunConfig(config="medium", method="pgd"),
    "medium-eg": RunConfig(config="medium", method="eg"),
    "medium-lbfgs": RunConfig(config="medium", method="lbfgs"),
    # corridor-structured instance: prepare(layout="auto") picks the
    # banded-split layout
    "medium-banded": RunConfig(config="medium_banded", method="pgd",
                               line_search="bbm"),
    # lbfgs inners: fewer AL inner iterations AND a better objective than
    # apgd on the grid-network instance
    "traffic": RunConfig(config="traffic", method="lbfgs"),
    "large": RunConfig(
        config="large", method="pgd",
        instance_kwargs={"num_blocks": 1_000_000, "dim": 8, "num_scenarios": 4},
        mesh_block=0, chunk=50,
    ),
    "sweep-fw": RunConfig(config="medium", method="frank_wolfe"),
    "sweep-eg": RunConfig(config="medium", method="eg"),
    "sweep-pgd-pava": RunConfig(config="medium", method="pgd", line_search="pava"),
}


def load_config(name_or_path: str, **overrides) -> RunConfig:
    if name_or_path in PRESETS:
        cfg = dataclasses.replace(PRESETS[name_or_path])
    elif name_or_path.endswith(".json"):
        with open(name_or_path) as f:
            cfg = RunConfig.from_dict(json.load(f))
    else:
        cfg = RunConfig(config=name_or_path)
    for k, v in overrides.items():
        if v is not None:
            setattr(cfg, k, v)
    return cfg
