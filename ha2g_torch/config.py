"""The subset of the hierarchy configuration that serving and the train
step read.

Field names and defaults follow the JAX package's ``Config`` so that a
config dict (for example one embedded in a checkpoint) loads through
``from_dict``, and a YAML file of the repository's ``configs*/`` through
``from_yaml``; unknown keys are ignored.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np

from ha2g_torch.skeleton import REF_COMPAT_SKELETONS, SKELETONS, SkeletonSpec


@dataclass
class Config:
    name: str = "main"
    model: str = "hierarchy"
    dataset: str = "ted_gesture"  # ted_gesture | ted_expressive

    wordembed_dim: int = 300
    freeze_wordembed: bool = False
    mean_dir_vec: Optional[list[float]] = None

    batch_size: int = 50
    dropout_prob: float = 0.3
    n_layers: int = 4
    hidden_size: int = 300
    z_type: str = "none"  # speaker | random | none
    input_context: str = "both"  # both | audio | text | none

    motion_resampling_framerate: int = 15
    n_poses: int = 34
    n_pre_poses: int = 4
    pose_dim: int = 27

    # training
    learning_rate: float = 5e-4
    discriminator_lr_weight: float = 0.2
    loss_regression_weight: float = 70.0
    loss_gan_weight: float = 1.0
    loss_kld_weight: float = 0.1
    loss_reg_weight: float = 0.01
    loss_warmup: int = -1
    loss_contrastive_pos_weight: float = 0.2
    loss_contrastive_neg_weight: float = 0.005
    loss_physical_weight: float = 0.01

    compute_dtype: str = "float32"  # float32 | bfloat16
    # reproduce the reference's off-by-one expressive pre-seq head fill, for
    # checkpoints trained by the reference code (see SkeletonSpec)
    ref_routing_compat: bool = False

    @property
    def skeleton(self) -> SkeletonSpec:
        table = REF_COMPAT_SKELETONS if self.ref_routing_compat else SKELETONS
        return table[self.dataset]

    @property
    def mean_dir_vec_array(self) -> np.ndarray:
        if self.mean_dir_vec is None:
            return np.zeros(self.pose_dim, dtype=np.float32)
        return np.asarray(self.mean_dir_vec, dtype=np.float32).reshape(-1)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path, **overrides) -> "Config":
        d = read_flat_yaml(path)
        d.update(overrides)
        return cls.from_dict(d)


def _scalar(text: str):
    """A YAML scalar: true / false / null, a Python literal, else a str."""
    if text in ("true", "false"):
        return text == "true"
    if text == "null":
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def read_flat_yaml(path) -> dict[str, Any]:
    """The YAML subset the config files use, without PyYAML (which the
    card's machine lacks): ``key: scalar`` lines and ``key:`` followed by
    ``- scalar`` items, ``#`` comments.  Anything else raises."""
    out: dict[str, Any] = {}
    key = None
    for n, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.split(" #")[0].rstrip() if not raw.lstrip().startswith(
            "#") else ""
        if not line:
            continue
        if line.lstrip().startswith("- ") and key is not None:
            out[key].append(_scalar(line.lstrip()[2:].strip()))
        elif ":" in line and not line[0].isspace():
            name, _, value = line.partition(":")
            value = value.strip()
            key = name.strip() if not value else None
            out[name.strip()] = [] if not value else _scalar(value)
        else:
            raise ValueError(f"{path}:{n}: not in the flat YAML subset: "
                             f"{raw!r}")
    return out
