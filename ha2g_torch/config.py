"""The subset of the configuration that serving, the train step, the
trainer and the command line read.

Field names and defaults follow the JAX package's ``Config`` so that a
config dict (for example one embedded in a checkpoint) loads through
``from_dict``, and a YAML file of the repository's ``configs*/`` through
``from_yaml``; unknown keys are ignored.  ``parse_cli`` reads
``--config FILE`` and lets any ``--field value`` override it, as the JAX
package's does.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from ha2g_torch.skeleton import REF_COMPAT_SKELETONS, SKELETONS, SkeletonSpec


@dataclass
class Config:
    name: str = "main"
    model: str = "hierarchy"
    dataset: str = "ted_gesture"  # ted_gesture | ted_expressive

    # data paths: a clip-storage directory, or "synthetic" / "none" / empty
    train_data_path: str = ""
    val_data_path: str = ""
    test_data_path: str = ""
    model_save_path: str = "output"
    mean_pose: Optional[list[float]] = None
    random_seed: int = -1
    # the trainer's sample animations (Trainer.fit(render_every=))
    save_result_video: bool = True

    wordembed_path: Optional[str] = None
    wordembed_dim: int = 300
    freeze_wordembed: bool = False
    mean_dir_vec: Optional[list[float]] = None

    epochs: int = 10
    batch_size: int = 50
    dropout_prob: float = 0.3
    n_layers: int = 4
    hidden_size: int = 300
    z_type: str = "none"  # speaker | random | none
    input_context: str = "both"  # both | audio | text | none

    motion_resampling_framerate: int = 15
    n_poses: int = 34
    n_pre_poses: int = 4
    subdivision_stride: int = 10
    pose_dim: int = 27
    latent_dim: int = 128

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
    # the TED Expressive FGD embedder's bone-cosine term (MotionAESystem)
    cos_loss_weight: float = 50.0
    # the pose-difference L1 term of EmbedSystem's loss (the reference's
    # H36M feature-extractor trainer, train_feature_extractor.py:68-71)
    embed_pose_diff_loss: bool = False

    # the frozen FGD embedder: a checkpoint directory (checkpoint.py
    # save_embedder) whose config has model "gesture_autoencoder"
    eval_net_path: str = ""
    # keep both optimisers' state in checkpoints (needed to resume)
    save_optimizer_state: bool = True

    # pose_diffusion (DiffGesture, models/diffusion.py): the denoiser's
    # width, blocks, heads and MLP ratio; the DDPM schedule's steps and its
    # first and last beta; the null condition's training probability and
    # the classifier-free guidance scale
    diff_hidden_dim: int = 512
    block_depth: int = 8
    n_heads: int = 8
    mlp_ratio: int = 4
    diffusion_steps: int = 500
    beta_1: float = 1e-4
    beta_T: float = 0.02
    null_cond_prob: float = 0.1
    guidance_scale: float = 1.5

    compute_dtype: str = "float32"  # float32 | bfloat16
    # the mesh of a multi-process run (torchrun; parallel/mesh.py): its
    # FSDP size, over which parameters and Adam moments shard (1 = pure
    # DP), and its data-parallel size, kept so the JAX package's configs
    # load: 0 or the world size over fsdp_devices (the mesh spans every
    # rank), which is what the port takes in either case
    dp_devices: int = 0
    fsdp_devices: int = 1
    # reproduce the reference's off-by-one expressive pre-seq head fill, for
    # checkpoints trained by the reference code (see SkeletonSpec)
    ref_routing_compat: bool = False

    def __post_init__(self):
        if self.dp_devices < 0 or self.fsdp_devices < 1:
            raise ValueError(f"dp_devices {self.dp_devices} (0 = the world "
                             f"size over fsdp_devices) and fsdp_devices "
                             f"{self.fsdp_devices} (1 = pure data parallel)")

    @property
    def skeleton(self) -> SkeletonSpec:
        table = REF_COMPAT_SKELETONS if self.ref_routing_compat else SKELETONS
        return table[self.dataset]

    @property
    def mean_dir_vec_array(self) -> np.ndarray:
        if self.mean_dir_vec is None:
            return np.zeros(self.pose_dim, dtype=np.float32)
        return np.asarray(self.mean_dir_vec, dtype=np.float32).reshape(-1)

    @property
    def mean_pose_array(self) -> np.ndarray:
        if self.mean_pose is None:
            return np.zeros(self.pose_dim + 3, dtype=np.float32)
        return np.asarray(self.mean_pose, dtype=np.float32).reshape(-1)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path, **overrides) -> "Config":
        d = read_flat_yaml(path)
        d.update(overrides)
        return cls.from_dict(d)


def _truthy(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "t", "y")


def parse_cli(argv: Optional[Sequence[str]] = None) -> Config:
    """``-c/--config FILE`` and any ``--field value`` overrides of it
    (other arguments are ignored)."""
    parser = argparse.ArgumentParser(description="ha2g_torch")
    parser.add_argument("-c", "--config", required=True)
    known, rest = parser.parse_known_args(argv)
    cfg = Config.from_yaml(known.config)
    over = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        if f.type == "bool":
            over.add_argument(f"--{f.name}", type=_truthy)
        elif f.type == "Optional[list[float]]":
            over.add_argument(f"--{f.name}", type=float, nargs="*")
        else:
            over.add_argument(f"--{f.name}", type={
                "int": int, "float": float}.get(f.type, str))
    ns, _ = over.parse_known_args(rest)
    return cfg.replace(**{k: v for k, v in vars(ns).items()
                          if v is not None})


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
