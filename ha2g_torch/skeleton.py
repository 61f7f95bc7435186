"""Skeleton specifications and hierarchy-level routing tables.

The port's own copy of the bone trees and level lists of the TED Gesture
(3 levels, 9 bones) and TED Expressive (6 levels, 42 bones) skeletons.
Per-level target extraction and the inter-level pre-seq routing are
derived from the nested level bone lists.  The physical angle prior's
tables and ``extended_dir_vecs`` serve the train step's physical loss.
Forward kinematics is one product with a static (n_bones, n_joints) path
matrix; its inverse takes each bone's child minus its parent joint.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AnglePrior:
    """Physical angle prior constants (reference train_hierarchy*.py).

    ``pairs`` index into the *extended* bone list: bones 0..n_bones-1, then
    the normalised cross product of each ``cross_products`` bone pair.
    ``change`` (per-pair mean frame-to-frame angle change) serves beat
    consistency.
    """

    pairs: tuple[tuple[int, int], ...]
    avg: tuple[float, ...]
    var: tuple[float, ...]
    cross_products: tuple[tuple[int, int], ...] = ()
    change: tuple[float, ...] = ()

    def __post_init__(self):
        if not len(self.pairs) == len(self.avg) == len(self.var):
            raise ValueError("pairs, avg and var must have one entry a pair")
        if self.change and len(self.change) != len(self.pairs):
            raise ValueError("change must have one entry a pair")


@dataclasses.dataclass(frozen=True)
class SkeletonSpec:
    """Bone tree + hierarchy levels for one dataset family."""

    name: str
    # (parent_joint, child_joint, bone_length) per bone, topologically sorted
    bones: tuple[tuple[int, int, float], ...]
    # per level: ascending bone indices; level k's bones nest into level k+1
    levels: tuple[tuple[int, ...], ...]
    angle_prior: AnglePrior | None = None
    # number of trailing bones the reference's expressive fill blocks write
    # through a negative slice on the (dim+1)-wide pre-seq buffer, which
    # lands one column late (see routing_indices); 0 = no such block
    ref_tail_fill_bones: int = 0
    # reproduce that off-by-one layout (checkpoints trained by the
    # reference expect it); False = clean nested routing
    ref_routing_compat: bool = False

    @property
    def n_bones(self) -> int:
        return len(self.bones)

    @property
    def n_joints(self) -> int:
        return 1 + max(max(p, c) for p, c, _ in self.bones)

    @property
    def pose_dim(self) -> int:
        """Flattened direction-vector dim."""
        return self.n_bones * 3

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_dim(self, level: int) -> int:
        return len(self.levels[level]) * 3

    @property
    def level_dims(self) -> tuple[int, ...]:
        return tuple(self.level_dim(i) for i in range(self.n_levels))

    def __post_init__(self):
        for k in range(len(self.levels) - 1):
            if not set(self.levels[k]) <= set(self.levels[k + 1]):
                raise ValueError(f"level {k} bones must nest into level {k + 1}")
        if tuple(self.levels[-1]) != tuple(range(self.n_bones)):
            raise ValueError("finest level must cover all bones")

    # ---- kinematics ------------------------------------------------------
    @functools.cached_property
    def path_matrix(self) -> np.ndarray:
        """(n_bones, n_joints) float32: entry [b, j] = length_b if bone b
        lies on the root -> j chain, so FK is one product."""
        m = np.zeros((self.n_bones, self.n_joints), dtype=np.float32)
        for b, (parent, child, length) in enumerate(self.bones):
            m[:, child] = m[:, parent]
            m[b, child] = length
        return m

    @functools.cached_property
    def parents(self) -> np.ndarray:
        return np.array([p for p, _, _ in self.bones], dtype=np.int64)

    @functools.cached_property
    def children(self) -> np.ndarray:
        return np.array([c for _, c, _ in self.bones], dtype=np.int64)

    @functools.cached_property
    def lengths(self) -> np.ndarray:
        return np.array([ln for _, _, ln in self.bones], dtype=np.float32)

    def dir_vec_to_pose(self, vec: torch.Tensor) -> torch.Tensor:
        """Forward kinematics: (..., n_bones*3) or (..., n_bones, 3) unit
        direction vectors -> joint positions (..., n_joints, 3)
        (reference convert_dir_vec_to_pose)."""
        if vec.shape[-1] != 3 or vec.shape[-2] != self.n_bones:
            vec = vec.reshape(*vec.shape[:-1], self.n_bones, 3)
        pm = torch.as_tensor(self.path_matrix, device=vec.device,
                             dtype=vec.dtype)
        return torch.einsum("...bd,bj->...jd", vec, pm)

    def pose_to_dir_vec(self, pose: torch.Tensor,
                        eps: float = 1e-12) -> torch.Tensor:
        """Inverse: joint positions (..., n_joints, 3) (or flattened) ->
        unit direction vectors (..., n_bones, 3); a zero vector stays zero
        (reference convert_pose_seq_to_dir_vec)."""
        if pose.shape[-1] != 3 or pose.shape[-2] != self.n_joints:
            pose = pose.reshape(*pose.shape[:-1], self.n_joints, 3)
        child = torch.as_tensor(self.children, device=pose.device)
        parent = torch.as_tensor(self.parents, device=pose.device)
        d = pose.index_select(-2, child) - pose.index_select(-2, parent)
        norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return torch.where(norm > eps, d / torch.clamp(norm, min=eps), d)

    def level_slice_cols(self, level: int) -> np.ndarray:
        """Flat feature indices selecting level ``level``'s bones from the
        full (n_bones*3,) dir-vec vector."""
        bones = np.asarray(self.levels[level], dtype=np.int64)
        return (bones[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)

    def extract_level_target(self, target: torch.Tensor,
                             level: int) -> torch.Tensor:
        """target (..., n_bones*3) -> (..., level_dim(level))."""
        cols, = self.on_device("level_slice_cols", level, target.device)
        return target.index_select(-1, cols)

    @functools.cached_property
    def _on_device(self) -> dict:
        return {}

    def on_device(self, table: str, level: int, device) -> tuple:
        """The index arrays of ``table`` (``level_slice_cols`` or
        ``routing_indices``) at ``level`` as tensors on ``device``, uploaded
        once: an upload from pageable host memory synchronises, which a
        CUDA graph's capture refuses.  Made outside inference mode, so
        training can save them for its backward."""
        key = (table, level, torch.device(device))
        hit = self._on_device.get(key)
        if hit is None:
            arrays = getattr(self, table)(level)
            arrays = arrays if isinstance(arrays, tuple) else (arrays,)
            with torch.inference_mode(False):
                hit = tuple(torch.as_tensor(a, device=device) for a in arrays)
            self._on_device[key] = hit
        return hit

    def routing_indices(self, level: int) -> tuple[np.ndarray, np.ndarray]:
        """(src_cols, dst_cols) such that
        pre_seq_{level+1}[..., dst_cols] = out_{level}[..., src_cols].

        With ref_routing_compat set, the dst columns of the trailing
        ref_tail_fill_bones bones shift by +1: the last shifted column is
        the constraint-bit column and the first tail column stays zero.
        """
        src_bones = list(self.levels[level])
        dst_pos = {b: i for i, b in enumerate(self.levels[level + 1])}
        n_tail = self.ref_tail_fill_bones if self.ref_routing_compat else 0
        src_cols, dst_cols = [], []
        for i, b in enumerate(src_bones):
            j = dst_pos[b]
            shift = 1 if i >= len(src_bones) - n_tail else 0
            src_cols.extend(range(i * 3, i * 3 + 3))
            dst_cols.extend(range(j * 3 + shift, j * 3 + 3 + shift))
        return (np.array(src_cols, dtype=np.int64),
                np.array(dst_cols, dtype=np.int64))

    @functools.lru_cache(maxsize=None)
    def routing_matrix(self, level: int) -> np.ndarray:
        """routing_indices(level) as a 0/1 matrix of shape
        (level_dim(level), level_dim(level+1) + 1): M[src, dst] = 1."""
        src, dst = self.routing_indices(level)
        m = np.zeros((self.level_dim(level), self.level_dim(level + 1) + 1),
                     dtype=np.float32)
        m[src, dst] = 1.0
        return m

    def extended_dir_vecs(self, raw_dir_vec: torch.Tensor) -> torch.Tensor:
        """(..., n_bones*3) raw (mean-added) dir vecs -> (..., n_ext, 3)
        unit vectors, with the prior's cross-product vectors appended
        (train_hierarchy_expressive.py:429-433)."""
        v = raw_dir_vec.reshape(*raw_dir_vec.shape[:-1], self.n_bones, 3)
        crosses = self.angle_prior.cross_products if self.angle_prior else ()
        if crosses:
            extras = [torch.linalg.cross(v[..., a, :], v[..., b, :])
                      for a, b in crosses]
            v = torch.cat([v, torch.stack(extras, dim=-2)], dim=-2)
        norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return v / torch.clamp(norm, min=1e-12)


# TED Gesture (reference scripts/utils/data_utils.py:14-15)
TED_GESTURE = SkeletonSpec(
    name="ted_gesture",
    bones=(
        (0, 1, 0.26), (1, 2, 0.18), (2, 3, 0.14),
        (1, 4, 0.22), (4, 5, 0.36), (5, 6, 0.33),
        (1, 7, 0.22), (7, 8, 0.36), (8, 9, 0.33),
    ),
    levels=(
        (0, 1, 2, 3, 6),
        (0, 1, 2, 3, 4, 6, 7),
        (0, 1, 2, 3, 4, 5, 6, 7, 8),
    ),
    # train_hierarchy.py:9-16
    angle_prior=AnglePrior(
        pairs=((3, 4), (4, 5), (6, 7), (7, 8)),
        avg=(0.22037504613399506, 0.4590071439743042,
             0.22463147342205048, 0.45562979578971863),
        var=(0.0018439559498801827, 0.013570506125688553,
             0.0017794054001569748, 0.013684595935046673),
        change=(0.0034540758933871984, 0.007043459918349981,
                0.003493624273687601, 0.007205077446997166),
    ),
)

# TED Expressive (reference scripts/utils/data_utils_expressive.py:11-66)
_EXPRESSIVE_BONES = (
    (0, 1, 0.26),                                      # 0 spine-neck
    (1, 2, 0.22), (1, 3, 0.22),                        # 1,2 neck-shoulders
    (2, 4, 0.36), (4, 6, 0.33),                        # 3,4 left arm
    (6, 8, 0.137), (8, 9, 0.044), (9, 10, 0.031),      # 5-7 left index
    (6, 11, 0.144), (11, 12, 0.042), (12, 13, 0.033),  # 8-10 left middle
    (6, 14, 0.127), (14, 15, 0.027), (15, 16, 0.026),  # 11-13 left pinky
    (6, 17, 0.134), (17, 18, 0.039), (18, 19, 0.033),  # 14-16 left ring
    (6, 20, 0.068), (20, 21, 0.042), (21, 22, 0.036),  # 17-19 left thumb
    (3, 5, 0.36), (5, 7, 0.33),                        # 20,21 right arm
    (7, 23, 0.137), (23, 24, 0.044), (24, 25, 0.031),  # 22-24 right index
    (7, 26, 0.144), (26, 27, 0.042), (27, 28, 0.033),  # 25-27 right middle
    (7, 29, 0.127), (29, 30, 0.027), (30, 31, 0.026),  # 28-30 right pinky
    (7, 32, 0.134), (32, 33, 0.039), (33, 34, 0.033),  # 31-33 right ring
    (7, 35, 0.068), (35, 36, 0.042), (36, 37, 0.036),  # 34-36 right thumb
    (1, 38, 0.18),                                     # 37 neck-nose
    (38, 39, 0.14), (38, 40, 0.14),                    # 38,39 nose-eyes
    (39, 41, 0.15), (40, 42, 0.15),                    # 40,41 eyes-ears
)

_HEAD = (37, 38, 39, 40, 41)

# train_hierarchy_expressive.py:9-52 (+palm cross products :429-432)
_EXPRESSIVE_ANGLE_PAIRS = (
    (0, 1), (0, 2), (1, 3), (3, 4), (5, 6), (6, 7), (8, 9), (9, 10),
    (11, 12), (12, 13), (14, 15), (15, 16), (17, 18), (18, 19), (17, 5),
    (5, 8), (8, 14), (14, 11), (2, 20), (20, 21), (22, 23), (23, 24),
    (25, 26), (26, 27), (28, 29), (29, 30), (31, 32), (32, 33), (34, 35),
    (35, 36), (34, 22), (22, 25), (25, 31), (31, 28), (0, 37), (37, 38),
    (37, 39), (38, 40), (39, 41), (4, 42), (21, 43),
)
_EXPRESSIVE_AVG_ANGLE = (
    0.5969760417938232, 0.572796642780304, 0.348366379737854,
    0.5536502599716187, 0.13027764856815338, 0.2801012694835663,
    0.21510013937950134, 0.2457924336194992, 0.25812962651252747,
    0.1696397364139557, 0.22138600051403046, 0.2232128530740738,
    0.10013844072818756, 0.13465291261672974, 0.15643933415412903,
    0.0757620558142662, 0.08111366629600525, 0.07266224175691605,
    0.28242993354797363, 0.5088332295417786, 0.13428474962711334,
    0.31135401129722595, 0.21646016836166382, 0.26498687267303467,
    0.2691807448863983, 0.18528689444065094, 0.23011097311973572,
    0.23511438071727753, 0.08650383353233337, 0.11938644200563431,
    0.16712385416030884, 0.07711927592754364, 0.08256717771291733,
    0.07396762818098068, 0.2504960894584656, 0.508758008480072,
    0.4859846234321594, 0.30816879868507385, 0.2943730056285858,
    0.572842538356781, 0.4471983015537262,
)
_EXPRESSIVE_VAR_ANGLE = (
    0.00028363385354168713, 0.00029294739942997694, 0.001516797230578959,
    0.010948357172310352, 0.0025349585339426994, 0.009562775492668152,
    0.008637933991849422, 0.008715483359992504, 0.012276478111743927,
    0.005242602434009314, 0.008161756210029125, 0.007505195681005716,
    0.002306767040863633, 0.0008198867435567081, 9.477637649979442e-05,
    4.9160284106619656e-05, 5.3111481975065544e-05, 4.9043188482755795e-05,
    0.0013721085852012038, 0.010581498965620995, 0.00196851696819067,
    0.006986899301409721, 0.006110062822699547, 0.0074407304637134075,
    0.010817521251738071, 0.005984380841255188, 0.006697201170027256,
    0.00707469554618001, 0.0020931533072143793, 0.0006661304505541921,
    9.530011448077857e-05, 4.7486370021943e-05, 5.157381747267209e-05,
    4.733635432785377e-05, 0.00095974380383268, 0.00023575413797516376,
    0.0002760167117230594, 2.6063793484354392e-05, 2.591621523606591e-05,
    0.01612936705350876, 0.013571133837103844,
)

_EXPRESSIVE_CHANGE_ANGLE = (
    0.0027804733254015446, 0.002761547453701496, 0.005953566171228886,
    0.013764726929366589, 0.022748252376914024, 0.039307352155447006,
    0.03733552247285843, 0.03775784373283386, 0.0485558956861496,
    0.032914578914642334, 0.03800227493047714, 0.03757007420063019,
    0.027338404208421707, 0.01640886254608631, 0.003166505601257086,
    0.0017252820543944836, 0.0018696568440645933, 0.0016072227153927088,
    0.005681346170604229, 0.013287615962326527, 0.021516695618629456,
    0.033936675637960434, 0.03094293735921383, 0.03378918394446373,
    0.044323261827230453, 0.034706637263298035, 0.03369896858930588,
    0.03573163226246834, 0.02628341130912304, 0.014071882702410221,
    0.0029828345868736506, 0.0015706412959843874, 0.0017107439925894141,
    0.0014634154504165053, 0.004873405676335096, 0.002998138777911663,
    0.0030240598134696484, 0.0009890805231407285, 0.0012279648799449205,
    0.047324635088443756, 0.04472292214632034,
)

TED_EXPRESSIVE = SkeletonSpec(
    name="ted_expressive",
    bones=_EXPRESSIVE_BONES,
    levels=(
        (0, 1, 2) + _HEAD,
        (0, 1, 2, 3, 20) + _HEAD,
        (0, 1, 2, 3, 4, 20, 21) + _HEAD,
        (0, 1, 2, 3, 4, 5, 8, 11, 14, 17, 20, 21, 22, 25, 28, 31, 34) + _HEAD,
        (0, 1, 2, 3, 4, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18,
         20, 21, 22, 23, 25, 26, 28, 29, 31, 32, 34, 35) + _HEAD,
        tuple(range(42)),
    ),
    angle_prior=AnglePrior(
        pairs=_EXPRESSIVE_ANGLE_PAIRS,
        avg=_EXPRESSIVE_AVG_ANGLE,
        var=_EXPRESSIVE_VAR_ANGLE,
        change=_EXPRESSIVE_CHANGE_ANGLE,
        # left palm = cross(bone 11, bone 17); right palm = cross(28, 34)
        # (train_hierarchy_expressive.py:430-431)
        cross_products=((11, 17), (28, 34)),
    ),
    # the reference fills the 5 head bones through `[..., -5*3:]`
    ref_tail_fill_bones=5,
)

SKELETONS: dict[str, SkeletonSpec] = {
    s.name: s for s in (TED_GESTURE, TED_EXPRESSIVE)
}

# variants that reproduce the reference's off-by-one pre-seq head fill
REF_COMPAT_SKELETONS: dict[str, SkeletonSpec] = {
    name: (dataclasses.replace(s, ref_routing_compat=True)
           if s.ref_tail_fill_bones else s)
    for name, s in SKELETONS.items()
}


def skeleton_for_pose_dim(pose_dim: int) -> SkeletonSpec:
    """The skeleton whose direction vectors have ``pose_dim`` values (27:
    TED Gesture, 126: TED Expressive)."""
    for s in SKELETONS.values():
        if s.pose_dim == pose_dim:
            return s
    raise ValueError(f"no skeleton with pose_dim={pose_dim}")
