"""Human3.6M windows for the TED-Gesture FGD autoencoder (the port of
ha2g_tpu/data/h36m.py; reference scripts/data_loader/h36m_loader.py).

Select 12 upper-body joints, recentre on the hip midpoint, swap and flip
the axes to the TED convention, frontalise with a hip-based rotation about
Y, drop the hips, and cut 34-frame windows (every second frame, a window
every 10 frames).  A sample is the window's unit direction vectors after a
round trip through forward kinematics, minus the dataset mean, as
train_feature_extractor.py:110-131 consumes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ha2g_torch.skeleton import TED_GESTURE

TRAIN_SUBJECTS = ("S1", "S5", "S6", "S7", "S8", "S9", "S11")
TEST_SUBJECTS = ("S11",)
TARGET_JOINTS = (1, 6, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27)


def _rotation_matrix(axis, theta):
    axis = np.asarray(axis, float)
    axis = axis / math.sqrt(np.dot(axis, axis))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([[aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
                     [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
                     [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc]])


def normalize_h36m(data: np.ndarray) -> np.ndarray:
    """(F, 12, 3) raw positions -> (F, 10, 3) recentred and frontalised,
    hips removed (h36m_loader.py:69-90)."""
    data = data.copy()
    data -= data[:, 2:3]                       # recentre on the spine base
    data = data[:, :, (0, 2, 1)]               # swap y and z
    data[:, :, 1] = -data[:, :, 1]             # flip y
    for f in range(data.shape[0]):
        hip_vec = data[f, 1] - data[f, 0]
        angle = np.pi - math.atan2(hip_vec[2], hip_vec[0])
        if np.rad2deg(angle) >= 180 or np.rad2deg(angle) <= 0:
            if 180 < np.rad2deg(angle) < 360:
                angle = angle - np.deg2rad(360)
        data[f] = data[f] @ _rotation_matrix([0, 1, 0], angle)
    return data[:, 2:]


def h36m_windows(path, mean_dir_vec: np.ndarray, is_train: bool = True,
                 n_poses: int = 34, frame_stride: int = 2,
                 window_stride: int = 10) -> np.ndarray:
    """The npz's ``positions_3d`` ({subject: {action: (F, 32, 3)}}) ->
    (N, n_poses, 27) mean-subtracted direction-vector targets
    (Human36M.__getitem__)."""
    subjects = TRAIN_SUBJECTS if is_train else TEST_SUBJECTS
    with np.load(path, allow_pickle=True) as z:
        data = z["positions_3d"].item()
    windows = []
    for subject, actions in data.items():
        if subject not in subjects:
            continue
        for positions in actions.values():
            positions = normalize_h36m(
                np.asarray(positions, np.float32)[:, list(TARGET_JOINTS)])
            for f in range(0, len(positions), window_stride):
                if f + n_poses * frame_stride > len(positions):
                    break
                windows.append(positions[f:f + n_poses * frame_stride:
                                         frame_stride])
    if not windows:
        raise ValueError("no h36m windows loaded")
    return poses_to_targets(np.stack(windows), mean_dir_vec)


def poses_to_targets(poses: np.ndarray, mean_dir_vec: np.ndarray
                     ) -> np.ndarray:
    """(N, T, 10, 3) joint positions -> (N, T, 27) direction-vector targets
    through the direction-vector / FK round trip (h36m_loader.py:44-46),
    minus the mean; float32, as the JAX package computes it."""
    spec = TED_GESTURE
    dvec = spec.pose_to_dir_vec(torch.from_numpy(
        np.ascontiguousarray(poses, np.float32)))
    dvec = spec.pose_to_dir_vec(spec.dir_vec_to_pose(dvec)).numpy()
    return dvec.reshape(dvec.shape[0], dvec.shape[1], -1) - \
        mean_dir_vec.reshape(1, 1, -1)
