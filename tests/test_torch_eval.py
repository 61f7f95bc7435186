"""The port's evaluation layer against the JAX package's, on the CPU in
fp32: forward kinematics, the FGD embedders (EmbeddingNet in pose mode,
MotionAE) with their converters, the embedding-space evaluator, and the
MAJE / accel / onset / beat-consistency metrics.  Inputs come from seeded
numpy; JAX parameters cross over through ha2g_torch.convert."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import skeleton as jsk
from ha2g_tpu.eval import fgd as jfgd
from ha2g_tpu.eval import metrics as jmetrics
from ha2g_tpu.export_torch import export_embedding_net_pose, export_motion_ae
from ha2g_tpu.models.embedding_net import EmbeddingNet as JaxEmbeddingNet
from ha2g_tpu.models.motion_ae import MotionAE as JaxMotionAE

from ha2g_torch import skeleton as psk
from ha2g_torch.convert import embedding_net_pose_state, motion_ae_state
from ha2g_torch.eval import fgd as pfgd
from ha2g_torch.eval import metrics as pmetrics
from ha2g_torch.models.embedding_net import EmbeddingNet
from ha2g_torch.models.motion_ae import MotionAE

T = 34
SKELETONS = ("ted_gesture", "ted_expressive")


def _randomise_stats(tree, rng):
    """Running statistics away from (0, 1), so eval-mode batch norm is
    exercised."""
    return {k: _randomise_stats(v, rng) if isinstance(v, dict) else
            (rng.uniform(0.5, 1.5, np.shape(v)) if k == "var" else
             rng.normal(0, 0.1, np.shape(v))).astype(np.float32)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SKELETONS)
def test_fk_and_ik_match_jax(name):
    """dir_vec_to_pose / pose_to_dir_vec against JAX within 1e-5 (fp32
    products in another order), and FK -> IK returns the unit vectors."""
    jspec, pspec = jsk.SKELETONS[name], psk.SKELETONS[name]
    assert pspec.n_joints == jspec.n_joints
    np.testing.assert_array_equal(pspec.path_matrix, jspec.path_matrix)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 5, jspec.n_bones, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    flat = v.reshape(3, 5, -1)
    want = np.asarray(jspec.dir_vec_to_pose(jnp.asarray(flat)))
    got = pspec.dir_vec_to_pose(torch.from_numpy(flat)).numpy()
    assert got.shape == (3, 5, jspec.n_joints, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    pose = rng.normal(size=(3, 5, jspec.n_joints * 3)).astype(np.float32)
    pose[..., :3] = pose[..., 3:6]          # a zero-length bone stays zero
    want = np.asarray(jspec.pose_to_dir_vec(jnp.asarray(pose)))
    got = pspec.pose_to_dir_vec(torch.from_numpy(pose)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    back = pspec.pose_to_dir_vec(pspec.dir_vec_to_pose(torch.from_numpy(v)))
    np.testing.assert_allclose(back.numpy(), v, atol=1e-5)
    assert psk.skeleton_for_pose_dim(jspec.pose_dim) is pspec


# ---------------------------------------------------------------------------
# the FGD embedders
# ---------------------------------------------------------------------------

def _jax_embedder(pose_dim, seed):
    """-> (apply fn returning (feature, recon), params, batch_stats,
    the port's module with the converted state, export_torch's state)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((2, T, pose_dim), np.float32)
    if pose_dim == 126:
        net = JaxMotionAE(pose_dim=pose_dim)
        v = net.init(jax.random.PRNGKey(seed), x)
        fn = jax.jit(lambda v, p: net.apply(v, p, train=False)[::-1])
        convert, export, port = motion_ae_state, export_motion_ae, \
            MotionAE(pose_dim)
    else:
        net = JaxEmbeddingNet(pose_dim=pose_dim, n_frames=T, mode="pose")
        v = net.init({"params": jax.random.PRNGKey(seed),
                      "noise": jax.random.PRNGKey(seed + 1)},
                     None, None, None, x)
        fn = jax.jit(lambda v, p: (lambda o: (o[3], o[6]))(net.apply(
            v, None, None, None, p, input_mode="pose", train=False)))
        convert, export, port = embedding_net_pose_state, \
            export_embedding_net_pose, EmbeddingNet(pose_dim, T)
    params = jax.device_get(v["params"])
    stats = _randomise_stats(jax.device_get(v["batch_stats"]), rng)
    variables = {"params": params, "batch_stats": stats}
    sd = convert(params, stats)
    port.load_state_dict(sd, strict=True)
    port.eval()
    return (lambda p: [np.asarray(a) for a in fn(variables, p)], params,
            stats, port, sd, export(params, stats))


@pytest.mark.parametrize("pose_dim", (27, 126))
def test_embedder_matches_jax(pose_dim):
    """EmbeddingNet(mode="pose") (27) and MotionAE (126) in eval mode
    against JAX's apply with converted params: features and
    reconstructions within 1e-4 (fp32 convs in another order); the
    converter equals export_torch key for key."""
    jax_fn, _, _, port, sd, exported = _jax_embedder(pose_dim, seed=3)
    assert set(sd) == set(exported)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), exported[k].numpy(),
                                      err_msg=k)
    x = np.random.default_rng(4).normal(size=(6, T, pose_dim)) \
        .astype(np.float32)
    want_feat, want_recon = jax_fn(x)
    feat, recon = port.embed(torch.from_numpy(x))
    assert feat.shape == want_feat.shape and recon.shape == x.shape
    np.testing.assert_allclose(feat.numpy(), want_feat, atol=1e-4)
    np.testing.assert_allclose(recon.numpy(), want_recon, atol=1e-4)


def test_embedding_net_other_modes_wait():
    """The joint-embedding modes no longer wait (ROADMAP A.5 is ported):
    mode "speech" builds the context encoder and the GRU decoder beside
    the pose encoder, the pose mode keeps the embedder's layout, and an
    unknown mode raises."""
    net = EmbeddingNet(27, T, mode="speech", n_words=8, word_embed_dim=8)
    keys = {k.split(".")[0] for k in net.state_dict()}
    assert keys == {"context_encoder", "pose_encoder", "decoder"}
    assert any(k.startswith("decoder.gru.") for k in net.state_dict())
    assert {k.split(".")[0] for k in EmbeddingNet(27, T).state_dict()} == \
        {"pose_encoder", "decoder"}
    with pytest.raises(ValueError, match="mode"):
        EmbeddingNet(27, T, mode="both")


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pose_dim,n_batches", ((27, 6), (126, 10)))
def test_evaluator_matches_jax(pose_dim, n_batches):
    """The same batches pushed through both evaluators.  frechet within
    1e-3 relative (sqrtm of products of covariances of fp32 features that
    differ in the last bits), feat_dist within 1e-5 relative, the
    diversity score with the same numpy generator within 1e-5, and the
    recon-gap list within 1e-4.  More samples than feature dimensions, so
    the covariances are full rank."""
    _, params, stats, _, sd, _ = _jax_embedder(pose_dim, seed=5)
    jev = jfgd.EmbeddingSpaceEvaluator(pose_dim, T, params, stats)
    pev = pfgd.EmbeddingSpaceEvaluator(pose_dim, T, sd, device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(n_batches):
        real = rng.normal(size=(16, T, pose_dim)).astype(np.float32)
        gen = (real + rng.normal(size=real.shape) * 0.5).astype(np.float32)
        jev.push_samples(gen, real)
        pev.push_samples(torch.from_numpy(gen), real)
    assert pev.get_no_of_samples() == jev.get_no_of_samples() == n_batches
    fd_j, feat_j = jev.get_scores()
    fd_p, feat_p = pev.get_scores()
    assert np.isfinite(fd_p) and fd_p > 0
    np.testing.assert_allclose(fd_p, fd_j, rtol=1e-3)
    np.testing.assert_allclose(feat_p, feat_j, rtol=1e-5)
    div_j = jev.get_diversity_scores(np.random.default_rng(9))
    div_p = pev.get_diversity_scores(np.random.default_rng(9))
    assert div_p > 0
    np.testing.assert_allclose(div_p, div_j, rtol=1e-5)
    np.testing.assert_allclose(pev.recon_err_diff, jev.recon_err_diff,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ("identical", "mean_shift", "random"))
def test_frechet_distance_matches_jax(case):
    """The golden cases of tests/test_eval.py, and a random pair, through
    both implementations (the same numpy / scipy arithmetic: 1e-9)."""
    rng = np.random.default_rng({"identical": 0, "mean_shift": 1,
                                 "random": 2}[case])
    if case == "identical":
        x = rng.normal(size=(500, 16))
        args = (x.mean(0), np.cov(x, rowvar=False)) * 2
        want = 0.0
    elif case == "mean_shift":
        sig = np.cov(rng.normal(size=(2000, 8)), rowvar=False)
        args = (np.zeros(8), sig, np.ones(8) * 2.0, sig)
        want = 32.0
    else:
        x, y = rng.normal(size=(300, 8)), rng.normal(size=(300, 8)) * 1.5
        args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0) + 0.3,
                np.cov(y, rowvar=False))
        want = jfgd.frechet_distance(*args)
    got = pfgd.frechet_distance(*args)
    np.testing.assert_allclose(got, jfgd.frechet_distance(*args), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _audio(B, seed):
    """Noise with 440 Hz clicks at seeded times, one window long."""
    rng = np.random.default_rng(seed)
    sr = 16000
    audio = (rng.normal(size=(B, int(T / 15 * sr))) * 0.01).astype(np.float32)
    for b in range(B):
        for t in np.sort(rng.uniform(0.1, 2.0, 4)):
            i = int(t * sr)
            audio[b, i:i + 200] += np.sin(2 * np.pi * 440 * np.arange(200)
                                          / sr).astype(np.float32)
    return audio


@pytest.mark.parametrize("name", SKELETONS)
def test_metrics_match_jax(name):
    """maje_and_accel within 1e-5 relative (FK in fp32 on both sides);
    onset_detect_times exactly equal (the same float64 numpy arithmetic
    and the same filterbank); beat_consistency with the same count and
    the score within 1e-6."""
    from ha2g_torch.data.synthetic import default_mean_dir_vec
    jspec, pspec = jsk.SKELETONS[name], psk.SKELETONS[name]
    mean = default_mean_dir_vec(pspec)
    rng = np.random.default_rng(7)
    tgt = (rng.normal(size=(4, T, jspec.pose_dim)) * 0.3).astype(np.float32)
    out = (tgt + rng.normal(size=tgt.shape) * 0.1).astype(np.float32)
    want = jmetrics.maje_and_accel(out, tgt, mean, jspec, 4)
    got = pmetrics.maje_and_accel(out, tgt, mean, pspec, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)

    audio = _audio(4, seed=8)
    n_onsets = 0
    for b in range(4):
        got_t = pmetrics.onset_detect_times(audio[b])
        np.testing.assert_array_equal(got_t, jmetrics.onset_detect_times(
            audio[b]))
        n_onsets += len(got_t)
    assert n_onsets >= 8
    bc_j, n_j = jmetrics.beat_consistency(out, audio, mean, jspec)
    bc_p, n_p = pmetrics.beat_consistency(out, audio, mean, pspec)
    assert n_p == n_j > 0
    np.testing.assert_allclose(bc_p, bc_j, rtol=1e-6, atol=1e-6)
