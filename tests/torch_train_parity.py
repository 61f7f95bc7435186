"""One train step of the port's HierarchySystem against the JAX package's,
on the CPU in fp32 (used by tests/test_torch_train_*.py).

Both sides start from the same parameters (the JAX ones, carried across by
``ha2g_torch.convert.hierarchy_state``) and batch-norm statistics
(randomised, so the running-statistics update is not from the identity).
Randomness is frozen as tests/test_train_parity.py freezes it: dropout 0
(the GRUs, the TCNs, the fixed 0.1 embedding dropout and the
discriminator's GRU), speaker z pinned at mu (logvar kernel 0, bias -100),
and the speaker permutation the JAX step drew handed to the port as
``rand_vids``.  The loss weights are configs_expressive/hierarchy.yaml's.

The JAX optimisers are wrapped so that their state keeps the gradient tree
they were given (``_record_grads``), and the port keeps each step's
gradient in ``.grad``: so one step compares the metrics, every gradient
leaf, the new batch-norm statistics and the post-Adam parameters.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from ha2g_tpu.config import Config as JaxConfig
from ha2g_tpu.models.hierarchy import ConvDiscriminator as JaxDiscriminator
from ha2g_tpu.train.hierarchy import HierarchySystem as JaxSystem

from ha2g_torch.config import Config
from ha2g_torch.convert import hierarchy_state
from ha2g_torch.train.hierarchy import HierarchySystem

N_WORDS, N_SPK, B, T = 11, 5, 4, 34
HID, NL = 32, 2
WEIGHTS = dict(loss_regression_weight=250.0, loss_gan_weight=5.0,
               loss_kld_weight=0.1, loss_reg_weight=0.05,
               loss_contrastive_pos_weight=0.2,
               loss_contrastive_neg_weight=0.005, loss_physical_weight=0.01,
               learning_rate=5e-4, discriminator_lr_weight=0.2)

# fp32 on both sides; what differs is summation order (convs, products, the
# GRU recurrence and its backward, the (N, N) contrastive sums) through the
# 34-layer SE-ResNet and the level cascade.  Loss terms: 1e-4 relative.
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
# gradients, per leaf: relative L2 error and cosine of the whole leaf.  A
# leaf whose true gradient is zero (a conv bias right before a batch norm,
# whose mean subtraction cancels it) holds only rounding noise; the floor
# GRAD_FLOOR (absolute L2 of the difference) admits it.
# Measured worst leaf outside the audio encoder: 1.3e-5.
GRAD_REL, GRAD_COS, GRAD_FLOOR = 1e-4, 0.99999, 1e-6
# a leaf whose true gradient is zero, against its layer's weight gradient
# (compare_step's zero_grad)
ZERO_GRAD_REL = 1e-3
# the audio encoder's leaves: train-mode batch norm at batch 4 through the
# 36 batch norms of the SE-ResNet amplifies fp32 rounding in the backward.
# Measured against the port run in float64: the port's fp32 gradients are
# within 2e-3 of it, the JAX package's within 1.3e-2 (flax's one-pass
# variance and XLA's conv backward round differently), worst leaf first.
AUDIO_GRAD_REL, AUDIO_GRAD_COS = 3e-2, 0.999
# batch-norm running statistics: momentum-0.1 updates of fp32 batch moments
# taken another way (flax's one-pass E[x^2] - E[x]^2 against a two-pass
# variance), 1e-4 relative.  D's third update (on the generated poses, after
# D's Adam step) adds an absolute 2e-5: the bias of the conv before each of
# D's norms has a zero true gradient (the norm cancels it), so Adam moves it
# by lr_D * sign(rounding noise), up to 2 lr_D = 2e-4 apart between the
# sides, and the norm's running mean takes 0.1 of that shift: 0.2 lr_D in
# all, which compare_step takes from its d_lr (2e-5 for the hierarchy).
STATS_RTOL, STATS_ATOL_PER_D_LR = 1e-4, 0.2


def _record_grads() -> optax.GradientTransformation:
    """Passes the updates through and keeps them (the gradients, when it
    comes first in a chain) in its state."""
    return optax.GradientTransformation(
        lambda params: {"grads": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"grads": updates}))


def _randomise_stats(tree, rng):
    if isinstance(tree, dict):
        return {k: _randomise_stats(v, rng) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, np.shape(v)) if k == "var" else
                 rng.normal(0, 0.1, np.shape(v))).astype(np.float32)
                for k, v in tree.items()}
    return tree


def _common(dataset: str, pose_dim: int, mean_vec) -> dict:
    return dict(model="hierarchy", dataset=dataset, pose_dim=pose_dim,
                n_poses=T, n_pre_poses=4, hidden_size=HID, n_layers=NL,
                z_type="speaker", input_context="both", dropout_prob=0.0,
                mean_dir_vec=[float(v) for v in mean_vec], **WEIGHTS)


@functools.cache
def jax_setup(dataset: str, pose_dim: int, seed: int = 0):
    """-> (JAX system, its state, batch of numpy arrays, config fields);
    the JAX side is functional, so tests of one hierarchy share it."""
    rng = np.random.default_rng(seed)
    common = _common(dataset, pose_dim,
                     (rng.normal(size=pose_dim) * 0.1).astype(np.float32))
    system = JaxSystem(JaxConfig(**common), n_words=N_WORDS,
                       n_speakers=N_SPK)
    system.dis = JaxDiscriminator(slope=0.01, dropout=0.0)
    system.text = system.text.clone(emb_dropout=0.0)
    system.gens = tuple(g.clone(emb_dropout=0.0) for g in system.gens)
    system.g_tx = optax.chain(_record_grads(), system.g_tx)
    system.d_tx = optax.chain(_record_grads(), system.d_tx)
    batch = {
        "text": rng.integers(0, N_WORDS, (B, T)).astype(np.int32),
        "spec": rng.normal(size=(B, 128, 70)).astype(np.float32),
        "target": (rng.normal(size=(B, T, pose_dim)) * 0.2)
        .astype(np.float32),
        "vids": rng.integers(0, N_SPK, (B,)).astype(np.int32),
    }
    state = system.init(jax.random.PRNGKey(seed),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.device_get(state.params)
    for g in params["gens"]:
        lv = g["SpeakerZ_0"]["Dense_2"]["Dense_0"]
        lv["kernel"] = np.zeros_like(lv["kernel"])
        lv["bias"] = np.full_like(lv["bias"], -100.0)
    stats = _randomise_stats(jax.device_get(state.batch_stats), rng)
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    return system, state, batch, common


def port_setup(state, common) -> HierarchySystem:
    """The port's system on the CPU with the JAX state's parameters and
    statistics and the same randomness frozen."""
    port = HierarchySystem(Config(**common), N_WORDS, N_SPK, device="cpu")
    port.load_state_dict(hierarchy_state(jax.device_get(state.params),
                                         jax.device_get(state.batch_stats),
                                         NL), strict=True)
    port.text.emb_dropout = 0.0
    for g in port.gens:
        g.text_encoder.emb_dropout = 0.0
    port.dis.gru.dropout = 0.0
    return port


def _is_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var", "num_batches_tracked"))


def _state(tree_params, tree_stats) -> dict[str, np.ndarray]:
    sd = hierarchy_state(jax.device_get(tree_params),
                         jax.device_get(tree_stats), NL)
    return {k: v.numpy() for k, v in sd.items()}


@functools.cache
def jax_step(dataset: str, pose_dim: int, gan_on: bool):
    """The JAX step of ``jax_setup``'s system (one compile a module) ->
    (metrics, speaker permutation it drew, its gradients and its new state
    in the port's layout)."""
    system, state, batch, _ = jax_setup(dataset, pose_dim)
    rng = jax.random.PRNGKey(42)
    new_state, metrics = system.make_train_step(gan_on)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    k_perm = jax.random.split(rng, 5)[3]
    rand_vids = np.asarray(jax.random.permutation(k_perm, batch["vids"]))
    g_grads = new_state.g_opt[0]["grads"]
    want_grads = _state({**g_grads, "dis": new_state.d_opt[0]["grads"]},
                        new_state.batch_stats)
    return ({k: float(v) for k, v in metrics.items()}, rand_vids, want_grads,
            _state(new_state.params, new_state.batch_stats))


def run_and_compare(dataset: str, pose_dim: int, gan_on: bool) -> None:
    _, state, batch, common = jax_setup(dataset, pose_dim)
    port = port_setup(state, common)
    old = {k: v.detach().clone().numpy() for k, v in port.state_dict().items()}
    metrics, rand_vids, want_grads, want_new = jax_step(dataset, pose_dim,
                                                        gan_on)
    got = port.train_step(batch, gan_on, torch.Generator().manual_seed(0),
                          rand_vids=torch.tensor(rand_vids))
    compare_step(got, metrics, port, old, want_grads, want_new,
                 lr=WEIGHTS["learning_rate"],
                 d_lr=WEIGHTS["learning_rate"]
                 * WEIGHTS["discriminator_lr_weight"])


def start_dp_ranks(dataset: str, pose_dim: int, gan_on: bool, out):
    """Start the port's step on 2 data-parallel ranks (gloo, 2 rows each of
    the 4-row batch; tests/torch_parallel_child.py) from ``jax_setup``'s
    state, with the speaker permutation the JAX step draws (its key is
    split without compiling the step, so the ranks run while it
    compiles).  -> the ranks (``Ranks``)."""
    from tests.torch_parallel_child import Ranks

    _, state, batch, common = jax_setup(dataset, pose_dim)
    k_perm = jax.random.split(jax.random.PRNGKey(42), 5)[3]
    rand_vids = np.asarray(jax.random.permutation(k_perm, batch["vids"]))
    torch.save({"config": common, "n_words": N_WORDS, "n_speakers": N_SPK,
                "state": port_setup(state, common).state_dict(),
                "batch": batch, "gan_on": gan_on,
                "rand_vids": torch.tensor(rand_vids)},
               out / "jax_dp_input.pt")
    return Ranks("jax_dp", out)


def compare_dp_step(dataset: str, pose_dim: int, gan_on: bool,
                    ranks) -> None:
    """The 2-rank step of ``start_dp_ranks`` against the JAX step, by
    ``compare_step``: the metrics averaged over the ranks, rank 0's
    averaged gradients and new state."""
    _, state, _, common = jax_setup(dataset, pose_dim)
    port = port_setup(state, common)
    old = {k: v.detach().clone().numpy() for k, v in port.state_dict().items()}
    metrics, _, want_grads, want_new = jax_step(dataset, pose_dim, gan_on)
    rank0 = ranks.results()[0]
    port.load_state_dict(rank0["state"], strict=True)
    for key, p in port.named_parameters():
        p.grad = rank0["grads"][key]
    compare_step(rank0["metrics"], metrics, port, old, want_grads, want_new,
                 lr=WEIGHTS["learning_rate"],
                 d_lr=WEIGHTS["learning_rate"]
                 * WEIGHTS["discriminator_lr_weight"])


def compare_step(got: dict, metrics: dict, port, old: dict,
                 want_grads: dict, want_new: dict, lr: float, d_lr: float,
                 loose: tuple = ("audio.",), zero_grad: tuple = ()) -> None:
    """Hold one port train step to the JAX step's: ``got`` / ``metrics``
    the two steps' metrics, ``port`` the port's system after its step,
    ``old`` its state dict before, ``want_grads`` / ``want_new`` the JAX
    step's gradients and new state in the port's layout (numpy).  Leaves
    under a ``loose`` prefix (batch-normed encoders) take the audio
    encoder's gradient bounds; ``dis.*`` parameters step at ``d_lr``.

    ``zero_grad`` names leaves whose true gradient is zero: the bias of a
    conv or linear layer right before a train-mode batch norm, whose mean
    subtraction cancels it.  Each side's gradient there is rounding noise,
    whose size grows with the loss weights (past GRAD_FLOOR at a
    regression weight of 500), so both are held under ZERO_GRAD_REL of the
    norm of the same layer's weight gradient instead of to each other."""
    # every metric of the JAX step, no other
    assert set(got) == set(metrics), (sorted(got), sorted(metrics))
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)

    # every gradient leaf, through the converter
    params = dict(port.named_parameters())
    assert {k for k in want_grads if not _is_stat(k)} == set(params)
    for key, p in params.items():
        want = want_grads[key].ravel().astype(np.float64)
        have = (np.zeros_like(want) if p.grad is None
                else p.grad.numpy().ravel().astype(np.float64))
        if key in zero_grad:
            scale = np.linalg.norm(want_grads[key[:-len("bias")] + "weight"])
            assert max(np.linalg.norm(have), np.linalg.norm(want)) <= \
                ZERO_GRAD_REL * scale, f"{key}: not a zero gradient"
            continue
        diff = np.linalg.norm(have - want)
        if diff <= GRAD_FLOOR:
            continue
        rel, cos_min = ((AUDIO_GRAD_REL, AUDIO_GRAD_COS)
                        if key.startswith(loose) else (GRAD_REL, GRAD_COS))
        nw = np.linalg.norm(want)
        assert diff <= rel * nw, \
            f"{key}: gradient rel err {diff / nw:.2e} (> {rel})"
        cos = float(have @ want / (np.linalg.norm(have) * nw))
        assert cos >= cos_min, f"{key}: gradient cosine {cos:.7f}"

    # the new batch-norm statistics
    have_new = {k: v.numpy() for k, v in port.state_dict().items()}
    n_stats = 0
    for key in want_new:
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(have_new[key], want_new[key],
                                       atol=STATS_ATOL_PER_D_LR * d_lr,
                                       rtol=STATS_RTOL,
                                       err_msg=key)
            n_stats += 1
    assert n_stats > 0

    # post-Adam parameters.  A first Adam step moves each element by
    # lr * g / (|g| + eps), eps = 1e-8, whatever the betas: lr * sign(g) to
    # within lr * eps / |g|.  So where both sides' gradients share a sign
    # and exceed 1e-4 in size, the new parameters must agree to 1e-3 of lr
    # (plus two fp32 spacings of the parameter), and no element may move by
    # more than lr.
    for key, p in params.items():
        lr_p = d_lr if key.startswith("dis.") else lr
        g_want = want_grads[key]
        g_have = np.zeros_like(g_want) if p.grad is None else p.grad.numpy()
        clear = ((np.sign(g_want) == np.sign(g_have))
                 & (np.minimum(np.abs(g_want), np.abs(g_have)) > 1e-4))
        tol = 1e-3 * lr_p + 2 * np.spacing(np.abs(old[key]))
        err = np.abs(have_new[key] - want_new[key])
        assert (err <= tol)[clear].all(), \
            f"{key}: post-Adam parameters differ by up to {err[clear].max()}"
        assert np.abs(have_new[key] - old[key]).max() <= lr_p * 1.001 + \
            np.spacing(np.abs(old[key])).max() * 2, key
