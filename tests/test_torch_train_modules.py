"""The pieces the port's train step adds, against the JAX package on the
CPU in fp32: training-mode batch norm and its running statistics, the
generator-driven dropout, the conv discriminator (forward and gradients,
train and eval mode) with its converter against export_torch, the
standalone text encoder's freeze and fixed embedding dropout, the flat
YAML reader, the optimisers' settings, and the eval step."""

import glob
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from ha2g_tpu import export_torch
from ha2g_tpu.models.common import BatchNorm as JaxBatchNorm
from ha2g_tpu.models.hierarchy import ConvDiscriminator as JaxDiscriminator
from ha2g_tpu.models.tcn import TextEncoderTCN as JaxTCN
from ha2g_torch import convert
from ha2g_torch.config import Config, read_flat_yaml
from ha2g_torch.models.common import BatchNorm, dropout
from ha2g_torch.models.hierarchy import ConvDiscriminator
from ha2g_torch.models.tcn import TextEncoderTCN
import tests.torch_cpu  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent
# fp32 on both sides: summation order, and flax's one-pass batch variance
# E[x^2] - E[x]^2 against a two-pass one (inputs here have |mean| ~ std)
ATOL = 1e-5


@pytest.mark.parametrize("shape", [(6, 5), (4, 7, 9), (3, 5, 6, 4)])
def test_batch_norm_training_matches_flax(shape):
    """Batch statistics over every axis but the features, normalised in
    fp32; running statistics after one update equal flax's (momentum 0.9,
    *biased* variance); gradients of input, scale and shift."""
    rng = np.random.default_rng(len(shape))
    C = shape[-1]
    x = (rng.normal(size=shape) + 1.0).astype(np.float32)   # channels last
    scale = rng.normal(size=C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    mean0 = rng.normal(size=C).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    ct = rng.normal(size=shape).astype(np.float32)

    bn = JaxBatchNorm()
    stats = {"BatchNorm_0": {"mean": jnp.asarray(mean0),
                             "var": jnp.asarray(var0)}}

    def f(p, xx):
        out, upd = bn.apply({"params": p, "batch_stats": stats}, xx,
                            use_running_average=False,
                            mutable=["batch_stats"])
        return jnp.sum(out * ct), upd["batch_stats"]["BatchNorm_0"]

    p = {"BatchNorm_0": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    (_, new), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(p, jnp.asarray(x))

    m = BatchNorm(C).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_()
    out = m(tx)
    (out * torch.from_numpy(np.moveaxis(ct, -1, 1).copy())).sum().backward()
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(new["mean"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(new["var"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.moveaxis(tx.grad.numpy(), 1, -1),
                               np.asarray(gx), atol=1e-4, rtol=0)
    np.testing.assert_allclose(m.weight.grad.numpy(),
                               np.asarray(gp["BatchNorm_0"]["scale"]),
                               atol=1e-4, rtol=0)
    # eval mode normalises with the (updated) running statistics
    m.eval()
    want = (tx.detach() - m.running_mean.view(1, -1, *[1] * (len(shape) - 2))) \
        / torch.sqrt(m.running_var.view(1, -1, *[1] * (len(shape) - 2)) + 1e-5)
    w = m.weight.view(1, -1, *[1] * (len(shape) - 2))
    b = m.bias.view(1, -1, *[1] * (len(shape) - 2))
    torch.testing.assert_close(m(tx).detach(), want * w + b)


def test_dropout_draws_from_the_generator():
    x = torch.ones(2000)
    a = dropout(x, 0.3, True, torch.Generator().manual_seed(5))
    b = dropout(x, 0.3, True, torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b)
    kept = a != 0
    assert 0.6 < kept.float().mean() < 0.8
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert dropout(x, 0.3, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.3, True, None)


@pytest.mark.parametrize("train", [False, True])
def test_conv_discriminator_matches_jax(train):
    """Forward (and in train mode the running statistics and every
    parameter's gradient), dropout off; the converter's dis.* keys against
    export_torch.export_discriminator."""
    rng = np.random.default_rng(3)
    poses = (rng.normal(size=(5, 34, 27)) * 0.3).astype(np.float32)
    jm = JaxDiscriminator(slope=0.01, dropout=0.0)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(poses)))
    stats = jax.tree.map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape))
                         .astype(np.float32), v["batch_stats"])

    def f(p):
        if train:
            out, upd = jm.apply({"params": p, "batch_stats": stats},
                                jnp.asarray(poses), train=True,
                                mutable=["batch_stats"])
        else:
            out, upd = jm.apply({"params": p, "batch_stats": stats},
                                jnp.asarray(poses)), {"batch_stats": stats}
        return jnp.sum(jnp.log(out)), (out, upd["batch_stats"])

    (_, (want, new_stats)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(v["params"])

    sd = convert.discriminator_state(v["params"], stats)
    ref = export_torch.export_discriminator(v["params"], stats)
    assert sd.keys() == ref.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)

    m = ConvDiscriminator(27, 34, dropout=0.0)
    m.load_state_dict(sd, strict=True)
    m.train(train)
    got = m(torch.from_numpy(poses))
    torch.log(got).sum().backward()
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    want_sd = convert.discriminator_state(jax.device_get(grads),
                                          jax.device_get(new_stats))
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[k].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=k)
    for k, b in m.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want_sd[k].numpy(),
                                       atol=ATOL, rtol=0, err_msg=k)


def test_text_encoder_freeze_and_fixed_embedding_dropout():
    """``freeze`` stops the table's gradient (as the JAX stop_gradient);
    the embedding dropout is 0.1 whatever ``dropout`` is."""
    tokens = np.random.default_rng(4).integers(0, 12, (2, 34))
    jm = JaxTCN(n_words=12, embed_dim=16, hidden_size=8, n_layers=2,
                dropout=0.0, freeze=True)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.asarray(tokens))["params"])
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(
        {"params": p}, jnp.asarray(tokens)) ** 2)))(params)
    m = TextEncoderTCN(12, embed_dim=16, hidden_size=8, n_layers=2,
                       dropout=0.0, freeze=True).eval()
    m.load_state_dict(convert.text_encoder_state(params, 2), strict=True)
    (m(torch.from_numpy(tokens)) ** 2).sum().backward()
    assert m.embedding.weight.grad is None
    assert not np.asarray(grads["embedding"]).any()
    want = convert.text_encoder_state(jax.device_get(grads), 2)
    for k, p in m.named_parameters():
        if p.grad is not None:
            np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=k)
    assert TextEncoderTCN(12, dropout=0.5).emb_dropout == 0.1


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "configs*" /
                                                      "*.yaml"))))
def test_flat_yaml_reader_matches_pyyaml(path):
    assert read_flat_yaml(path) == (yaml.safe_load(Path(path).read_text())
                                    or {})


def test_config_of_the_expressive_hierarchy():
    cfg = Config.from_yaml(ROOT / "configs_expressive" / "hierarchy.yaml")
    assert (cfg.loss_regression_weight, cfg.loss_gan_weight,
            cfg.loss_kld_weight, cfg.loss_reg_weight,
            cfg.loss_contrastive_pos_weight, cfg.loss_contrastive_neg_weight,
            cfg.loss_physical_weight) == (250, 5.0, 0.1, 0.05, 0.2, 0.005,
                                          0.01)
    assert (cfg.batch_size, cfg.hidden_size, cfg.n_layers,
            cfg.compute_dtype, cfg.skeleton.n_levels) == (96, 300, 4,
                                                          "bfloat16", 6)
    assert cfg.mean_dir_vec_array.shape == (126,)


def test_optimisers_are_optax_adam_b1_half():
    from ha2g_torch.train.hierarchy import HierarchySystem
    cfg = Config(hidden_size=8, n_layers=1, z_type="speaker",
                 learning_rate=1e-3, discriminator_lr_weight=0.2)
    s = HierarchySystem(cfg, 8, 2, device="cpu")
    g, d = s.g_opt.param_groups[0], s.d_opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"]) == (1e-3, (0.5, 0.999), 1e-8)
    assert (d["lr"], d["betas"], d["eps"]) == (1e-3 * 0.2, (0.5, 0.999), 1e-8)
    dis = {id(p) for p in s.dis.parameters()}
    assert {id(p) for p in d["params"]} == dis
    assert {id(p) for p in g["params"]} == \
        {id(p) for p in s.parameters()} - dis
