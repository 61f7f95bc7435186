"""Kernels B1-B4 and the denoiser's fused add and layer norm on the card
against their plain versions, B1's autograd, and the wrappers' routing of
CUDA tensors to the kernels.  Marked
``cuda``: it skips on machines without an NVIDIA GPU, where a CUDA kernel
cannot run.
On a GPU machine without JAX:
``python -m pytest tests/test_torch_cuda.py --noconftest`` (the suite's
conftest imports JAX)."""

import math

import pytest
import torch

from ha2g_torch.ops import contrastive as C
from ha2g_torch.ops import gru_kernel as K
from ha2g_torch.ops.add_norm import add_layer_norm, add_layer_norm_plain
from ha2g_torch.ops.gru_kernel import (MAX_HIDDEN, gru_backward_loop,
                                       gru_backward_loop_plain,
                                       gru_recurrence, gru_recurrence_fn,
                                       gru_recurrence_plain)

pytestmark = pytest.mark.cuda

# fp32: summation order only; bf16: a carry rounding flip of one bf16 ulp
# (2^-8 near 1) echoing through later steps
ATOL = {torch.float32: 1e-4, torch.bfloat16: 4 * 2 ** -8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


# the cluster split: ragged last slices (300 = 7 * 38 + 34, 45), one row
# group (B <= 16) and several (96, 97: a ragged last group), FFMA rows
# 1 / 4 / 8 and the bf16 tensor-core path at 16 rows; the GAN baselines'
# batch 128 (16 forward clusters) at the multimodal generator's H = 300
# and its discriminator's H = 64 over 28 steps; the Expressive step's 48
# rows a rank on two data-parallel ranks; the Gesture step's batch 256
# (bf16: the backward's 32-row clusters from batch 113 on), and 113 and
# 200, whose last 32-row group is ragged (17 and 8 rows)
SHAPES = [(7, 3, 48), (34, 1, 300), (34, 8, 300), (34, 96, 300),
          (34, 97, 300), (11, 5, 200), (6, 16, 45), (34, 128, 300),
          (28, 128, 64), (34, 48, 300), (34, 256, 300), (34, 113, 300),
          (34, 200, 300)]


def _b1_args(T, B, H, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    k = H ** -0.5
    args = [torch.randn((T, 2, B, 3 * H), generator=g) * 0.5,
            torch.randn((2, B, H), generator=g) * 0.5,
            (torch.rand((2, H, 3 * H), generator=g) * 2 - 1) * k,
            (torch.rand((2, 3 * H), generator=g) * 2 - 1) * k]
    return [a.to(device, dtype) for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_kernel_matches_plain(cuda, T, B, H, dtype):
    args = _b1_args(T, B, H, dtype, cuda)
    before = gru_recurrence.launches
    got = gru_recurrence(*args)
    torch.cuda.synchronize()
    assert gru_recurrence.launches == before + 1
    want = gru_recurrence_plain(*args)
    assert got.dtype == dtype and got.shape == (T, 2, B, H)
    assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]


def _check_backward_loop(T, B, H, dtype, device):
    """The backward kernel against the plain loop on the same inputs,
    relative L2 of each output within 1e-4."""
    xp, h0, w_hh, b_hh = _b1_args(T, B, H, dtype, device, seed=3)
    outs = gru_recurrence_plain(xp, h0, w_hh, b_hh)
    h_prev = torch.cat([h0[None], outs[:-1]]).float()
    hh = (torch.einsum("tdbh,dhg->tdbg", h_prev, w_hh.float())
          + b_hh.float()[None, :, None]).contiguous()
    d_outs = torch.randn(outs.shape, generator=torch.Generator()
                         .manual_seed(4)).to(device, dtype)
    before = gru_backward_loop.launches
    got = gru_backward_loop(xp, hh, h_prev, w_hh, d_outs)
    torch.cuda.synchronize()
    assert gru_backward_loop.launches == before + 1
    want = gru_backward_loop_plain(xp, hh, h_prev, w_hh, d_outs)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert ((a.double() - b.double()).norm()
                / b.double().norm()).item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_backward_kernel_matches_plain_loop(cuda, T, B, H, dtype):
    """The backward kernel against the plain loop on the same inputs: the
    loop fp32 throughout, the kernel's product bf16 hi + lo (bf16) or
    3xTF32 (fp32)."""
    _check_backward_loop(T, B, H, dtype, cuda)


def test_kernels_reject_hidden_above_max(cuda):
    H = MAX_HIDDEN + 1
    xp, h0, w_hh, b_hh = _b1_args(2, 1, H, torch.float32, cuda)
    with pytest.raises(ValueError, match="exceeds"):
        gru_recurrence(xp, h0, w_hh, b_hh)
    f32 = dict(device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="exceeds"):
        gru_backward_loop(xp, torch.zeros(xp.shape, **f32),
                          torch.zeros((2, 2, 1, H), **f32), w_hh,
                          torch.zeros((2, 2, 1, H), **f32))


def test_max_hidden_launches(cuda):
    """The largest hidden size runs in both dtypes at 16 rows, where the
    forward's shared memory is largest, and the backward at 16 and 128
    rows (bf16: 16 and 32 rows a cluster; the fp32 backward's shared
    memory sets MAX_HIDDEN)."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _b1_args(3, 16, MAX_HIDDEN, dtype, cuda)
        got = gru_recurrence(*args)
        want = gru_recurrence_plain(*args)
        assert K.max_active_clusters(16, MAX_HIDDEN, dtype) >= 1
        assert (got.float() - want.float()).abs().max().item() <= ATOL[dtype]
        for B in (16, 128):
            assert K.max_active_clusters(B, MAX_HIDDEN, dtype,
                                         backward=True) >= 1
            _check_backward_loop(3, B, MAX_HIDDEN, dtype, cuda)


@pytest.mark.parametrize("B", [96, 128])
def test_backward_clusters_run_in_one_wave(cuda, B):
    """The backward's clusters at the Expressive step's batch 96 and the
    baselines' 128 fit on the card at once (bf16: 16 rows a cluster at
    96, 32 at 128)."""
    plan = K.cluster_plan(300, B, torch.bfloat16)
    assert K.max_active_clusters(B, 300, torch.bfloat16, backward=True) \
        >= plan["clusters_backward"]


def test_kernel_rejects_non_contiguous(cuda):
    xp = torch.zeros((4, 2, 3, 24), device=cuda)
    h0 = torch.zeros((2, 3, 8), device=cuda)
    w = torch.zeros((2, 24, 8), device=cuda).transpose(1, 2)  # (2, 8, 24)
    b = torch.zeros((2, 24), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gru_recurrence(xp, h0, w, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(34, 6, 64), (34, 96, 300)])
def test_kernel_autograd_matches_plain_autograd(cuda, dtype, T, B, H):
    """Kernel forward + kernel backward against autograd through the
    plain version (relative L2 per gradient; bf16: the plain graph rounds
    every step's gradient to bf16)."""
    g = torch.Generator().manual_seed(1)
    args = [torch.randn((T, 2, B, 3 * H), generator=g) * 0.5,
            torch.randn((2, B, H), generator=g) * 0.5,
            (torch.rand((2, H, 3 * H), generator=g) * 2 - 1) * H ** -0.5,
            (torch.rand((2, 3 * H), generator=g) * 2 - 1) * H ** -0.5]
    ct = torch.randn((T, 2, B, H), generator=g).to(cuda)
    grads = []
    launches = gru_backward_loop.launches
    for fn in (gru_recurrence_fn, gru_recurrence_plain):
        leaves = [a.to(cuda, dtype).requires_grad_() for a in args]
        (fn(*leaves).float() * ct).sum().backward()
        grads.append([t.grad.double() for t in leaves])
    assert gru_backward_loop.launches == launches + 1
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for got, want in zip(*grads):
        assert ((got - want).norm() / want.norm()).item() <= tol


def _aligned(N, D, sigma, seed):
    """Unit rows a and b = normalize(a + sigma n / sqrt(D)) (s_ii near 1)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.nn.functional.normalize(torch.randn((N, D), generator=g), dim=1)
    b = a + sigma * torch.randn((N, D), generator=g) / D ** 0.5
    return a, torch.nn.functional.normalize(b, dim=1)


# aligned rows against float64 (chip_smoke.py B234_ALIGNED_*): logz and
# diag relative entry by entry, dA and dB relative to their largest entry;
# 2x an fp32 product's error, far below a single TF32 product's
ALIGNED_TOL = {0.3: (1e-5, 2e-5), 0.1: (1e-4, 1.5e-4)}


@pytest.mark.parametrize("N,D,sigma", [(3264, 32, None), (1000, 32, None),
                                       (1000, 128, None), (97, 40, None),
                                       (3264, 32, 0.3), (3264, 32, 0.1),
                                       (1000, 32, 0.3), (1000, 32, 0.1)])
def test_contrastive_kernels_match_plain(cuda, N, D, sigma):
    """B2-B4 on random unit rows, ragged N included, against their plain
    versions (sums of N terms in another order); on aligned rows against
    the plain versions in float64."""
    g = torch.Generator().manual_seed(N)
    if sigma is None:
        a, b = (torch.nn.functional.normalize(
            torch.randn((N, D), generator=g), dim=1) for _ in range(2))
    else:
        a, b = _aligned(N, D, sigma, seed=N)
    a, b = a.to(cuda), b.to(cuda)
    counts = (C.contrastive_fwd.launches, C.contrastive_bwd_da.launches,
              C.contrastive_bwd_db.launches)
    logz, diag = C.contrastive_fwd(a, b)
    gn = torch.full((1,), 0.3 / N, device=cuda)
    da, db = (fn(a, b, logz, gn) for fn in (C.contrastive_bwd_da,
                                            C.contrastive_bwd_db))
    torch.cuda.synchronize()
    # CUDA tensors reached the three kernels, once each
    assert (C.contrastive_fwd.launches, C.contrastive_bwd_da.launches,
            C.contrastive_bwd_db.launches) == tuple(c + 1 for c in counts)
    if sigma is None:
        ref, ref_logz, (rtol, grad_rel) = (a, b), logz, (1e-5, 1e-4)
    else:
        ref = (a.double(), b.double())
        rtol, grad_rel = ALIGNED_TOL[sigma]
    p_logz, p_diag = C.contrastive_fwd_plain(*ref)
    if sigma is not None:
        ref_logz = p_logz
    torch.testing.assert_close(logz.double(), p_logz.double(), rtol=rtol,
                               atol=0)
    torch.testing.assert_close(diag.double(), p_diag.double(), rtol=rtol,
                               atol=0)
    for got, plain in ((da, C.contrastive_bwd_da_plain),
                       (db, C.contrastive_bwd_db_plain)):
        want = plain(*ref, ref_logz, gn[0].to(ref[0].dtype)).double()
        assert (got.double() - want).abs().max() <= grad_rel * want.abs().max()


def test_contrastive_kernels_finite_on_duplicate_rows(cuda):
    """Rows of b that repeat rows of a: their diagonal logits reach ~1e6,
    where B3 or B4 rounding s otherwise than B2 would overflow
    exp(logit - logz).  The kernels share one s function."""
    g = torch.Generator().manual_seed(5)
    a, b = (torch.nn.functional.normalize(torch.randn((3264, 32), generator=g),
                                          dim=1).to(cuda) for _ in range(2))
    b[:5] = a[:5]
    logz, diag = C.contrastive_fwd(a, b)
    gn = torch.full((1,), 1.0 / 3264, device=cuda)
    da = C.contrastive_bwd_da(a, b, logz, gn)
    db = C.contrastive_bwd_db(a, b, logz, gn)
    torch.cuda.synchronize()
    assert diag.max().item() > 1e5
    for t in (logz, diag, da, db):
        assert torch.isfinite(t).all()


def test_contrastive_branch_free_math_is_ieee(cuda):
    """The kernels' sqrt and reciprocal equal sqrtf and 1.0f / x on every
    float the logits can give them."""
    assert C.math_mismatches() == {"sqrt": 0, "rcp": 0}


def test_flash_contrastive_gradient_on_the_card(cuda):
    g = torch.Generator().manual_seed(2)
    feats = [torch.randn((272, 32), generator=g) for _ in range(2)]
    grads = []
    for device in ("cpu", cuda):
        a, b = (f.to(device).detach().requires_grad_() for f in feats)
        C.flash_contrastive(torch.nn.functional.normalize(a, dim=1),
                            torch.nn.functional.normalize(b, dim=1)).backward()
        grads.append([a.grad.cpu(), b.grad.cpu()])
    # the kernels (card) against the plain versions (CPU): sums of N terms
    for got, want in zip(grads[1], grads[0]):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_pinned_loader_matches_host_gather(cuda):
    """The train loader on the card (pinned buffers, non-blocking copies
    queued behind other work) gives the host gather's batches for a seed,
    over two epochs: no pinned buffer is refilled before its copy is
    done."""
    import numpy as np
    from ha2g_torch.data.dataset import WindowedSamples
    from ha2g_torch.data.loader import BatchLoader
    rng = np.random.default_rng(0)
    n = 300
    z = np.zeros
    samples = WindowedSamples(
        text=rng.integers(0, 50, (n, 34)).astype(np.int32),
        word_seq=z((n, 2), np.int32), word_lengths=z(n, np.int32),
        pose=z((n, 34, 3), np.float32),
        target=rng.normal(size=(n, 34, 27)).astype(np.float32),
        audio=z((n, 2), np.float32),
        spec=rng.normal(size=(n, 128, 70)).astype(np.float32),
        vids=np.arange(n, dtype=np.int32))
    keys = ("text", "spec", "target", "vids")
    host = BatchLoader(samples, 32, keys=keys, seed=1)
    card = BatchLoader(samples, 32, keys=keys, seed=1, device=cuda)
    busy = torch.randn((2048, 2048), device=cuda)
    for _ in range(2):
        got = []
        for batch in card:
            got.append(batch)
            for _ in range(4):
                busy = busy @ busy.T / 2048.0
        torch.cuda.synchronize()
        want = list(host)
        assert len(got) == len(want) == len(host)
        for g, w in zip(got, want):
            for k in keys:
                assert g[k].device.type == "cuda"
                assert np.array_equal(g[k].cpu().numpy(), w[k]), k


@pytest.mark.parametrize("gan_on", [False, True])
def test_multimodal_train_step_launches_b1_as_its_dataflow(cuda, gan_on):
    """A narrow multimodal_context step on the card: B1 once a GRU layer
    a generator call (D phase fake, G, diversity) and once a D layer a D
    call (D(out); D(real), D(fake) in the D phase); its backward for G,
    D(out) with the GAN term and both D-phase calls; finite losses."""
    import numpy as np
    from pathlib import Path
    from ha2g_torch.config import Config
    from ha2g_torch.train.loop import build_system

    cfg = Config.from_yaml(Path(__file__).resolve().parents[1] / "configs"
                           / "multimodal_context.yaml", hidden_size=64,
                           n_layers=2, compute_dtype="bfloat16")
    system = build_system(cfg, 16, 4, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"text": rng.integers(0, 16, (8, 34)),
             "audio": (rng.normal(size=(8, 36267)) * 0.1).astype(np.float32),
             "target": (rng.normal(size=(8, 34, 27)) * 0.2)
             .astype(np.float32),
             "vids": rng.integers(0, 4, (8,))}
    f0, b0 = gru_recurrence.launches, gru_backward_loop.launches
    metrics = system.train_step(batch, gan_on,
                                torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    L, d = cfg.n_layers, 4
    assert gru_recurrence.launches - f0 == \
        L * (2 + gan_on) + d * (1 + 2 * gan_on)
    assert gru_backward_loop.launches - b0 == L + d * 3 * gan_on
    assert all(torch.isfinite(v) for v in metrics.values())


def _narrow_hierarchy(device, **kw):
    from ha2g_torch.config import Config
    from ha2g_torch.train.hierarchy import HierarchySystem
    cfg = Config(model="hierarchy", dataset="ted_gesture", pose_dim=27,
                 n_poses=34, hidden_size=32, n_layers=2,
                 compute_dtype="float32", **kw)
    return HierarchySystem(cfg, 20, 5, device=device,
                           generator=torch.Generator().manual_seed(0))


def test_data_parallel_step_on_one_nccl_rank(cuda):
    """The data-parallel path on a 1-rank NCCL group (its all-reduces,
    gathers and gradient bucket) launches the plain step's kernels and
    gives its losses and gradients (chip_smoke.py phase 11 holds the
    full-width step bit for bit)."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from ha2g_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(0)
    batch = {"text": rng.integers(0, 20, (8, 34)),
             "spec": rng.normal(size=(8, 128, 70)).astype(np.float32),
             "target": (rng.normal(size=(8, 34, 27)) * 0.1)
             .astype(np.float32),
             "vids": rng.integers(0, 5, (8,))}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        runs = []
        for mesh in (None, Mesh(1, 1, cuda)):
            system = _narrow_hierarchy(cuda)
            if mesh is not None:
                mesh.place(system)
            before = (gru_recurrence.launches, C.contrastive_fwd.launches)
            metrics = system.train_step(
                batch, True, torch.Generator(cuda).manual_seed(1))
            torch.cuda.synchronize()
            runs.append((metrics, dict(system.named_parameters()),
                         (gru_recurrence.launches - before[0],
                          C.contrastive_fwd.launches - before[1])))
    finally:
        dist.destroy_process_group()
    (m0, p0, n0), (m1, p1, n1) = runs
    assert n0 == n1 and n0[1] == 2
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-6, atol=0)
    for k, p in p0.items():
        if p.grad is not None:
            torch.testing.assert_close(p1[k].grad, p.grad, rtol=1e-5,
                                       atol=1e-7)


def test_run_fused_over_two_devices_matches_one_call(cuda):
    """``run_fused(devices=[cuda, cuda])``: two threads, each half the
    batch, the whole batch's speaker-z noise: within 2e-4 of one call."""
    import numpy as np

    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.synthesis import make_synthesizer

    system = _narrow_hierarchy(cuda, z_type="speaker")
    synth = make_synthesizer(system, system.state_dict())
    lang = Vocab("words")
    for i in range(20 - lang.n_words):
        lang.index_word(f"w{i}")
    rng = np.random.default_rng(1)
    audio = (rng.normal(size=(4, 4 * 16000)) * 0.1).astype(np.float32)
    words = [[(f"w{j}", 0.3 * j, 0.3 * j + 0.2) for j in range(8)]
             for _ in range(4)]
    outs = []
    for devices in (None, [cuda, cuda]):
        plan = synth.prepare_fused(words, lang, np.arange(4), audio.shape[1],
                                   torch.Generator(cuda).manual_seed(2))
        outs.append(synth.run_fused(audio, plan, devices=devices))
    np.testing.assert_allclose(outs[1], outs[0], atol=2e-4)


def test_chunked_run_fused_matches_one_call(cuda, monkeypatch):
    """``run_fused(chunk=, out_dtype=)`` on the card (pinned staging, the
    upload / download streams): chunks of 2 and 3 (a ragged last chunk)
    within 1e-4 of the unchunked call (fp32 with TF32 off, speaker z
    pinned at mu; the convolutions may take another algorithm at another
    batch), B1 launched 3 levels x 2 layers a window a chunk, and the
    float16 pull each float32 pull rounded (float32 out)."""
    import numpy as np

    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.synthesis import make_synthesizer

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    system = _narrow_hierarchy(cuda, z_type="speaker")
    state = system.state_dict()
    for level in range(system.spec.n_levels):
        state[f"gens.{level}.speaker_logvar.weight"].zero_()
        state[f"gens.{level}.speaker_logvar.bias"].fill_(-100.0)
    synth = make_synthesizer(system, state)
    lang = Vocab("words")
    for i in range(20 - lang.n_words):
        lang.index_word(f"w{i}")
    rng = np.random.default_rng(3)
    B = 5
    audio = (rng.normal(size=(B, 5 * 16000)) * 0.1).astype(np.float32)
    mu = (np.sign(audio) * np.log1p(255 * np.abs(audio)) / np.log1p(255))
    audio_u8 = ((mu + 1) / 2 * 255 + 0.5).astype(np.uint8)
    words = [[(f"w{j}", 0.3 * j, 0.3 * j + 0.2) for j in range(8)]
             for _ in range(B)]
    plan = synth.prepare_fused(words, lang, np.arange(B) % 5,
                               audio.shape[1])
    for x in (audio, audio_u8):
        one = synth.run_fused(x, plan)
        for chunk in (2, 3):
            before = gru_recurrence.launches
            got = synth.run_fused(x, plan, chunk=chunk)
            n_chunks = -(-B // chunk)
            assert gru_recurrence.launches - before == \
                plan["num_sub"] * 3 * 2 * n_chunks
            assert got.dtype == np.float32 and got.shape == one.shape
            np.testing.assert_allclose(got, one, atol=1e-4, rtol=0)
            f16 = synth.run_fused(x, plan, chunk=chunk, out_dtype=np.float16)
            assert f16.dtype == np.float32
            np.testing.assert_array_equal(f16, got.astype(np.float16))


def _graph_case(device, B):
    """A narrow bf16 TED Expressive hierarchy (6 levels, 2 GRU layers,
    speaker z) and a batch of B clips of 4.5 s."""
    import numpy as np

    from ha2g_torch.config import Config
    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.synthesis import make_synthesizer
    from ha2g_torch.train.hierarchy import HierarchySystem

    cfg = Config(model="hierarchy", dataset="ted_expressive", pose_dim=126,
                 n_poses=34, n_pre_poses=4, hidden_size=32, n_layers=2,
                 wordembed_dim=16, z_type="speaker", compute_dtype="bfloat16")
    system = HierarchySystem(cfg, 20, 5, device=device,
                             generator=torch.Generator().manual_seed(0))
    synth = make_synthesizer(system, system.state_dict())
    lang = Vocab("words")
    for i in range(20 - lang.n_words):
        lang.index_word(f"w{i}")
    rng = np.random.default_rng(B)
    audio = (rng.normal(size=(B, int(4.5 * 16000))) * 0.1).astype(np.float32)
    words = [[(f"w{j}", 0.3 * j + 0.1 * b, 0.3 * j + 0.2) for j in range(9)]
             for b in range(B)]

    def plan(seed, generator_device=device):
        return synth.prepare_fused(
            words, lang, np.arange(B) % 5, audio.shape[1],
            torch.Generator(generator_device).manual_seed(seed))
    return synth, audio, plan


@pytest.mark.parametrize("B,chunk", [(5, 0), (5, 2), (1, 0)])
def test_graphed_run_fused_equals_eager_bit_for_bit(cuda, B, chunk):
    """The graphed fused loop (a generator on the card, one device) against
    ``devices=[card]``, which runs the same cascade op by op: equal bit for
    bit and the generators in the same state, on the first call (window 0
    of each key op by op, then captured) and on a second (all replays);
    B1 launched 6 levels x 2 layers a window a chunk on both routes, and
    the window counter W - 1 replays a key on the first call, W on the
    second, one capture a key."""
    import numpy as np

    synth, audio, plan = _graph_case(cuda, B)
    keys = 2 if chunk and B % chunk else 1
    n_chunks = -(-B // chunk) if chunk else 1
    for call in range(2):
        graphed, eager = plan(7 + call), plan(7 + call)
        counts = dict(synth.window_counts)
        before = gru_recurrence.launches
        got = synth.run_fused(audio, graphed, chunk=chunk)
        assert gru_recurrence.launches - before == \
            graphed["num_sub"] * 6 * 2 * n_chunks
        W = graphed["num_sub"]
        assert {k: synth.window_counts[k] - counts[k] for k in counts} == {
            "eager": keys if call == 0 else 0,
            "replayed": W * n_chunks - (keys if call == 0 else 0),
            "captured": keys if call == 0 else 0}
        before = gru_recurrence.launches
        want = synth.run_fused(audio, eager, chunk=chunk, devices=[cuda])
        assert gru_recurrence.launches - before == W * 6 * 2 * n_chunks
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
        assert torch.equal(graphed["generator"].get_state(),
                           eager["generator"].get_state())
    assert len(synth._graphs) == keys


def test_graph_reads_the_weights_by_address(cuda):
    """An in-place change of the last level's output bias reaches the next
    replay, which then equals the op-by-op route with the new weights."""
    import numpy as np

    synth, audio, plan = _graph_case(cuda, 5)
    first = synth.run_fused(audio, plan(3))
    replayed = synth.window_counts["replayed"]
    with torch.no_grad():
        synth.system.gens[-1].out[2].bias.add_(0.25)
    got = synth.run_fused(audio, plan(3))
    assert synth.window_counts["replayed"] - replayed == plan(3)["num_sub"]
    assert not np.array_equal(got, first)
    np.testing.assert_array_equal(
        got, synth.run_fused(audio, plan(3), devices=[cuda]))


def test_cpu_generator_on_the_card_runs_op_by_op(cuda):
    """A CPU generator (``prepare_fused``'s default) with speaker z: no
    capture, every window op by op."""
    synth, audio, plan = _graph_case(cuda, 5)
    p = plan(1, "cpu")
    synth.run_fused(audio, p)
    assert synth.window_counts == {"eager": p["num_sub"], "replayed": 0,
                                   "captured": 0}


def test_graphed_diffusion_chain_equals_eager_bit_for_bit(cuda):
    """A narrow bf16 DiffGesture (2 blocks, 16 steps): a window's chain
    replayed from its CUDA graph (captured after a warm-up at the first
    window) against the same chain op by op, a generator on the card:
    equal bit for bit and the generators in the same state, at the
    capture's call and at a later one; then ``generate`` over three
    windows counts every step as replayed, and every pass's layer norms
    as fused kernels."""
    import numpy as np

    from ha2g_torch.config import Config
    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.synthesis import make_synthesizer
    from ha2g_torch.train.loop import build_system

    cfg = Config(model="pose_diffusion", dataset="ted_expressive",
                 pose_dim=126, n_poses=34, n_pre_poses=4,
                 diff_hidden_dim=64, block_depth=2, n_heads=2,
                 diffusion_steps=16, compute_dtype="bfloat16")
    system = build_system(cfg, 4, 1, device=cuda,
                          generator=torch.Generator().manual_seed(0))
    synth = make_synthesizer(system, system.state_dict())
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(3, int(4.5 * 16000))) * 0.1).astype(np.float32)
    before = add_layer_norm.launches
    with torch.inference_mode():
        cond = system.condition(
            torch.zeros(3, 4, 126, device=cuda),
            torch.from_numpy(audio[:, :36266]).to(cuda), synth.dtype)
        for call in range(2):
            graphed, eager = (torch.Generator(cuda).manual_seed(11 + call)
                              for _ in range(2))
            got = synth._chain(cond, graphed)
            want = system.sample(cond, eager, synth.dtype)
            assert torch.isfinite(got).all()
            assert torch.equal(got, want)
            assert torch.equal(graphed.get_state(), eager.get_state())
    assert synth.step_counts == {"eager": 0, "replayed": 2 * 16,
                                 "captured": 16}
    # one fused add and layer norm a norm: 2 x depth + 1 a pass, one pass
    # a step; the graph holds one window's, which the warm-up, each replay
    # and each op-by-op chain launch
    per_window = (2 * 2 + 1) * 16
    (graph,) = synth._graphs.values()
    assert graph.launches == {add_layer_norm: per_window}
    assert add_layer_norm.launches - before == (1 + 2 + 2) * per_window
    before = add_layer_norm.launches
    out = synth.generate(audio, [[]] * 3, Vocab("words"),
                         np.zeros(3, np.int64),
                         generator=torch.Generator(cuda).manual_seed(1))
    assert np.isfinite(out).all() and out.shape == (3, 94, 126)
    assert synth.step_counts == {"eager": 0, "replayed": 5 * 16,
                                 "captured": 16}
    assert add_layer_norm.launches - before == 3 * per_window
    assert len(synth._graphs) == 1


def _add_norm_tol(y) -> float:
    """y's tolerance: the kernel sums a row's statistics in another order
    than PyTorch's Welford loop, and rsqrtf rounds otherwise, which moves y
    before its rounding by up to ~10 float32 ulps of its scale; rounded to
    bf16 that is at most one bf16 ulp.  So: the larger of one ulp of y's
    type and 16 float32 ulps, at y's largest magnitude."""
    eps = max(torch.finfo(y.dtype).eps, 16 * torch.finfo(torch.float32).eps)
    return eps * 2.0 ** math.floor(math.log2(float(y.abs().max())))


# the denoiser's pass at the cell's shape (2 x 64 rows x 34 frames of 512),
# a row count that no block of four rows divides, the positional table
# broadcast over the rows, float32, and the narrow widths of the tests'
# denoisers (one 16-byte piece a lane, lanes idle)
ADD_NORM_SHAPES = [((128, 34, 512), False, torch.bfloat16),
                   ((4349, 512), False, torch.bfloat16),
                   ((128, 34, 512), True, torch.bfloat16),
                   ((128, 34, 512), False, torch.float32),
                   ((6, 34, 64), True, torch.bfloat16),
                   ((5, 7, 32), False, torch.float32)]


def _add_norm_args(shape, broadcast, dtype, device):
    g = torch.Generator().manual_seed(len(shape) + shape[-1])
    h = torch.randn(shape, generator=g)
    d = torch.randn(shape[-2:] if broadcast else shape, generator=g)
    width = shape[-1]
    weight = 1.0 + 0.2 * torch.randn(width, generator=g)
    bias = 0.1 * torch.randn(width, generator=g)
    return [t.to(device, dtype) for t in (h, d, weight, bias)]


@pytest.mark.parametrize("shape,broadcast,dtype", ADD_NORM_SHAPES)
def test_add_layer_norm_kernel_matches_plain(cuda, shape, broadcast, dtype):
    """The fused kernel against its plain version (PyTorch's add and layer
    norm) on the card: the sum bit for bit, y within ``_add_norm_tol`` (one
    bf16 ulp at its scale); the call that keeps no sum gives the same y,
    and each call is one launch."""
    h, d, weight, bias = _add_norm_args(shape, broadcast, dtype, cuda)
    before = add_layer_norm.launches
    with torch.inference_mode():
        s, y = add_layer_norm(h, d, weight, bias, 1e-5)
        _, last = add_layer_norm(h, d, weight, bias, 1e-5, keep_sum=False)
        want_s, want_y = add_layer_norm_plain(h, d, weight, bias, 1e-5)
    torch.cuda.synchronize()
    assert add_layer_norm.launches - before == 2
    assert torch.equal(s, want_s)
    assert torch.equal(last, y)
    assert (y.float() - want_y.float()).abs().max() <= _add_norm_tol(want_y)


@pytest.mark.parametrize("shape,broadcast,dtype", ADD_NORM_SHAPES[2:4])
def test_add_layer_norm_kernel_gradients_are_the_two_ops(cuda, shape,
                                                         broadcast, dtype):
    """With autograd recording, the kernel still runs the forward (one
    launch a call, the same y as under inference mode), and the gradients
    of (h, d, weight, bias) equal autograd's through the add and
    ``F.layer_norm`` bit for bit, with the sum's gradient and without it:
    the backward recomputes the norm from the kernel's sum, which is the
    plain add's bit for bit."""
    args = [t.requires_grad_() for t in
            _add_norm_args(shape, broadcast, dtype, cuda)]
    with torch.inference_mode():
        _, y_inf = add_layer_norm(*args, 1e-5)
    g = torch.Generator().manual_seed(7)
    gs, gy = (torch.randn(shape, generator=g).to(cuda, dtype)
              for _ in range(2))
    want_s, want_y = add_layer_norm_plain(*args, 1e-5)
    before = add_layer_norm.launches
    s, y = add_layer_norm(*args, 1e-5)
    _, last = add_layer_norm(*args, 1e-5, keep_sum=False)
    assert add_layer_norm.launches - before == 2
    assert torch.equal(s, want_s) and torch.equal(y, y_inf)
    for outs, plain, grads in (((s, y), (want_s, want_y), (gs, gy)),
                               ((last,), (want_y,), (gy,))):
        got = torch.autograd.grad(outs, args, grads, retain_graph=True)
        want = torch.autograd.grad(plain, args, grads, retain_graph=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert add_layer_norm.launches - before == 2


def test_add_layer_norm_kernel_runs_on_the_tensors_card(cuda):
    """The last card's tensors while the first is current: the launch goes
    to the tensors' card and stream (on a one-card machine, the same
    card)."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    args = _add_norm_args((128, 34, 512), True, torch.bfloat16, last)
    with torch.cuda.device(0), torch.inference_mode():
        s, y = add_layer_norm(*args, 1e-5)
        want_s, want_y = add_layer_norm_plain(*args, 1e-5)
    torch.cuda.synchronize(last)
    assert s.device == y.device == last
    assert torch.equal(s, want_s)
    assert (y.float() - want_y.float()).abs().max() <= _add_norm_tol(want_y)


def test_add_layer_norm_kernel_rejects_what_it_does_not_take(cuda):
    w = torch.ones(12, device=cuda)
    h = torch.randn(4, 12, device=cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="16-byte"):
            add_layer_norm(h[:, :10], h[:, :10], w[:10], w[:10], 1e-5)
        with pytest.raises(ValueError, match="16-byte pieces"):
            add_layer_norm(h[:, :6].contiguous(), h[:, :6].contiguous(),
                           w[:6], w[:6], 1e-5)
        with pytest.raises(ValueError, match="one type"):
            add_layer_norm(h, h.bfloat16(), w, w, 1e-5)


def test_denoiser_takes_the_kernel_with_and_without_autograd(cuda,
                                                             monkeypatch):
    """A narrow bf16 denoiser on the card: its pass is 2 x depth + 1 fused
    launches under inference mode and with autograd recording; its loss's
    gradients reach every parameter and are those of the plain ops' pass
    within bf16 rounding (y may differ from the plain norm's in its last
    bit)."""
    from ha2g_torch.models import diffusion
    from ha2g_torch.models.diffusion import Denoiser

    torch.manual_seed(0)
    net = Denoiser(126, 159, 34, 64, 2, 2, 4).to(cuda)
    x = torch.randn(6, 34, 126 + 3 + 159, device=cuda).bfloat16()
    before = add_layer_norm.launches
    with torch.inference_mode():
        net(x, net.cast(torch.bfloat16))
    assert add_layer_norm.launches - before == 2 * 2 + 1
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(diffusion, "add_layer_norm",
                                add_layer_norm_plain)
        net.zero_grad()
        out = net(x, net.cast(torch.bfloat16))
        out.float().square().mean().backward()
        grads.append([p.grad.float() for p in net.parameters()])
        assert add_layer_norm.launches - before == 2 * (2 * 2 + 1)
    for got, want in zip(*grads, strict=True):
        assert (got - want).norm() <= 2e-2 * want.norm()


def test_cli_train_on_nccl_ranks_matches_one_process(cuda, tmp_path):
    """``torchrun -m ha2g_torch.cli train`` on every card of the machine (up
    to 4; one NCCL rank a card, ``--fsdp_devices 2``: FSDP's gathers and
    reduce-scatters over ``model`` on NCCL, and on 4 cards the average
    over ``data``) ends within 5e-3 of one process's final validation
    loss (tests/test_parallel.py:278).  Needs two cards or more."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from ha2g_torch.data.storage import save_clips
    from ha2g_torch.data.synthetic import synthetic_clips
    from ha2g_torch.skeleton import TED_GESTURE

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two NVIDIA GPUs or more (NCCL: one rank a card)")
    root = Path(__file__).resolve().parents[1]
    save_clips(tmp_path / "train", synthetic_clips(TED_GESTURE, n_clips=2,
                                                   seed=0))
    save_clips(tmp_path / "val", synthetic_clips(TED_GESTURE, n_clips=2,
                                                 seed=1))

    def args(out):
        return ["-m", "ha2g_torch.cli", "train", "--config",
                str(root / "configs" / "hierarchy.yaml"), "--device", "cuda",
                "--hidden_size", "32", "--n_layers", "2", "--batch_size", "8",
                "--compute_dtype", "float32", "--epochs", "2",
                "--loss_warmup", "0", "--random_seed", "0",
                "--train_data_path", str(tmp_path / "train"),
                "--test_data_path", str(tmp_path / "val"),
                "--model_save_path", str(tmp_path / out),
                "--eval_net_path", ""]

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    runs = [[sys.executable, *args("single")],
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n), *args("ranks"),
             "--fsdp_devices", "2"]]
    for cmd in runs:
        done = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True, timeout=600)
        assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    losses = [json.loads((tmp_path / out / "history.jsonl").read_text()
                         .splitlines()[-1])["loss"]
              for out in ("single", "ranks")]
    assert abs(losses[1] - losses[0]) <= 5e-3 * max(1.0, abs(losses[0])), \
        losses


def _cli(argv):
    import contextlib
    import io

    from ha2g_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_doctor_on_the_card(cuda):
    """``cli doctor``: the card's name, the mel front-end within 1e-2 dB of
    the numpy oracle, and its tiny GAN step launching B1, its backward and
    B2-B4."""
    counters = (K.gru_recurrence, K.gru_backward_loop, C.contrastive_fwd,
                C.contrastive_bwd_da, C.contrastive_bwd_db)
    before = [f.launches for f in counters]
    rc, out = _cli(["doctor"])
    assert rc == 0 and out.splitlines()[-1] == "OK"
    assert torch.cuda.get_device_name(0) in out
    assert all(f.launches > n for f, n in zip(counters, before))


def test_import_then_train_on_imported_samples(cuda, tmp_path):
    """The data path on the card at a narrow width: a cache lmdb in the
    reference's bytes, ``cli import-lmdb --format cache`` (host only: no
    launch), then ``cli train`` of a narrow bf16 hierarchy on the samples
    with fastText vectors, GAN steps launching B1-B4."""
    import json
    from pathlib import Path

    import numpy as np

    from ha2g_torch.data.arrow_legacy import serialize
    from ha2g_torch.data.fasttext_bin import write_model
    from ha2g_torch.data.lmdb_mini import write_lmdb

    rng = np.random.default_rng(5)
    records = {}
    for i in range(20):
        words = [[f"w{rng.integers(0, 12)}", 1.0 + i + 0.25 * k,
                  1.2 + i + 0.25 * k] for k in range(8)]
        aux = {"vid": f"vid_{i % 3}", "start_frame_no": i * 10,
               "end_frame_no": i * 10 + 42, "start_time": 1.0 + i,
               "end_time": 1.0 + i + 42 / 15}
        records[f"{i:010}".encode()] = serialize([
            words, rng.normal(size=(42, 10, 3)).astype(np.float32),
            (rng.normal(size=(42, 9, 3)) * 0.1).astype(np.float32),
            (rng.normal(size=44800) * 0.1).astype(np.float32),
            rng.normal(size=(128, 87)).astype(np.float32), aux])
    write_lmdb(tmp_path / "cache", records)
    words = ["</s>"] + [f"w{i}" for i in range(6)]
    write_model(tmp_path / "vectors.bin", words, rng.normal(
        size=(len(words) + 100, 16)).astype(np.float32), bucket=100,
        minn=3, maxn=6)
    launches = K.gru_recurrence.launches
    rc, out = _cli(["import-lmdb", str(tmp_path / "cache"),
                    str(tmp_path / "samples"), "--format", "cache"])
    assert rc == 0 and "imported 20 windowed samples" in out
    assert K.gru_recurrence.launches == launches
    counters = (K.gru_recurrence, K.gru_backward_loop, C.contrastive_fwd,
                C.contrastive_bwd_da, C.contrastive_bwd_db)
    before = [f.launches for f in counters]
    config = Path(__file__).resolve().parent.parent / "configs" / \
        "hierarchy.yaml"
    rc, _ = _cli(["train", "--config", str(config), "--hidden_size", "32",
                  "--n_layers", "2", "--batch_size", "8", "--epochs", "1",
                  "--loss_warmup", "-1", "--wordembed_dim", "16",
                  "--wordembed_path", str(tmp_path / "vectors.bin"),
                  "--train_data_path", str(tmp_path / "samples"),
                  "--test_data_path", str(tmp_path / "samples"),
                  "--eval_net_path", "",
                  "--model_save_path", str(tmp_path / "out")])
    assert rc == 0
    assert all(f.launches > n for f, n in zip(counters, before))
    rows = [json.loads(ln) for ln in
            (tmp_path / "out" / "history.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
