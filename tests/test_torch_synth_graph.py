"""The fused loop's CUDA-graph path, as far as the CPU shows it: which
calls would capture and replay (the card, a generator on the card or no
noise, the single-device path), the window counter reading only windows
run op by op here, the fused loop's output equal to the plain window loop
it replaced, the launch counters' capture and replay rule, and the
cascade's index tensors uploaded once a device with the routing they had.
The capture and the replays themselves run on the card
(tests/test_torch_cuda.py)."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch import kernels
from ha2g_torch import skeleton as tsk
from ha2g_torch.config import Config
from ha2g_torch.data.vocab import Vocab
from ha2g_torch.synthesis import (_cross_fade, _graphable, _mel_any,
                                  make_synthesizer)
from ha2g_torch.train.cascade import build_pre_seq
from ha2g_torch.train.hierarchy import HierarchySystem

N_WORDS, N_SPK = 16, 4


@pytest.fixture(scope="module")
def case():
    cfg = Config(model="hierarchy", dataset="ted_expressive", pose_dim=126,
                 n_poses=34, n_pre_poses=4, hidden_size=16, n_layers=2,
                 wordembed_dim=16, z_type="speaker")
    system = HierarchySystem(cfg, N_WORDS, N_SPK, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    synth = make_synthesizer(system, system.state_dict())
    lang = Vocab("words")
    for i in range(N_WORDS - lang.n_words):
        lang.index_word(f"w{i}")
    rng = np.random.default_rng(0)
    B = 3
    audio = (0.1 * rng.normal(size=(B, int(4.5 * 16000)))).astype(np.float32)
    words = [[(f"w{j}", 0.3 * j, 0.3 * j + 0.2) for j in range(b + 4)]
             for b in range(B)]
    return types.SimpleNamespace(synth=synth, lang=lang, audio=audio,
                                 words=words, vids=np.arange(B) % N_SPK)


def _plan(case, seed=1):
    return case.synth.prepare_fused(case.words, case.lang, case.vids,
                                    case.audio.shape[1],
                                    torch.Generator().manual_seed(seed))


def _window_loop(synth, audio, plan):
    """The fused loop as it ran before the graph path: every window's
    cascade op by op, its carry a view of its output."""
    cfg, gen = synth.cfg, plan["generator"]
    n, T, W = cfg.n_pre_poses, cfg.n_poses, plan["num_sub"]
    spec = _mel_any(audio, synth.device)
    spec = F.pad(spec, (0, plan["pad_to"] - plan["S_total"]),
                 mode="replicate")
    spec_all = torch.stack([spec[:, :, s0:s0 + plan["spec_len"]]
                            for s0 in plan["s0_all"]])
    B = spec.shape[0]
    vids = plan["vids"]
    blend = synth.system.audio(spec_all.flatten(0, 1), vids.repeat(W),
                               synth.dtype)[-1]
    blend_all = blend.unflatten(1, (W, B)).transpose(0, 1)
    pieces, tail = [], torch.zeros((B, n, synth.spec.pose_dim))
    for w in range(W):
        out = synth._cascade_step(plan["text_all"][w], blend_all[w], tail,
                                  vids, gen)
        head = out[:, :n] if w == 0 else _cross_fade(tail, out[:, :n])
        tail = out[:, -n:]
        pieces.append(torch.cat(
            [head, out[:, n:T if w == W - 1 else T - n]], dim=1))
    return torch.cat(pieces, dim=1).numpy()


@pytest.mark.parametrize("route", ["one call", "chunk", "devices"])
def test_cpu_counts_only_eager_windows_and_output_unchanged(case, route):
    synth = case.synth
    kw = {"one call": {}, "chunk": {"chunk": 2},
          "devices": {"devices": ["cpu"]}}[route]
    plan, ref_plan = _plan(case), _plan(case)
    before = dict(synth.window_counts)
    with torch.inference_mode():
        want = _window_loop(synth, case.audio, ref_plan)
    got = synth.run_fused(case.audio, plan, **kw)
    chunks = 2 if route == "chunk" else 1
    W = plan["num_sub"]
    assert W >= 2
    counts = {k: synth.window_counts[k] - before[k] for k in before}
    assert counts == {"eager": W * chunks, "replayed": 0, "captured": 0}
    assert synth._graphs == {}
    if route != "chunk":     # a chunk draws the noise at its own batch
        np.testing.assert_array_equal(got, want)
        assert torch.equal(plan["generator"].get_state(),
                           ref_plan["generator"].get_state())


def _gens(z_type, training=False):
    return [types.SimpleNamespace(z_type=z_type, training=training)] * 3


CARD = torch.device("cuda:0")


@pytest.mark.parametrize("device,generator,gens,want", [
    (CARD, CARD, _gens("speaker"), True),
    (CARD, torch.device("cpu"), _gens("speaker"), False),
    (CARD, torch.device("cuda:1"), _gens("random"), False),
    (CARD, torch.device("cpu"), _gens("none"), True),
    (CARD, torch.device("cpu"), _gens("none", training=True), False),
    (CARD, CARD, _gens("speaker", training=True), False),
    (torch.device("cpu"), torch.device("cpu"), _gens("speaker"), False),
    (torch.device("cpu"), torch.device("cpu"), _gens("none"), False),
])
def test_graph_engages_from_the_inputs(device, generator, gens, want):
    """The card, eval mode, and the noise's generator on the card or no
    noise drawn."""
    gen = types.SimpleNamespace(device=generator)
    assert _graphable(device, gen, gens) is want


def test_launch_counts_of_capture_and_replay():
    def wrapper():
        kernels.count_launch(wrapper)
    wrapper.launches = 0

    wrapper()
    assert wrapper.launches == 1
    with kernels.captured_launches() as tally:
        wrapper()
        wrapper()
    assert wrapper.launches == 1 and tally == {wrapper: 2}
    for _ in range(3):                  # three replays
        kernels.add_launches(tally)
    wrapper()
    assert wrapper.launches == 1 + 3 * 2 + 1


def _uncached_pre_seq(level_target, prev_out, level, spec, n_pre):
    """build_pre_seq with its index tensors made from the host each call."""
    B, T, D = level_target.shape
    pre = level_target.new_zeros((B, T, D + 1))
    pre[:, :n_pre, :D] = level_target[:, :n_pre]
    pre[:, :n_pre, D] = 1.0
    if prev_out is not None:
        src, dst = (torch.as_tensor(c) for c in spec.routing_indices(level - 1))
        pre[:, n_pre:, dst] = prev_out[:, n_pre:].index_select(-1, src) \
            .to(pre.dtype)
    return pre


@pytest.mark.parametrize("name", ["ted_gesture", "ted_expressive"])
@pytest.mark.parametrize("compat", [False, True])
def test_cached_indices_route_as_before(name, compat):
    spec = (tsk.REF_COMPAT_SKELETONS if compat else tsk.SKELETONS)[name]
    rng = np.random.default_rng(2)
    target = torch.from_numpy(
        rng.normal(size=(2, 34, spec.pose_dim)).astype(np.float32))
    for level in range(spec.n_levels):
        cols = torch.as_tensor(spec.level_slice_cols(level))
        t_l = spec.extract_level_target(target, level)
        assert torch.equal(t_l, target.index_select(-1, cols))
        prev = None if level == 0 else torch.from_numpy(rng.normal(
            size=(2, 34, spec.level_dim(level - 1))).astype(np.float32))
        got = build_pre_seq(t_l, prev, level, spec, 4)
        assert torch.equal(got, _uncached_pre_seq(t_l, prev, level, spec, 4))
        if level:
            first = spec.on_device("routing_indices", level - 1, "cpu")
            assert all(a is b for a, b in zip(
                first, spec.on_device("routing_indices", level - 1, "cpu")))


def test_indices_made_in_inference_mode_serve_autograd():
    """An index tensor first uploaded under inference mode (synthesis) is
    a normal tensor, which a later training step saves for backward."""
    spec = tsk.SkeletonSpec(name="t", bones=tsk.TED_GESTURE.bones,
                            levels=tsk.TED_GESTURE.levels)
    with torch.inference_mode():
        spec.extract_level_target(torch.zeros(1, 2, spec.pose_dim), 1)
    x = torch.randn(1, 2, spec.pose_dim, requires_grad=True)
    spec.extract_level_target(x, 1).sum().backward()
    assert x.grad.sum() == spec.level_dim(1) * 2
