"""GAN training: the window drives the program's ``Trainer.train_epoch``
epoch after epoch, past the configuration's ``loss_warmup`` so the GAN
phase is on, at the configuration's batch, with the program's loader
running.  An epoch is ``steps_per_epoch`` steps over windowed samples made
from the seed (log-mel in dB, direction vectors about the mean, a word
every frames_per_word frames on average, speakers uniform).

Set-up builds the trainer once, loads the seeded weights, and runs one
epoch through the window's own call and feed; its first three steps
(rows that all differ) are recorded: each step's D and G losses, the
first step's gradient of every leaf as Adam holds it (exp_avg / (1 -
beta1)), and every leaf's change after the third step.  The float32
reference follows the same three steps from the same weights, rows and
noise (a generator seeded as the trainer's, drawn in the same order).
Numbers compared: the worst relative gap of a step's losses (the D loss,
the G loss and the G loss's contrastive terms, B2's output); the worst of
the generator side's per-group medians of the leaves' gaps of gradient
norms (groups: the audio encoder, the contrastive loss's text encoder,
each level's generator), so that a fault confined to one group's
gradients, such as B3's into the text encoder, shows, although the worst
single leaf swings with the bf16 noise of the audio encoder's small early
leaves (PERF.md); and the worst leaf's gap of change norms.  The
discriminator's gradient is not compared: its median leaf's gap swings
from seed to seed as far as the control's reaches (PERF.md); its loss and
its leaves' changes are.
Each gap is over the larger of the reference's norm of the leaf and the
median leaf's: of its group for a gradient (the text encoder's gradients
are small beside the generators'), of its optimiser for a change.
Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias under batch norm) move by round-off alone and are left out
of the change.

The control (``control``) and the planted faults (``FAULTS``) give the
same numbers with the reference in the program's place: in float8, or on
half of each batch's rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import harness
from reference.precision import FLOAT32, Precision, exact_float32
from reference.skeletons import SKELETONS
from reference.steps import optimizers, train_step

BETA1 = 0.5
STEPS = 3


class State:
    pass


class TimedLoader:
    """The program's loader, each ``next()`` timed (the benchmark's span
    around the loader)."""

    def __init__(self, inner, waits: list):
        self.inner, self.waits = inner, waits

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t)
            yield batch


def _samples(run, n, dev):
    """Windowed training samples on the host, drawn on the device."""
    from ha2g_torch.data.dataset import WindowedSamples
    cfg, tr = run.config, run.traffic
    T, D = cfg["n_poses"], 3 * SKELETONS[cfg["dataset"]].n_bones
    spec_len = int(round((T / cfg["motion_resampling_framerate"] * 16000 - 1024) / 512 + 1))
    g = torch.Generator(dev).manual_seed(harness.sub_seed(run.seed, 2))
    spec = -80.0 * torch.rand((n, 128, spec_len), generator=g, device=dev) ** 2
    target = 0.2 * torch.randn((n, T, D), generator=g, device=dev)
    has_word = torch.rand((n, T), generator=g, device=dev) < 1.0 / tr["frames_per_word"]
    words = torch.randint(4, cfg["n_words"], (n, T), generator=g, device=dev)
    text = torch.where(has_word, words, 0).to(torch.int32)
    vids = torch.randint(0, cfg["n_speakers"], (n,), generator=g, device=dev,
                         dtype=torch.int32)
    z = np.zeros((n, 1), np.float32)
    return WindowedSamples(
        text=text.cpu().numpy(), word_seq=z.astype(np.int32),
        word_lengths=np.zeros(n, np.int32), pose=z[:, :, None],
        target=target.cpu().numpy(), audio=z, spec=spec.cpu().numpy(),
        vids=vids.cpu().numpy())


def _leaf_norms(named: dict, fn) -> dict:
    keys = sorted(named)
    if not keys:
        return {}
    vals = torch.stack([fn(named[k]).float().norm() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def _adam_grads(opts, names: dict) -> dict:
    """Each leaf's first gradient as its Adam state holds it."""
    held = {names[id(p)]: st["exp_avg"] / (1.0 - BETA1)
            for opt in opts for p, st in opt.state.items()}
    return _leaf_norms(held, lambda t: t)


def _changes(params: dict, start: dict) -> dict:
    return _leaf_norms({k: p.detach() - start[k].to(p.device)
                        for k, p in params.items()}, lambda t: t)


def setup(run) -> State:
    from ha2g_torch.train.loop import Trainer

    cfg, tr, dev = run.config, run.traffic, run.device
    st = State()
    st.run = run
    phase = harness.Phases("set-up")
    st.B = cfg["batch_size"]
    st.K = tr["steps_per_epoch"]
    weights = harness.make_weights(harness.reference_model(cfg, dev),
                                   harness.sub_seed(run.seed, 1), dev)
    st.weights = {k: v.cpu() for k, v in weights.items()}
    phase("weights")
    st.samples = _samples(run, st.K * st.B, dev)
    phase("inputs")
    st.noise_seed = harness.sub_seed(run.seed, 5)
    lang, speaker = harness.vocabularies(cfg)
    st.trainer = Trainer(harness.program_config(cfg, random_seed=st.noise_seed),
                         st.samples, st.samples, lang, speaker, device=dev)
    system = st.trainer.system
    system.load_state_dict(weights, strict=True)
    del weights
    st.waits = []
    st.trainer.train_loader = TimedLoader(st.trainer.train_loader, st.waits)
    st.epoch = cfg["loss_warmup"] + 1
    phase("program")

    params = dict(system.named_parameters())
    names = {id(p): k for k, p in params.items()}
    orig = system.train_step
    st.rec = {"losses": []}

    def recorded(batch, gan_on, generator, rand_vids=None):
        m = orig(batch, gan_on, generator, rand_vids)
        i = len(st.rec["losses"])
        if i < STEPS:
            st.rec["losses"].append({k: v.detach().clone() for k, v in m.items()})
        if i == 0:
            st.rec["grads"] = _adam_grads((system.g_opt, system.d_opt), names)
        if i == STEPS - 1:
            st.rec["changes"] = _changes(params, st.weights)
        return m

    system.train_step = recorded
    try:
        st.trainer.train_epoch(st.epoch)
    finally:
        del system.train_step
    st.epoch += 1
    st.rec["losses"] = [_program_losses(m) for m in st.rec["losses"]]
    phase("first epoch")
    phase.done()
    st.waits.clear()
    st.steps = st.bad = 0
    return st


def _program_losses(m: dict) -> dict:
    """The D loss, the G loss (the sum of the G phase's weighted terms) and
    the contrastive terms (B2's losses) on their own."""
    vals = {k: float(v) for k, v in m.items()}
    out = {"g_total": sum(v for k, v in vals.items() if k != "dis")}
    out.update({k: vals[k] for k in ("dis", "c_pos", "c_neg") if k in vals})
    return out


def _epoch(st) -> None:
    means = st.trainer.train_epoch(st.epoch)
    st.epoch += 1
    st.steps += st.K
    if not all(np.isfinite(v) for v in means.values()):
        st.bad += st.K


def window(st, seconds: float) -> dict:
    t0 = t = time.perf_counter()
    unit_s = []
    while True:
        _epoch(st)
        now = time.perf_counter()
        unit_s.append(now - t)
        t = now
        if t - t0 >= seconds:
            break
    elapsed = t - t0
    st.rate = st.steps / elapsed
    st.loader_wait_ms = 1e3 * float(np.mean(st.waits))
    return {"train_samples_per_s": st.steps * st.B / elapsed,
            "attempted": st.steps, "failed": st.bad, "unit_s": unit_s}


def traced(st) -> int:
    """The traced segment: one more epoch."""
    bad = st.bad
    _epoch(st)
    st.bad = bad
    return st.K


def release(st) -> None:
    del st.trainer
    harness.release(st.run.device)


def work(st) -> dict:
    """The hand kernels' work in one step (see PERF.md): B1 forward and
    backward launches as (T, B, H, bytes an element, count), and B2 / B3-B4
    launches as (N, D, count)."""
    cfg = st.run.config
    L, n, T, H, B = (SKELETONS[cfg["dataset"]].n_levels, cfg["n_layers"],
                     cfg["n_poses"], cfg["hidden_size"], st.B)
    # generators: the D phase's, the G phase's and the diversity term's
    # cascades; discriminator: real, fake, generated (4 layers, H 64)
    fwd = [(T, B, H, 2, 3 * L * n), (T - 6, B, 64, 2, 3 * 4)]
    bwd = [(T, B, H, 2, L * n), (T - 6, B, 64, 2, 3 * 4)]
    return {"b1_fwd": fwd, "b1_bwd": bwd,
            "contrastive_fwd": [(B * T, 32, 2)],
            "contrastive_bwd": [(B * T, 32, 4)]}


def rows_of_step(st, i: int) -> np.ndarray:
    """The rows of step i (0-based) of the set-up epoch: the loader's first
    permutation (its default seed, 0)."""
    perm = np.random.default_rng(0).permutation(len(st.samples))
    return perm[i * st.B:(i + 1) * st.B]


def reference_steps(st, p: Precision = FLOAT32, rows_of=None,
                    count_flops: bool = False) -> dict:
    """The reference's three steps -> {"losses", "grads", "changes"} and,
    with ``count_flops``, the FLOPs of its first step."""
    run, dev = st.run, st.run.device
    model = harness.reference_model(run.config, dev, st.weights)
    g_opt, d_opt = optimizers(model, run.config)
    gen = torch.Generator(dev).manual_seed(st.noise_seed)
    params = dict(model.named_parameters())
    names = {id(q): k for k, q in params.items()}
    out = {"losses": [], "flops": None}
    s = st.samples
    for i in range(STEPS):
        rows = (rows_of or rows_of_step)(st, i)
        batch = {"text": torch.as_tensor(s.text[rows], device=dev).long(),
                 "spec": torch.as_tensor(s.spec[rows], device=dev),
                 "target": torch.as_tensor(s.target[rows], device=dev),
                 "vids": torch.as_tensor(s.vids[rows], device=dev).long()}
        with exact_float32():
            if count_flops and i == 0:
                with harness.flop_counter() as fc:
                    out["losses"].append(train_step(model, g_opt, d_opt, batch,
                                                    True, gen, p))
                out["flops"] = fc.get_total_flops()
            else:
                out["losses"].append(train_step(model, g_opt, d_opt, batch,
                                                True, gen, p))
        if i == 0:
            out["grads"] = _adam_grads((g_opt, d_opt), names)
    out["changes"] = _changes(params, st.weights)
    del model, g_opt, d_opt
    harness.release(dev)
    return out


def group(leaf: str) -> str:
    """A leaf's group: its top-level module, or a level's generator."""
    parts = leaf.split(".")
    return ".".join(parts[:2]) if parts[0] == "gens" else parts[0]


def _groups(keys) -> dict:
    out = {}
    for k in keys:
        out.setdefault(group(k), []).append(k)
    return out


def leaf_gaps(got: dict, want: dict) -> dict:
    """Per leaf: its gradient-norm gap, over the larger of the reference's
    norm and the median leaf's of its group; and (where the reference moves
    it) its change-norm gap, over the larger of the reference's norm and
    the median leaf's of its optimiser (the discriminator's, or the
    rest)."""
    grads, changes = {}, {}
    for keys in _groups(want["grads"]).values():
        med = float(np.median([want["grads"][k] for k in keys]))
        for k in keys:
            grads[k] = harness.rel_gap(got["grads"].get(k, 0.0), want["grads"][k], med)
    for opt in ("dis", "gen"):
        keys = [k for k in want["grads"] if k.startswith("dis.") == (opt == "dis")]
        med_g = float(np.median([want["grads"][k] for k in keys]))
        moved = [k for k in keys if want["grads"][k] >= 1e-3 * med_g]
        med_c = float(np.median([want["changes"][k] for k in moved]))
        for k in moved:
            changes[k] = harness.rel_gap(got["changes"][k], want["changes"][k], med_c)
    return {"grads": grads, "changes": changes}


def _group_medians(gaps: dict) -> dict:
    return {g: float(np.median([gaps["grads"][k] for k in keys]))
            for g, keys in _groups(gaps["grads"]).items()}


def compare(got: dict, want: dict) -> dict:
    """The numbers between two records of three steps."""
    gaps = leaf_gaps(got, want)
    by_group = _group_medians(gaps)
    return {"loss_gap": max(harness.rel_gap(g[k], w[k], 1e-6)
                            for g, w in zip(got["losses"], want["losses"]) for k in w),
            "grad_gap_gen": max(v for g, v in by_group.items() if g != "dis"),
            "change_gap": max(gaps["changes"].values())}


def detail(got: dict, want: dict) -> dict:
    """For calibration: each loss's worst gap, each group's median
    gradient gap and the five worst leaves of each kind."""
    gaps = leaf_gaps(got, want)
    out = {"loss_gap_by_term": {k: max(harness.rel_gap(g[k], w[k], 1e-6)
                                       for g, w in zip(got["losses"], want["losses"]))
                                for k in want["losses"][0]},
           "grad_gap_by_group": _group_medians(gaps)}
    for kind, by in gaps.items():
        out[f"{kind}_worst"] = [[k, v] for k, v in
                                sorted(by.items(), key=lambda kv: -kv[1])[:5]]
    return out


def _want(st) -> dict:
    if getattr(st, "want", None) is None:
        st.want = reference_steps(st)
    return st.want


def control(st, p: Precision) -> dict:
    """The numbers with the reference in ``p`` in the program's place."""
    rec = reference_steps(st, p)
    return {**compare(rec, _want(st)), **detail(rec, _want(st))}


def _half_batch(st) -> dict:
    half = lambda s, i: rows_of_step(s, i)[:s.B // 2]  # noqa: E731
    rec = reference_steps(st, rows_of=half)
    return {**compare(rec, _want(st)), **detail(rec, _want(st))}


# faults planted in the reference put in the program's place
FAULTS = {"half_batch": _half_batch}


def check(st, count_flops: bool = False) -> dict:
    want = reference_steps(st, count_flops=count_flops)
    st.want = want
    numbers = {**compare(st.rec, want), "bad_units": float(st.bad)}
    return {"numbers": numbers, "flops_per_unit": want["flops"],
            "detail": detail(st.rec, want)}
