"""The port stands alone: no module of ha2g_torch, and not chip_smoke.py,
imports JAX, flax, msgpack, the JAX package, or what the card's machine
lacks (pyarrow, lmdb, fasttext, PyYAML, matplotlib, Pillow, scikit-learn)
(checked with ast, without importing); librosa only inside
``tools.make_librosa_goldens``; the command line has every command of the
JAX package's; and its entry points (the systems, the evaluator, the
trainer, the serving service, the command line) need CUDA unless the
caller asks for the CPU; the host-only commands need no device."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import tests.torch_cpu  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "ha2g_tpu",
             "pyarrow", "lmdb", "fasttext", "yaml", "matplotlib", "PIL",
             "sklearn"}
# the one import outside these sets that a port module may make, and
# where: (file, function) -> module; the goldens must come from librosa
FUNCTION_IMPORTS = {("tools.py", "make_librosa_goldens"): "librosa"}
# what the port may import at module level besides the standard library
# and itself
ALLOWED_THIRD_PARTY = {"torch", "numpy", "einops"}


# the modules of the serving, training, evaluation, trainer,
# checkpoint-bridge and data-path slices, which the scan must see
PORT_MODULES = ("config.py", "convert.py", "kernels.py", "skeleton.py",
                "synthesis.py", "models/common.py", "models/hierarchy.py",
                "models/resnet_se.py", "models/tcn.py", "ops/contrastive.py",
                "ops/gru.py", "ops/gru_kernel.py", "ops/mel.py",
                "train/cascade.py", "train/hierarchy.py", "train/losses.py",
                "checkpoint.py", "cli.py", "models/embedding_net.py",
                "models/motion_ae.py", "eval/fgd.py", "eval/metrics.py",
                "data/dataset.py", "data/loader.py", "data/storage.py",
                "data/synthetic.py", "data/vocab.py", "train/loop.py",
                "utils/average_meter.py", "utils/msgpack.py",
                "reference_ckpt.py", "serve.py", "tts_align.py",
                "data/lmdb_mini.py", "data/arrow_legacy.py",
                "data/lmdb_import.py", "data/fasttext_bin.py", "data/h36m.py",
                "tools.py", "eval/trajectory.py", "render.py",
                "utils/image.py", "native/__init__.py",
                "dataset_pipeline/__init__.py",
                "dataset_pipeline/filtering.py",
                "dataset_pipeline/assemble.py", "dataset_pipeline/runners.py",
                "dataset_pipeline/pipeline.py", "dataset_pipeline/report.py")


def _port_files():
    files = sorted((ROOT / "ha2g_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert all(f.exists() for f in files)
    assert {ROOT / "ha2g_torch" / m for m in PORT_MODULES} <= set(files)
    return files


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        bad = {name for _, name in _imports(tree) if name in FORBIDDEN}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_librosa_only_inside_make_librosa_goldens():
    """librosa (on neither machine) is imported in one function only, and
    nothing else outside the standard library, torch, numpy, einops and
    the port is imported inside a port function, but scipy (on both
    machines) and the optional packages the JAX package also gates:
    scenedetect and umap (tensorboard's writer comes from torch)."""
    import sys
    optional = {"scipy", "scenedetect", "umap"}
    stdlib = set(sys.stdlib_module_names)
    found = {}
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for _, name in _imports(fn):
                if (name in stdlib or name in ALLOWED_THIRD_PARTY
                        or name in optional or name == "ha2g_torch"):
                    continue
                key = (str(path.relative_to(ROOT / "ha2g_torch"))
                       if path.name != "chip_smoke.py" else path.name,
                       fn.name)
                found[key] = name
    assert found == FUNCTION_IMPORTS


def test_module_level_imports_are_torch_numpy_einops_stdlib():
    import sys
    stdlib = set(sys.stdlib_module_names)
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            for _, name in _imports(ast.Module(body=[node], type_ignores=[])):
                assert (name in stdlib or name in ALLOWED_THIRD_PARTY
                        or name == "ha2g_torch" or name == "__future__"), \
                    f"{path.relative_to(ROOT)} imports {name} at module level"


def test_entry_points_need_cuda_or_an_explicit_cpu():
    from ha2g_torch.config import Config
    from ha2g_torch.device import resolve_device
    from ha2g_torch.train.hierarchy import HierarchySystem

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA path is for CPU "
                    "machines")
    cfg = Config(hidden_size=8, n_layers=1, z_type="speaker")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HierarchySystem(cfg, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert HierarchySystem(cfg, 8, 2, device="cpu").device.type == "cpu"

    # the evaluator, the trainer and the command line
    from ha2g_torch import cli
    from ha2g_torch.data.dataset import WindowedSamples
    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.eval.fgd import EmbeddingSpaceEvaluator, make_embedder
    from ha2g_torch.train.loop import Trainer

    sd = make_embedder(27).state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingSpaceEvaluator(27, 34, sd)
    assert EmbeddingSpaceEvaluator(27, 34, sd, device="cpu").device.type == \
        "cpu"
    z = np.zeros
    samples = WindowedSamples(
        text=z((2, 34), np.int32), word_seq=z((2, 2), np.int32),
        word_lengths=z(2, np.int32), pose=z((2, 34, 30), np.float32),
        target=z((2, 34, 27), np.float32), audio=z((2, 8), np.float32),
        spec=z((2, 128, 70), np.float32), vids=z(2, np.int32))
    lang, speaker = Vocab("words"), Vocab("vid", insert_default_tokens=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg.replace(batch_size=2), samples, samples, lang, speaker)
    assert Trainer(cfg.replace(batch_size=2), samples, samples, lang, speaker,
                   device="cpu").system.device.type == "cpu"
    for argv in (["train", "--config", str(ROOT / "configs" /
                                          "hierarchy.yaml")],
                 ["eval", "checkpoint"], ["synthesize", "checkpoint"],
                 ["from-text", "checkpoint", "--text", "hi", "--wav",
                  "a.wav"], ["serve", "checkpoint"],
                 ["import-checkpoint", "a.bin", "out"],
                 ["export-checkpoint", "checkpoint", "a.bin"],
                 ["import-evalnet", "a.bin", "out"], ["doctor"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(argv)
    # the host-only commands touch no device: a missing input raises as
    # such, not for the device
    for argv in (["import-lmdb", "missing", "out"],
                 ["motion-stats", "missing"],
                 ["compare-trajectory", "missing.jsonl"],
                 ["build-dataset", "--video-ids", "missing.txt", "--work",
                  "w", "--out", "o"]):
        with pytest.raises(FileNotFoundError):
            cli.main(argv)

    from ha2g_torch.serve import GestureService
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GestureService("checkpoint")


def test_cli_has_every_command_of_the_jax_cli(capsys):
    """Every command of the JAX command line (its ``cmds`` table in
    ``main``, read with ast) is one of the port's, and the usage line
    lists them."""
    from ha2g_torch import cli
    tree = ast.parse((ROOT / "ha2g_tpu" / "cli.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    table = next(n.value for n in ast.walk(main)
                 if isinstance(n, ast.Assign) and n.targets[0].id == "cmds")
    jax_commands = {k.value for k in table.keys}
    assert len(jax_commands) == 17
    assert jax_commands <= set(cli.COMMANDS)
    assert cli.main([]) == 1
    usage = capsys.readouterr().err
    assert all(c in usage for c in jax_commands)
