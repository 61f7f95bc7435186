"""``make-librosa-goldens`` in the port: the fixture signals bit for bit
the JAX package's, and the command failing without librosa as the JAX
package's does (neither machine has librosa)."""

import importlib.util

import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch import cli
from ha2g_torch.tools import librosa_golden_signals


def test_golden_signals_equal_jax():
    from ha2g_tpu.tools import librosa_golden_signals as jax_signals
    got, want = librosa_golden_signals(), jax_signals()
    assert list(got) == list(want) == ["clicks", "chirp", "noise",
                                       "am_noise", "bursts"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (64000,)
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.skipif(importlib.util.find_spec("librosa") is not None,
                    reason="librosa is installed: the command would run")
def test_command_fails_without_librosa(tmp_path):
    from ha2g_tpu.cli import cmd_make_librosa_goldens
    out = tmp_path / "fixtures" / "goldens.npz"
    with pytest.raises(ModuleNotFoundError, match="librosa"):
        cmd_make_librosa_goldens([str(out)])
    with pytest.raises(ModuleNotFoundError, match="librosa"):
        cli.main(["make-librosa-goldens", str(out)])
    assert not out.exists()
