"""The PyTorch port stands alone: no port module, and not chip_smoke.py,
imports jax or any module of the JAX package, and the device policy
refuses the card where there is none."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from predictionio_tpu_torch import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    def blocked(name):
        return (name == "jax" or name.startswith(("jax.", "jaxlib"))
                or name == "predictionio_tpu"
                or name.startswith("predictionio_tpu."))

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import predictionio_tpu_torch as pkg
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)
        names.append(info.name)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the slice was walked, not an empty package
    assert int(proc.stdout.strip().splitlines()[-1]) >= 25


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve("cuda")
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve()      # the default is the card


def test_cpu_is_asked_for_explicitly(monkeypatch):
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    assert device.resolve("cpu") == torch.device("cpu")
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    assert device.resolve() == torch.device("cpu")
    # an explicit argument wins over the environment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device.resolve("cuda")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
