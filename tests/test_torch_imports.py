"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor any module of the JAX package (``repro``), and its entry
points never fall back to the CPU when a card is asked for and missing."""
import os
import subprocess
import sys

import pytest
import torch
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, check=True)
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 17, out.stdout
    assert bad == "[]", out.stdout


def test_speculative_modules_are_in_the_probe():
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.runtime.sampling", "repro_torch.runtime.speculative",
            "repro_torch.kernels.fused_decode"} <= names


def test_ssm_modules_are_in_the_probe():
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
            "repro_torch.kernels.ops"} <= names


def test_flash_modules_are_in_the_probe():
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.kernels.flash_attention",
            "repro_torch.kernels.flash_decode"} <= names


def test_robustness_modules_are_in_the_probe():
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.runtime.fault_tolerance",
            "repro_torch.runtime.compression",
            "repro_torch.checkpoint.checkpointing"} <= names


def test_cuda_without_a_card_raises_instead_of_falling_back():
    from repro_torch.configs import smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(smoke_config("tinyllama-1.1b"))


def test_h100_is_the_default_hardware_spec():
    from repro_torch.core.neuroforge.hw import DEFAULT_HW, H100, V5E

    assert DEFAULT_HW is H100 and H100.peak_flops == 989e12
    assert H100.hbm_bw == 3.35e12 and H100.hbm_bytes == 80e9
    assert V5E.name == "tpu-v5e"


def test_configs_match_the_jax_package():
    from repro.configs import get_config as jget, list_archs as jlist
    from repro.configs import smoke_config as jsmoke
    from repro_torch.configs import get_config, list_archs, smoke_config

    assert list_archs() == jlist()
    for name in list_archs():
        for ours, theirs in ((get_config(name), jget(name)),
                             (smoke_config(name), jsmoke(name))):
            assert repr(ours) == repr(theirs)
            assert ours.param_counts() == theirs.param_counts()


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2",
                 "--tokens", "12", "--switch-every", "3", "--device", "cpu",
                 "--fused"]) == 0
    out = capsys.readouterr().out
    assert "recompiles_after_warmup=0" in out and "completed=" in out


def test_serve_cli_speculative_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2",
                 "--tokens", "16", "--device", "cpu", "--spec-k", "2",
                 "--temperature", "0.8", "--top-k", "5"]) == 0
    out = capsys.readouterr().out
    assert "recompiles_after_warmup=0" in out and "spec d3<-d1k2" in out
    assert main(["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2",
                 "--tokens", "12", "--device", "cpu", "--spec-tree",
                 "2x2"]) == 0
    out = capsys.readouterr().out
    assert "recompiles_after_warmup=0" in out and "spec d3<-d1t2x2" in out


def test_mesh_modules_are_in_the_probe():
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.parallel.sharding",
            "repro_torch.parallel.tensor_parallel",
            "repro_torch.parallel.pipeline_parallel",
            "repro_torch.launch.mesh"} <= names


def test_mesh_entry_points_refuse_a_missing_card():
    from repro_torch.launch.mesh import choose_backend, make_serve_mesh

    assert choose_backend(2, "cpu") == "gloo"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        choose_backend(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serve_mesh(1, 2, device="cuda")
