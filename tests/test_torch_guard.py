"""Guards of the port's contract:

  * importing every ``repro_torch`` module pulls in neither ``jax`` nor
    the JAX package ``repro``;
  * entry points default to CUDA and raise without a card — they never
    carry on on the CPU unless asked (``device="cpu"``);
  * ``use_kernel=True`` on CPU tensors raises (the kernels are CUDA C++);
  * what is not ported yet raises ``NotImplementedError``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.vgg_family import VGGConfig  # noqa: E402
from repro_torch.core import VGGFamily  # noqa: E402
from repro_torch.data import ClientSampler  # noqa: E402
from repro_torch.fl import FLRunConfig, Simulator, UnifiedEngine  # noqa: E402
from repro_torch.fl.strategy import make_strategy  # noqa: E402
from repro_torch.kernels.fedavg import fedavg as fk  # noqa: E402
from repro_torch.kernels.fedavg import ops  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CFGS = [VGGConfig(name="a", stages=((4,), (4,)), classifier=(8,),
                  n_classes=3, image_size=8),
        VGGConfig(name="b", stages=((4, 4), (4,)), classifier=(8,),
                  n_classes=3, image_size=8)]


def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(len(names), bad)
        assert len(names) >= 20 and not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    """Present a machine with no card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLRunConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UnifiedEngine(VGGFamily(), CFGS, [1, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.PlaneAccumulator(10)
    with pytest.raises(RuntimeError, match="CUDA"):
        FLRunConfig(device="cuda")
    strategy = make_strategy("fedadp", VGGFamily(), CFGS, [1, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        strategy.init_state(torch.Generator())
    # asked for the CPU, they run there
    assert FLRunConfig(device="cpu").device == "cpu"
    eng = UnifiedEngine(VGGFamily(), CFGS, [1, 1], device="cpu")
    assert eng.device.type == "cpu"
    assert ops.PlaneAccumulator(10, device="cpu").device.type == "cpu"


def test_simulator_without_device_raises(no_cuda):
    sim_cfg = FLRunConfig(device="cpu", rounds=1)
    sim_cfg.device = None           # as if built where a card was present
    data = {"x": np.zeros((8, 8, 8, 3), np.float32),
            "y": np.zeros(8, np.int32)}
    samplers = [ClientSampler(data, np.arange(4) + 4 * i, batch_size=2)
                for i in range(2)]
    sim = Simulator(VGGFamily(), CFGS, samplers, sim_cfg, data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.run()


def test_use_kernel_true_on_cpu_tensors_raises():
    x = torch.randn(3, 130)
    w = torch.rand(3)
    z = torch.zeros(130)
    with pytest.raises(ValueError, match="CUDA"):
        ops.plane_agg(x, w, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.plane_accum(z, z, z, x, w, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.plane_finish(z, z, z, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.PlaneAccumulator(130, use_kernel=True, device="cpu")
    # the kernel wrappers refuse CPU tensors themselves
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.weighted_sum_2d(torch.zeros(2, 128), torch.ones(2))
    # and use_kernel=False is the plain version, same numbers as None
    assert torch.equal(ops.plane_agg(x, w, use_kernel=False),
                       ops.plane_agg(x, w))


def test_launch_counts_and_build_paths():
    fk.reset_launch_counts()
    assert fk.launch_counts() == dict.fromkeys(fk.KERNELS, 0)
    # CPU dispatch never touches the kernels
    ops.plane_agg(torch.randn(2, 256), torch.rand(2))
    assert sum(fk.launch_counts().values()) == 0
    path = fk.library_path()
    assert path.parent == fk.BUILD_DIR and path.name.endswith(".so")
    assert "sm_90a" in " ".join(fk.NVCC_FLAGS)


def test_not_ported_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FLRunConfig(device="cpu", engine="loop")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FLRunConfig(device="cpu", method="clustered")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FLRunConfig(device="cpu", wire="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FLRunConfig(device="cpu", compute_dtype="bf16")
    with pytest.raises(ValueError):
        FLRunConfig(device="cpu", agg_layout="leaf")
    for kw in (dict(mesh=object()), dict(wire="bf16"),
               dict(method="flexifed"), dict(attn_backend="flash")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            UnifiedEngine(VGGFamily(), CFGS, [1, 1], device="cpu", **kw)
    acc = ops.PlaneAccumulator(10, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        acc.update_q(None, None, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_strategy("standalone", VGGFamily(), CFGS, [1, 1])
