"""Guards of the port's contract:

  * importing every ``repro_torch`` module pulls in neither ``jax`` nor
    the JAX package ``repro``;
  * entry points default to CUDA and raise without a card — they never
    carry on on the CPU unless asked (``device="cpu"``);
  * ``use_kernel=True`` on CPU tensors raises (the kernels are CUDA C++);
  * the attention backend "auto" takes the plain blockwise path on CPU
    tensors and never a kernel; a forced backend needs a transformer
    family and the unified engine;
  * what is not ported yet raises ``NotImplementedError``; the loop
    path and the three baselines, ported since, construct.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import dataclasses  # noqa: E402

from repro_torch.configs import (EncoderConfig, FrontendConfig,  # noqa: E402
                                 SSMConfig, get_config, reduced)
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs.vgg_family import VGGConfig  # noqa: E402
from repro_torch.core import TransformerFamily, VGGFamily, tfamily  # noqa: E402
from repro_torch.data import ClientSampler  # noqa: E402
from repro_torch.fl import FLRunConfig, Simulator, UnifiedEngine  # noqa: E402
from repro_torch.fl.strategy import make_strategy  # noqa: E402
from repro_torch.kernels.fedavg import fedavg as fk  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.fedavg import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash as ff  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.netchange import ops as wops  # noqa: E402
from repro_torch.kernels.netchange import widen as wk  # noqa: E402
from repro_torch.kernels.swa_attention import ops as sops  # noqa: E402
from repro_torch.kernels.swa_attention import swa as sk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import lm_loss  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.sharding.ctx import ShardCtx  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TCFG = reduced(get_config("glm4-9b"), n_units=1, d_model=32)
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
        # the slices' modules are among those imported
        assert {"repro_torch.core.quant", "repro_torch.checkpoint",
                "repro_torch.checkpoint.store",
                "repro_torch.kernels.swa_attention.swa",
                "repro_torch.kernels.swa_attention.ops",
                "repro_torch.kernels.netchange.widen",
                "repro_torch.kernels.netchange.ops",
                "repro_torch.launch.serve", "repro_torch.core.baselines",
                "repro_torch.core.fedadp", "repro_torch.fl.backends",
                "repro_torch.fl.strategy", "repro_torch.fl.unified",
                "repro_torch.models.ssm",
                "repro_torch.configs.recurrentgemma_9b",
                "repro_torch.configs.xlstm_125m"
                } <= set(names), names
        # and importing them loaded no kernel library
        from repro_torch.kernels import build
        assert not build._libs, build._libs
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
    xq = torch.zeros(3, 130, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.plane_accum_q(z, z, z, xq, torch.ones(3, 2), w, tile=128,
                          use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.weighted_sum(x, w, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.weighted_sum_masked(x, w, torch.ones_like(x), use_kernel=True)
    for fn, args in ((fk.plane_accum_q_2d, (z[None], z[None], z[None], xq,
                                            torch.ones(3, 2), w)),
                     (fk.weighted_sum_masked_2d, (x, w, x)),
                     (fk.weighted_sum_masked_mult_2d, (x, w, x, x))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
    q = torch.randn(1, 8, 1, 2, 16)
    kv = torch.randn(1, 8, 1, 16)
    pos = torch.arange(8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv, pos, pos, use_kernel=True)
    # the kernel wrappers refuse CPU tensors themselves
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.weighted_sum_2d(torch.zeros(2, 128), torch.ones(2))
    qk = q.permute(0, 2, 3, 1, 4).contiguous()
    pos32 = pos.int()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ff.flash_fwd(qk, kv, kv, pos32, pos32)
    # the serving and To-Wider entry points
    qd = torch.randn(1, 4, 16)
    kc = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        sops.decode_attention(qd, kc, kc, pos, 7, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        sops.swa_prefill(q, kv, kv, window=4, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        wops.widen_cols(x, [0, 1, 2, 2], use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.swa_decode(qd.reshape(1, 2, 2, 16), kc, kc, pos32, 7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.swa_prefill(q.reshape(1, 1, 2, 8, 16), kv, kv, window=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wk.widen_2d(x, torch.zeros(4, dtype=torch.int32))
    # causal=False with a window is refused on every path (the JAX
    # kernel and oracle disagree there)
    for uk in (None, False):
        with pytest.raises(ValueError, match="not defined"):
            sops.swa_prefill(q.reshape(1, 1, 2, 8, 16), kv, kv, window=4,
                             causal=False, use_kernel=uk)
    # and use_kernel=False is the plain version, same numbers as None
    assert torch.equal(ops.plane_agg(x, w, use_kernel=False),
                       ops.plane_agg(x, w))
    assert torch.equal(sops.decode_attention(qd, kc, kc, pos, 7,
                                             use_kernel=False),
                       sops.decode_attention(qd, kc, kc, pos, 7))


def test_launch_counts_and_build_paths():
    mods = (fk, ff, sk, wk)
    for m in mods:
        m.reset_launch_counts()
        assert m.launch_counts() == dict.fromkeys(m.KERNELS, 0)
    # CPU dispatch never touches the kernels
    ops.plane_agg(torch.randn(2, 256), torch.rand(2))
    q = torch.randn(1, 8, 1, 2, 16)
    kv = torch.randn(1, 8, 1, 16)
    pos = torch.arange(8)
    flash_attention(q, kv, kv, pos, pos)
    sops.decode_attention(torch.randn(1, 4, 16), kv, kv, pos, 5)
    sops.swa_prefill(q.reshape(1, 1, 2, 8, 16), kv, kv, window=4)
    wops.widen_cols(torch.randn(3, 4), [0, 1, 2, 3, 1])
    attn.decode_attention(torch.randn(1, 4, 16), kv, kv, pos, 5)
    for m in mods:
        assert sum(m.launch_counts().values()) == 0, m.__name__
    for name in ("fedavg", "flash_attention", "swa_attention", "netchange"):
        path = kbuild.library_path(name)
        assert path.parent == kbuild.BUILD_DIR and path.name.endswith(".so")
        assert kbuild.source(name).exists()
    assert "sm_90a" in " ".join(kbuild.NVCC_FLAGS)


def test_serve_defaults_to_cuda_and_raises_without(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run("glm4-9b", gen=1)


def test_not_ported_raise():
    # the loop and the three baselines are ported: they construct
    assert FLRunConfig(device="cpu", engine="loop").engine == "loop"
    for method in ("clustered", "flexifed", "standalone"):
        assert FLRunConfig(device="cpu", method=method).method == method
        eng = UnifiedEngine(VGGFamily(), CFGS, [1, 1], device="cpu",
                            method=method)
        assert eng.method == method
        strategy = make_strategy(method, VGGFamily(), CFGS, [1, 1],
                                 device="cpu")
        assert strategy.kind == "per_client"
    # the bf16 compute policy is ported on the unified engine; the loop
    # refuses it, as the reference's does
    assert FLRunConfig(device="cpu", compute_dtype="bf16").compute_dtype \
        == "bf16"
    with pytest.raises(ValueError, match="loop"):
        FLRunConfig(device="cpu", compute_dtype="bf16", engine="loop")
    with pytest.raises(ValueError):
        FLRunConfig(device="cpu", agg_layout="leaf")
    # a mesh is a DeviceMesh (the client mesh is ported:
    # tests/test_torch_mesh.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        UnifiedEngine(VGGFamily(), CFGS, [1, 1], device="cpu",
                      mesh=object())
    # the attention backend is ported: a VGG cohort has no attention
    with pytest.raises(ValueError, match="attn_backend"):
        UnifiedEngine(VGGFamily(), CFGS, [1, 1], device="cpu",
                      attn_backend="flash")
    # the recurrent blocks are ported (tests/test_torch_ssm*.py), and so
    # are the whisper encoder and the vision front end
    # (tests/test_torch_frontend*.py): they build, prefill, decode and
    # form a union; so are layer rematerialisation ("full" and "dots")
    # and the expert-parallel MoE (tests/test_torch_remat.py,
    # test_torch_remat_dots.py, test_torch_expert_parallel.py)
    rnn = dataclasses.replace(TCFG, layer_pattern=("rglru", "global"),
                              ssm=SSMConfig(d_rnn=32))
    assert tfamily.make_variant(rnn, d_rnn=16).d_rnn == 16
    enc = dataclasses.replace(TCFG, layer_pattern=("crossdec",),
                              encoder=EncoderConfig(2, 16, 32),
                              frontend=FrontendConfig(kind="audio"))
    front = dataclasses.replace(TCFG, frontend=FrontendConfig(
        kind="vision", n_prefix=4))
    toks = torch.zeros(1, 4, dtype=torch.int32)
    for cfg, n_aux, npx in ((enc, 16, 0), (front, 4, 4)):
        shapes = TransformerFamily().shapes(cfg)
        assert ("encoder" in shapes) == (cfg is enc)
        params = tT.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        aux = torch.randn(1, n_aux, cfg.d_model)
        with torch.no_grad():
            logits, cache = tT.prefill(params, cfg, toks, aux=aux,
                                       cache_len=npx + 5)
            logits, _ = tT.decode_step(params, cfg, toks[:, :1], cache,
                                       npx + 4)
        assert logits.shape == (1, cfg.vocab_size)
        assert [t.shape for t in tu.leaves(tT.init_cache(cfg, 1, npx + 5))] \
            == [t.shape for t in tu.leaves(cache)]
    assert tfamily.union([enc]).encoder == enc.encoder
    params = tT.init_params(torch.Generator().manual_seed(0), TCFG,
                            device="cpu")
    with torch.no_grad():
        assert torch.equal(tT.forward(params, TCFG, toks,
                                      ctx=ShardCtx(remat=True)),
                           tT.forward(params, TCFG, toks))
    # "dots" runs, and equals "full": the forward bit for bit, and one
    # step's gradients (the saved products are the ones "full" computes
    # again)
    dots = ShardCtx(remat=True, remat_policy="dots")
    with torch.no_grad():
        assert torch.equal(tT.forward(params, TCFG, toks, ctx=dots),
                           tT.forward(params, TCFG, toks))
    batch = {"tokens": toks, "labels": toks}
    g_full, g_dots = [torch.func.grad(lambda p, c=c: lm_loss(
        p, TCFG, batch, ctx=c)[0])(params)
        for c in (ShardCtx(remat=True), dots)]
    for a, b in zip(tu.leaves(g_dots), tu.leaves(g_full)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    moe = reduced(get_config("mixtral-8x7b"), n_units=1, d_model=32)
    mparams = tT.init_params(torch.Generator().manual_seed(0), moe,
                             device="cpu")
    with torch.no_grad():
        assert torch.equal(
            tT.forward(mparams, moe, toks, ctx=ShardCtx(moe_all_to_all=True)),
            tT.forward(mparams, moe, toks))
    with pytest.raises(ValueError, match="method"):
        make_strategy("fedprox", VGGFamily(), CFGS, [1, 1])


def test_attn_backend_auto_is_blockwise_on_cpu(monkeypatch):
    """On CPU tensors "auto" is the blockwise path (the flash entry is
    never reached), and a forced "flash" runs the plain versions."""
    called = []
    monkeypatch.setattr(attn, "blockwise_attention",
                        lambda *a, **k: called.append("blockwise") or "bw")
    q = torch.randn(1, 8, 1, 2, 16)
    kv = torch.randn(1, 8, 1, 16)
    pos = torch.arange(8)
    assert attn.attend(q, kv, kv, pos, pos, causal=True, window=0,
                       ctx=ShardCtx()) == "bw"
    assert called == ["blockwise"]
    ff.reset_launch_counts()
    out = attn.attend(q, kv, kv, pos, pos, causal=True, window=0,
                      ctx=ShardCtx(attn_backend="flash"))
    assert out.shape == (1, 8, 2, 16) and called == ["blockwise"]
    assert sum(ff.launch_counts().values()) == 0


def test_forced_attn_backend_validation():
    with pytest.raises(ValueError, match="attn_backend"):
        FLRunConfig(device="cpu", engine="loop", attn_backend="flash")
    with pytest.raises(ValueError, match="compute_dtype"):
        FLRunConfig(device="cpu", engine="loop", compute_dtype="bf16")
    with pytest.raises(ValueError):
        FLRunConfig(device="cpu", attn_backend="fused")
    for backend in ("flash", "blockwise"):
        assert FLRunConfig(device="cpu",
                           attn_backend=backend).attn_backend == backend
    data = {"x": np.zeros((8, 8, 8, 3), np.float32),
            "y": np.zeros(8, np.int32)}
    samplers = [ClientSampler(data, np.arange(4) + 4 * i, batch_size=2)
                for i in range(2)]
    cfg = FLRunConfig(device="cpu", rounds=1, engine="unified",
                      attn_backend="blockwise")
    with pytest.raises(ValueError, match="attn_backend"):
        Simulator(VGGFamily(), CFGS, samplers, cfg, data).run()
