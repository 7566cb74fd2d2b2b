"""The standalone trainer's pieces in the port vs the JAX package, on the
CPU: ``optim.adamw`` (f32 master copies of low-precision leaves),
``optim.schedules``, ``data.LMPipeline``, ``launch.steps.make_train_step``
and ``launch.train.run``.

  * ``adamw``: one and five updates from the same parameters and
    gradients (numpy seeds) at 1e-6, f32 leaves and bf16 leaves with
    their f32 masters (``tests/test_substrates.py``'s bf16 case), with and
    without weight decay; the f32 arithmetic is the same, in another
    order of a few operations;
  * ``constant`` and ``cosine_with_warmup``: equal at 1e-7 over 0..N (the
    reference computes in f32, the port in Python floats);
  * ``LMPipeline``: batches byte-identical to the reference's;
  * ``launch.train.run`` on reduced glm4-9b and gemma-7b, 5 steps, from
    the reference's own initial parameters (carried across through
    numpy): the loss history within 1e-4 of the reference's ``run``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import LMPipeline as JPipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import cosine_with_warmup as jcosine  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.data import LMPipeline as TPipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import constant as tconstant  # noqa: E402
from repro_torch.optim import cosine_with_warmup as tcosine  # noqa: E402

OPT_TOL = 1e-6      # the optimizer's f32 arithmetic
SCHED_TOL = 1e-7    # a schedule's value
LOSS_TOL = 1e-4     # a trained loss history


def _leaves(seed, dtype):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("n_steps", [1, 5])
def test_adamw_matches_jax(dtype, wd, n_steps):
    sched = jcosine(1e-2, 2, 10)
    p0 = _leaves(0, dtype)
    grads = [_leaves(s + 1, dtype) for s in range(n_steps)]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p0)
    jopt = jadamw(sched, weight_decay=wd)
    jstate = jopt.init(jp)
    tp = tu.tree_map(lambda x: torch.from_numpy(x).to(tdt), p0)
    topt = tadamw(tcosine(1e-2, 2, 10), weight_decay=wd)
    tstate = topt.init(tp)
    assert all(m.dtype == torch.float32
               for m in tu.leaves(tstate["master"]))
    for step, g in enumerate(grads):
        jp, jstate = jopt.update(jax.tree.map(lambda x: jnp.asarray(x, jdt),
                                              g), jstate, jp, step)
        tp, tstate = topt.update(
            tu.tree_map(lambda x: torch.from_numpy(x).to(tdt), g), tstate,
            tp, step)
    for key in ("m", "v", "master"):
        for a, b in zip(jax.tree.leaves(jstate[key]), tu.leaves(tstate[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=OPT_TOL, rtol=OPT_TOL,
                                       err_msg=key)
    for a, b in zip(jax.tree.leaves(jp), tu.leaves(tp)):
        assert b.dtype == tdt
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=OPT_TOL,
                                   rtol=OPT_TOL)


def test_adamw_without_master():
    p0, g = _leaves(0, "float32"), _leaves(1, "float32")
    jp = jax.tree.map(jnp.asarray, p0)
    jopt = jadamw(1e-2, master_fp32=False)
    jp, _ = jopt.update(jax.tree.map(jnp.asarray, g), jopt.init(jp), jp, 0)
    tp = tu.tree_map(torch.from_numpy, p0)
    topt = tadamw(1e-2, master_fp32=False)
    state = topt.init(tp)
    assert "master" not in state
    tp, _ = topt.update(tu.tree_map(torch.from_numpy, g), state, tp, 0)
    for a, b in zip(jax.tree.leaves(jp), tu.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=OPT_TOL,
                                   rtol=OPT_TOL)


@pytest.mark.parametrize("args", [(3e-4, 10, 100), (1.0, 0, 7),
                                  (2e-2, 5, 5), (1e-3, 3, 40, 1e-4)])
def test_schedules_match_jax(args):
    js, ts = jcosine(*args), tcosine(*args)
    for step in range(0, args[2] + 6):
        assert abs(ts(step) - float(js(step))) <= SCHED_TOL, step
    jc, tc = jconstant(args[0]), tconstant(args[0])
    assert all(abs(tc(s) - float(jc(s))) <= SCHED_TOL for s in range(5))


def test_lm_pipeline_is_byte_identical():
    jp, tp = JPipeline(512, 4, 33, seed=3), TPipeline(512, 4, 33, seed=3)
    for _ in range(3):
        a, b = next(jp), next(tp)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    assert {k: v.tobytes() for k, v in jp.host_slice(a, 1, 2).items()} == \
        {k: v.tobytes() for k, v in tp.host_slice(b, 1, 2).items()}


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma-7b"])
def test_train_run_matches_jax(arch, capsys):
    kw = dict(steps=5, batch=2, seq=32, lr=3e-4, log_every=5, seed=0)
    jres = jtrain.run(arch, **kw)
    # the reference's run initialises from PRNGKey(seed); the port starts
    # from those parameters
    cfg = jreduced(jget_config(arch))
    p0 = jax.tree.map(np.asarray,
                      jT.init_params(jax.random.PRNGKey(0), cfg))
    tres = ttrain.run(arch, device="cpu", params=p0, **kw)
    assert len(tres["losses"]) == 5
    np.testing.assert_allclose(tres["losses"], jres["losses"], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert tres["losses"][-1] < tres["losses"][0]
    assert "params=" in capsys.readouterr().out


def test_train_cli_on_cpu(monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch glm4-9b --reduced
    --device cpu --steps 5`` (a short batch and sequence here)."""
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "glm4-9b", "--reduced", "--device", "cpu",
        "--steps", "5", "--batch", "2", "--seq", "16"])
    ttrain.main()
    out = capsys.readouterr().out
    assert "arch=glm4-9b-smoke" in out and "device=cpu" in out
    assert "loss " in out.splitlines()[-1]
