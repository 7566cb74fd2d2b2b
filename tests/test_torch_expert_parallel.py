"""Expert parallelism of the port's MoE block (``models/moe.py``) on two
gloo ranks of the CPU, vs the single-process port and the JAX package.

One spawn (``repro_torch.launch.mesh.run_ranks``, rank body
``test_torch_mesh_ranks.expert_parallel``; 60 s collective timeout, 120
s wall) runs a reduced mixtral with four experts over a (data=1,
model=2) mesh, two experts a rank (``sharding.rules.expert_slice``):

  * ``moe_apply`` on both ranks equals the single-process port's and
    ``repro.models.moe.moe_apply``'s within 1e-6, with and without
    ``moe_all_to_all`` (a knob that changes no computation: also held
    against the reference with the flag set, in one process);
  * the logits of a two-layer forward equal the single-process ones;
  * one ``make_train_step`` step (SGD, lr 1, the gradient read back as
    the update): the loss equals the single-process step's, and the
    gradients — the two ranks' expert slices put together, every other
    leaf on each rank — equal its gradients within 2e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import test_torch_mesh_ranks as R  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jM  # noqa: E402
from repro.sharding.ctx import ShardCtx as JShardCtx  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import CPU_CTX, ShardCtx  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

WORLD = 2
VAL_TOL = 1e-6
GRAD_TOL = 2e-5
EXPERT_LEAVES = ("wg", "wu", "wd")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(R.expert_parallel, WORLD,
                     rdv_dir=str(tmp_path_factory.mktemp("rdv")),
                     timeout_s=60, wall_s=120, threads=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single():
    """The single-process port on the same parameters and inputs."""
    cfg = R.moe_cfg()
    params, batch, x = R.moe_inputs(cfg)
    layer0 = tu.tree_map(lambda t: t[0].clone(),
                         params["units"]["b0"]["moe"])
    with torch.no_grad():
        y = M.moe_apply(layer0, cfg, x).numpy()
        logits = T.forward(params, cfg, batch["tokens"]).numpy()
    loss, grads = R.sgd_grads(params, cfg, batch, CPU_CTX)
    return {"cfg": cfg, "layer0": layer0, "x": x, "moe": y,
            "logits": logits, "loss": loss, "grads": grads}


def _jax_moe(single, ctx):
    tc = single["cfg"]
    jcfg = jreduced(jget_config(R.MOE_ARCH), n_units=2, d_model=32)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_experts=tc.moe.n_experts, top_k=tc.moe.top_k))
    jp = {k: jnp.asarray(v.numpy()) for k, v in single["layer0"].items()}
    return np.asarray(jM.moe_apply(jp, jcfg, jnp.asarray(single["x"].numpy()),
                                   ctx))


def test_moe_apply_matches_single_process_and_jax(ranks, single):
    want = _jax_moe(single, JShardCtx())
    np.testing.assert_allclose(single["moe"], want, atol=VAL_TOL, rtol=0)
    for r in ranks:
        assert r["expert_rows"] == R.moe_cfg().moe.n_experts // WORLD
        for key in ("moe", "moe_a2a"):
            np.testing.assert_allclose(r[key], single["moe"], atol=VAL_TOL,
                                       rtol=0, err_msg=key)
            np.testing.assert_allclose(r[key], want, atol=VAL_TOL, rtol=0,
                                       err_msg=key)


def test_moe_all_to_all_matches_the_reference_flag(single):
    got = M.moe_apply(single["layer0"], single["cfg"], single["x"],
                      ShardCtx(moe_all_to_all=True))
    want = _jax_moe(single, JShardCtx(moe_all_to_all=True))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=VAL_TOL,
                               rtol=0)
    assert np.array_equal(got.detach().numpy(), single["moe"])


def test_forward_logits_match_single_process(ranks, single):
    scale = float(np.abs(single["logits"]).max())
    for r in ranks:
        np.testing.assert_allclose(r["logits"], single["logits"],
                                   atol=VAL_TOL * scale, rtol=0)


def test_train_step_loss_and_gradients(ranks, single):
    for r in ranks:
        assert abs(r["loss"] - single["loss"]) <= GRAD_TOL * abs(
            single["loss"])
    by_rank = sorted(ranks, key=lambda r: r["rank"])
    for path, want in single["grads"].items():
        if path.rsplit("/", 1)[-1] in EXPERT_LEAVES and "/moe/" in path:
            got = [np.concatenate([r["grads"][path] for r in by_rank],
                                  axis=-3)]
        else:
            got = [r["grads"][path] for r in by_rank]
        for g in got:
            np.testing.assert_allclose(g, want, atol=GRAD_TOL, rtol=0,
                                       err_msg=path)
