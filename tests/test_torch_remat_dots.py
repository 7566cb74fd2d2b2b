"""Layer rematerialisation under the "dots" policy
(``ShardCtx(remat=True, remat_policy="dots")``: ``models/transformer.py``'s
``_Remat`` keeps the outputs of the batch-free products that go through
``models/layers.py``'s ``dot``) vs "full", the plain traversal and the
JAX package's ``dots_with_no_batch_dims_saveable``, on the CPU.

On reduced gemma-7b and glm4-9b (``tests/test_torch_remat.py``'s
parameters and batch):

  * the ``lm_loss`` gradients under "dots" are within 2e-5 of "full"'s,
    of the plain ones and of the JAX package's "dots" gradients, under
    ``torch.func.grad``; and of the plain ones under ``vmap(grad)`` over
    two parameter sets;
  * ``dot``'s counter: under "dots" the backward computes no batch-free
    product again and reads every one the forward computed back; under
    "full" it computes every one again and reads none back (also on the
    MoE, recurrent and MLA configs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_torch_remat as TR  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.sharding.ctx import ShardCtx as JShardCtx  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.sharding import ShardCtx  # noqa: E402

ARCHS = ("gemma-7b", "glm4-9b")
DOTS = ShardCtx(remat=True, remat_policy="dots")
FULL = ShardCtx(remat=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_match_full_plain_and_jax(arch):
    jcfg, tcfg, jp, batch = TR._setup(arch)
    tp, tb = params_from_numpy(jp), TR._tbatch(batch)
    dots = TR._grad(tcfg, DOTS)(tp, tb)
    TR._close(dots, TR._grad(tcfg, FULL)(tp, tb), "dots vs full")
    TR._close(dots, TR._grad(tcfg, ShardCtx())(tp, tb), "dots vs plain")
    jg = jax.jit(jax.grad(lambda p, b: jsteps.lm_loss(
        p, jcfg, b, ctx=JShardCtx(remat=True, remat_policy="dots"))[0]))(
            jp, batch)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tu.flatten(dots)]
    TR._close(dots, tu.unflatten([p for p, _ in tu.flatten(dots)],
                                 [np.asarray(a) for _, a in jflat]),
              "dots vs the JAX package's dots")


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_under_vmap_grad(arch):
    _, tcfg, jp, batch = TR._setup(arch)
    tp = params_from_numpy(jp)
    stacked = tu.tree_map(lambda t: torch.stack([t, 0.9 * t]), tp)
    sb = {k: torch.stack([v, v]) for k, v in TR._tbatch(batch).items()}
    plain = torch.func.vmap(TR._grad(tcfg, ShardCtx()))(stacked, sb)
    dots = torch.func.vmap(TR._grad(tcfg, DOTS))(stacked, sb)
    TR._close(dots, plain, "vmap(grad): dots vs plain")


@pytest.mark.parametrize("arch", ARCHS + ("mixtral-8x7b", "recurrentgemma-9b",
                                          "xlstm-125m", "deepseek-v2-236b"))
def test_dots_recomputes_no_batch_free_product(arch):
    _, tcfg, jp, batch = TR._setup(arch)
    tp, tb = params_from_numpy(jp), TR._tbatch(batch)
    counts = {}
    for name, ctx in (("full", FULL), ("dots", DOTS)):
        L.dot_counts(reset=True)
        TR._grad(tcfg, ctx)(tp, tb)
        counts[name] = L.dot_counts(reset=True)
    full, dots = counts["full"], counts["dots"]
    assert full["forward"] > 0 and full["forward"] == dots["forward"]
    assert full["recomputed"] == full["forward"] and full["replayed"] == 0
    assert dots["recomputed"] == 0 and dots["replayed"] == dots["forward"]
