"""The port's functional VGG vs the JAX package's, with parameters carried
across through ``repro_torch.interop``: logits, loss and gradients on the
same numpy-seeded batch.

Configs: a 5-stage scaled paper net (1x1 spatial before fc0) and a
4-stage net at 32x32 (2x2 spatial), where fc0's rows depend on the
flatten order — the port must flatten NHWC like the JAX model. Tolerance:
atol 1e-5 / rtol 1e-4 — both sides run f32 convolutions and matmuls with
different algorithms and summation orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.vgg_family import VGGConfig as JVGGConfig  # noqa: E402
from repro.configs.vgg_family import scaled as jscaled  # noqa: E402
from repro.configs.vgg_family import vgg as jvgg  # noqa: E402
from repro.models import vgg as jmodel  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import vgg_family as tcfg  # noqa: E402
from repro_torch.core import VGGFamily  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import vgg as tmodel  # noqa: E402

CFGS = [jscaled(jvgg("vgg13"), 0.125, 64),
        JVGGConfig(name="s4", stages=((8,), (8, 8), (12,), (8,)),
                   classifier=(16,), n_classes=4, image_size=32)]


def _tcfg(c):
    return tcfg.VGGConfig(**{f: getattr(c, f) for f in
                             ("name", "stages", "classifier", "n_classes",
                              "in_channels", "image_size")})


def _inputs(cfg, seed=0, batch=6):
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    # He-scaled weights (fan-in = every axis but the last), small biases
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   * (np.sqrt(2.0 / np.prod(s.shape[:-1]))
                      if len(s.shape) > 1 else 0.1)).astype(np.float32),
        shapes)
    x = rng.standard_normal((batch, cfg.image_size, cfg.image_size,
                             cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, batch).astype(np.int32)
    return params, {"x": x, "y": y}


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c.name)
def test_logits_loss_and_grads_match_jax(cfg):
    params, batch = _inputs(cfg)

    @jax.jit          # one compile instead of op-by-op eager dispatch
    def reference(p, b):
        return (jmodel.apply(p, cfg, b["x"]),
                jax.value_and_grad(jmodel.loss_fn, has_aux=True)(p, cfg, b))

    jlogits, ((jloss, jacc), jgrads) = reference(
        params, jax.tree.map(jnp.asarray, batch))
    tc = _tcfg(cfg)
    tp = params_from_numpy(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits = tmodel.apply(tp, tc, tb["x"])
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-4)
    (tloss, tacc), tgrads = VGGFamily().loss_and_grad(tc)(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tacc) == float(jacc)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = tu.flatten(params_to_numpy(tgrads))
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, g), (path, h) in zip(jflat, tflat):
        np.testing.assert_allclose(h, np.asarray(g), atol=1e-5, rtol=1e-4,
                                   err_msg="/".join(path))


def test_vmapped_grads_equal_per_client_grads():
    """``torch.func.vmap`` over stacked clients == one grad per client —
    the engine's training step relies on it."""
    from torch.func import vmap
    cfg = CFGS[1]
    tc = _tcfg(cfg)
    gf = VGGFamily().loss_and_grad(tc)
    per = [_inputs(cfg, seed=s) for s in range(3)]
    tps = [params_from_numpy(p) for p, _ in per]
    tbs = [{k: torch.from_numpy(v) for k, v in b.items()} for _, b in per]
    stacked_p = tu.tree_map(lambda *xs: torch.stack(xs), *tps)
    stacked_b = {k: torch.stack([b[k] for b in tbs]) for k in tbs[0]}
    grads = vmap(lambda p, b: gf(p, b)[1])(stacked_p, stacked_b)
    for k in range(3):
        one = gf(tps[k], tbs[k])[1]
        for (path, a), (_, b) in zip(tu.flatten(one), tu.flatten(grads)):
            np.testing.assert_allclose(b[k].numpy(), a.numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg="/".join(path))


def test_init_shapes_and_meta():
    cfg = _tcfg(CFGS[0])
    fam = VGGFamily()
    p = fam.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = fam.shapes(cfg)
    jshapes = jax.eval_shape(lambda k: jmodel.init_params(k, CFGS[0]),
                             jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    for (pa, a), (pb, b), (_, s) in zip(tu.flatten(p), tu.flatten(shapes),
                                        jflat):
        assert pa == pb and tuple(a.shape) == tuple(b.shape) == s.shape
        assert b.device.type == "meta" and a.dtype == torch.float32
    # He-normal scale, as in the JAX model
    w = p["stages"]["s1"]["c0"]["w"]
    assert abs(float(w.std()) - (2.0 / (9 * w.shape[2])) ** 0.5) < 0.05
