"""The bf16 compute policy of the port's unified engine vs the JAX
package's, on the CPU, on the tffn cohort (K = 4 clients alternating
reduced glm4-9b at full and half FFN width, S = 64, fedadp; ``tests/
test_torch_engine_tffn.py``'s).

The policy (``repro/fl/engine.py`` ``_train_cfg`` / ``_build_step``):
the ``(K, P)`` plane stays the f32 master copy; the step's parameters are
cast to bf16 once at unpack and the model runs on the union config with
``dtype="bfloat16"``; gradients come back to f32 before the E·Eᵀ
projection, the masks and the optimizer. One round from the same global
model and batches is held against the JAX engine's bf16 round and against
the port's own f32 round at 1e-2, the reference's contract for bf16
(``tests/test_flash.py`` ``test_engine_bf16_tracks_f32``), and leaf by
leaf at a tenth of what the f32 round moved the leaf
(``BF16_UPDATE_RTOL``); the global model stays f32. The loop engine refuses the policy, as the reference's
does, and a strategy's compute dtype wins over the backend's
(``repro/fl/backends.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import TransformerFamily as JFamily  # noqa: E402
from repro.core import tfamily as jtf  # noqa: E402
from repro.fl.engine import UnifiedEngine as JEngine  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core import TransformerFamily as TFamily  # noqa: E402
from repro_torch.fl import FLRunConfig as TRunConfig  # noqa: E402
from repro_torch.fl import UnifiedEngine as TEngine  # noqa: E402
from repro_torch.fl.backends import UnifiedBackend  # noqa: E402
from repro_torch.fl.strategy import make_strategy  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

K, S = 4, 64
BASE = jreduced(jget_config("glm4-9b"), n_units=2, d_model=64)
JCFGS = [jtf.make_variant(BASE, ffn_scale=0.5) if k % 2
         else jtf.make_variant(BASE) for k in range(K)]
N_SAMPLES = [16] * K
BF16_TOL = 1e-2     # tests/test_flash.py: bf16 tracks f32
# Leaf by leaf, the round's update (global after - global before) under
# bf16 agrees with the f32 update, and the port's with JAX's, to one
# significant digit: max |difference| <= 0.1 x max |f32 update|. This is
# not the reference's contract but a check of what the absolute 1e-2
# cannot see: a round that moved a leaf by less than 1e-2 would pass the
# absolute check even had it not trained at all. bf16 keeps 8 bits
# (relative spacing 2^-8); this cohort reads at most 5.7e-2.
BF16_UPDATE_RTOL = 0.1


def to_torch_cfg(c) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(c, f.name)
                          for f in dataclasses.fields(ModelConfig)})


TCFGS = [to_torch_cfg(c) for c in JCFGS]


def _global_params(seed=0):
    gcfg = JFamily().union(JCFGS)
    return jax.tree.map(np.asarray,
                        jT.init_params(jax.random.PRNGKey(seed), gcfg))


def _batches(steps=2, b=4, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, BASE.vocab_size,
                            (K, b, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def _max_diff(jtree, ttree) -> float:
    return max(_leaf_diffs(jtree, ttree).values())


def _leaf_diffs(jtree, ttree) -> dict:
    """max |a - b| of each leaf, by path."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = tu.flatten(ttree)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    return {p: float(np.abs(b.detach().numpy().astype(np.float32)
                            - np.asarray(a, np.float32)).max())
            for (_, a), (p, b) in zip(jflat, tflat)}


def _held_to_update(diffs: dict, moves: dict, what: str) -> None:
    """Every leaf moved, and differs by at most ``BF16_UPDATE_RTOL`` x
    its f32 update."""
    for p, d in diffs.items():
        assert moves[p] > 0, f"{p}: the f32 round did not move it"
        assert d <= BF16_UPDATE_RTOL * moves[p], \
            f"{what} {p}: {d:.3e} > {BF16_UPDATE_RTOL} x {moves[p]:.3e}"


KW = dict(lr=0.05, momentum=0.9, embed_seed=3, attn_backend="blockwise")


@pytest.mark.parametrize("attn", ["blockwise", "flash"])
def test_bf16_round_matches_jax_and_tracks_f32(attn):
    kw = dict(KW, attn_backend=attn)
    gp, batches = _global_params(), _batches()
    jeng = JEngine(JFamily(), JCFGS, N_SAMPLES, use_kernel=False,
                   compute_dtype="bf16", **kw)
    jout = jeng.run_round(gp, batches, round_idx=1)
    tbf = TEngine(TFamily(), TCFGS, N_SAMPLES, device="cpu",
                  compute_dtype="bf16", **kw)
    assert tbf._train_cfg().dtype == "bfloat16"
    assert tbf.global_cfg.dtype == "float32"
    tout = tbf.run_round(params_from_numpy(gp), batches, round_idx=1)
    for leaf in tu.leaves(tout):
        assert leaf.dtype == torch.float32
    assert _max_diff(jout, tout) <= BF16_TOL
    tf32 = TEngine(TFamily(), TCFGS, N_SAMPLES, device="cpu", **kw)
    f32_out = tf32.run_round(params_from_numpy(gp), batches, round_idx=1)
    d = max(float((a - b).abs().max())
            for a, b in zip(tu.leaves(f32_out), tu.leaves(tout)))
    assert 0 < d <= BF16_TOL        # the policy ran, and tracks f32
    # ... and the differences are small beside what the round moved
    moves = _leaf_diffs(gp, f32_out)
    _held_to_update(_leaf_diffs(jout, tout), moves, "port vs JAX, bf16")
    _held_to_update(_leaf_diffs(tu.tree_map(lambda t: t.detach().numpy(), f32_out),
                                tout), moves, "bf16 vs f32")


def test_loop_refuses_bf16():
    with pytest.raises(ValueError, match="loop"):
        TRunConfig(device="cpu", engine="loop", compute_dtype="bf16")
    assert TRunConfig(device="cpu", compute_dtype="bf16").engine != "loop"


def test_strategy_compute_dtype_takes_precedence():
    """As ``repro/fl/backends.py``: a strategy's non-default compute dtype
    wins; "f32" on the strategy defers to the backend's knob."""
    fam = TFamily()

    def bound(backend_dtype, strategy_dtype):
        backend = UnifiedBackend(fam, TCFGS, [None] * K,
                                 compute_dtype=backend_dtype, device="cpu")
        strategy = make_strategy("fedadp", fam, TCFGS, N_SAMPLES,
                                 compute_dtype=strategy_dtype, device="cpu")
        return backend.bind(strategy).engine.compute_dtype

    assert bound("f32", "bf16") == "bf16"
    assert bound("bf16", "f32") == "bf16"
    assert bound("f32", "f32") == "f32"
