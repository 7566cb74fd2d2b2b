"""The port's placement plan (``repro_torch.sharding.rules``) vs the JAX
package's, in one process.

  * ``param_specs`` (with and without ``embed_tp``) and ``cache_specs``
    (batch shardable or not) equal the reference's, leaf for leaf, for
    every architecture of ``models/registry.py`` ``arch_ids``, on the
    reference's ``AbstractMesh`` at (data, model) = (16, 16), (1, 2),
    (1, 4) and (2, 4); the port reads only the axis sizes;
  * ``head_layout`` equals the reference's at model extents 1, 2, 4, 16,
    and ``head_plan`` gives every rank its query heads and the kv heads
    they read;
  * ``tp_slice``'s parts, put back together, are the whole tree, a
    rank holds 1/m of each leaf it cuts, and ``tp_gather``'s shares of
    the parts sum to the whole bit for bit (every architecture's blocks:
    attention, MLA, MoE, the recurrent blocks, cross-attention and the
    encoder, the vision prefix); ``tp_not_ported`` is None for every
    architecture;
  * the executed data cut (FSDP: ``data_cut_dim``) takes, leaf for leaf,
    the dimension of the reference's ``param_specs`` data entry (with
    and without ``embed_tp``) for every architecture at (data, model) =
    (2, 1), (2, 2), (2, 4) and (16, 16); a rank's data parts, put
    together, are its model part bit for bit, each 1/d of it;
  * a decode batch the data extent does not divide (the reference's
    rule, ``batch_splits``) is served whole on every data rank
    (``cache_rows``, ``batch_ctx``), and the executed cache
    (``init_cache(..., ctx=)`` on ``meta``) cuts, leaf for leaf, the
    slots of exactly the dimensions ``cache_specs(...,
    batch_shardable=False)`` gives the data axes, into the rank's block
    (``cache_slot_cut``, ``seq_block``), for every architecture at
    (data, model) = (2, 1) and (2, 2), on top of its model part.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.specs import param_sds  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import arch_ids, get_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

MESHES = ((16, 16), (1, 2), (1, 4), (2, 4))
CACHE_B, CACHE_S = 2, 64
# in scope of tensor parallelism: (arch, replacements) of reduced configs
SLICE_CASES = (("glm4-9b", {}), ("gemma-7b", {}), ("gemma3-27b", {}),
               ("mixtral-8x7b", {}), ("command-r-plus-104b", {}),
               ("glm4-9b", {"n_heads": 6, "n_kv_heads": 2}),
               ("glm4-9b", {"n_heads": 6, "n_kv_heads": 3}),
               ("glm4-9b", {"vocab_size": 511}),
               # MLA and its experts; the recurrent blocks (rglru, rglru,
               # local); the xLSTM at 4 heads; cross-attention and the
               # encoder; the vision prefix with a d_ff 2 and 4 divide
               ("deepseek-v2-236b", {}), ("recurrentgemma-9b", {}),
               ("xlstm-125m", {"ssm": {"n_heads": 4}}),
               ("whisper-small", {}), ("internvl2-1b", {"d_ff": 256}))


def abstract_mesh(data, model):
    # jax>=0.4.36 takes ((name, size), ...); older takes (sizes, names)
    try:
        return AbstractMesh((("data", data), ("model", model)))
    except TypeError:
        return AbstractMesh((data, model), ("data", "model"))


def jax_specs(tree):
    """path -> the reference's spec entries."""
    return {"/".join(str(k.key) for k in p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def port_specs(tree):
    return {"/".join(p): s for p, s in tu.flatten(tree)}


@functools.lru_cache(maxsize=None)
def shapes(arch):
    """(reference parameter shapes, port parameter shapes on ``meta``,
    reference cache shapes, port cache shapes)."""
    jcfg = jget_config(arch)
    jcache = jax.eval_shape(lambda: jT.init_cache(jcfg, CACHE_B, CACHE_S))
    tcfg = get_config(arch)
    return (param_sds(jcfg), get_model(arch).param_shapes(), jcache,
            T.init_cache(tcfg, CACHE_B, CACHE_S, device="meta"))


@pytest.mark.parametrize("arch", arch_ids())
def test_param_specs_equal_the_reference(arch):
    jp, tp, _, _ = shapes(arch)
    for data, model in MESHES:
        mesh = abstract_mesh(data, model)
        for embed_tp in (False, True):
            want = jax_specs(jrules.param_specs(jp, mesh, ("data",),
                                                embed_tp=embed_tp))
            got = port_specs(rules.param_specs(
                tp, {"data": data, "model": model}, ("data",),
                embed_tp=embed_tp))
            assert got == want, (data, model, embed_tp)


@pytest.mark.parametrize("arch", arch_ids())
def test_cache_specs_equal_the_reference(arch):
    _, _, jc, tc = shapes(arch)
    for data, model in MESHES:
        mesh = abstract_mesh(data, model)
        for shardable in (True, False):
            want = jax_specs(jrules.cache_specs(jc, mesh, ("data",),
                                                batch_shardable=shardable))
            got = port_specs(rules.cache_specs(
                tc, {"data": data, "model": model}, ("data",),
                batch_shardable=shardable))
            assert got == want, (data, model, shardable)


HEAD_PAIRS = sorted({(get_config(a).n_heads, get_config(a).n_kv_heads)
                     for a in arch_ids()} | {(4, 2), (6, 2), (6, 3),
                                             (32, 2), (14, 2), (12, 12)})


@pytest.mark.parametrize("m", (1, 2, 4, 16))
def test_head_layout_and_plan(m):
    for H, KV in HEAD_PAIRS:
        layout = rules.head_layout(H, KV, m)
        assert layout == jA.head_layout(H, KV, m), (H, KV, m)
        G = H // KV
        plans = [rules.head_plan(H, KV, m, r) for r in range(m)]
        if layout in ("single", "replicate"):
            assert all((p.q0, p.nq, p.k0, p.nk) == (0, H, 0, KV)
                       for p in plans)
            continue
        # the ranks' query heads tile [0, H); each holds the kv heads of
        # its query heads
        assert [p.q0 for p in plans] == [r * H // m for r in range(m)]
        assert all(p.nq == H // m for p in plans)
        for p in plans:
            need = {(p.q0 + i) // G for i in range(p.nq)}
            assert need == set(range(p.k0, p.k0 + p.nk))
            assert [p.k0 + j for j in p.kv_index()] == [
                (p.q0 + i) // G for i in range(p.nq)]
        if layout == "kv":
            assert all(p.nk == KV // m and p.uniform and not p.shared
                       for p in plans)


def _slice_cfg(arch, kw):
    cfg = reduced(get_config(arch), d_model=64)
    if "n_heads" in kw:
        kw = dict(kw, head_dim=16)
    if "ssm" in kw:
        kw = dict(kw, ssm=dataclasses.replace(cfg.ssm, **kw["ssm"]))
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("arch,kw", SLICE_CASES)
def test_tp_slice_parts_make_the_whole(arch, kw, m):
    cfg = _slice_cfg(arch, kw)
    whole = T.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    parts = [rules.tp_slice_rank(whole, cfg, m, r) for r in range(m)]
    n_cut = 0
    for path, w in tu.flatten(whole):
        key = "/".join(path)
        cut = rules.tp_leaf_slice(key, tuple(w.shape), cfg, m, 0)
        got = [tu.get(p, path) for p in parts]
        if cut is None:
            assert all(g is w for g in got), key
            continue
        n_cut += 1
        dim = cut[0]
        rebuilt = torch.full_like(w, float("nan"))
        for r, g in enumerate(got):
            d, lo, n = rules.tp_leaf_slice(key, tuple(w.shape), cfg, m, r)
            assert d == dim and g.shape[dim] == n
            if not (key.endswith(("wk", "wv", "bk", "bv"))
                    and rules.head_layout(cfg.n_heads, cfg.n_kv_heads,
                                          m) == "expand"):
                assert n * m == w.shape[dim], key       # 1/m of the leaf
            rebuilt.narrow(dim, lo, n).copy_(g)
        assert torch.equal(rebuilt, w), key
        # tp_gather's shares (each column from one holder) sum to the
        # whole leaf bit for bit
        shares = [rules.tp_gather_part(g, key, tuple(w.shape), cfg, m, r)
                  for r, g in enumerate(got)]
        assert torch.equal(sum(shares), w), key
    assert n_cut > 0


@pytest.mark.parametrize("arch", arch_ids())
def test_every_architecture_has_a_tensor_parallel_cut(arch):
    assert rules.tp_not_ported(get_config(arch)) is None


DATA_MESHES = ((2, 1), (2, 2), (2, 4), (16, 16))


@pytest.mark.parametrize("arch", arch_ids())
def test_data_cut_is_the_plans_data_entry(arch):
    jp, tp, _, _ = shapes(arch)
    cfg = get_config(arch)
    for data, model in DATA_MESHES:
        mesh = abstract_mesh(data, model)
        for embed_tp in (False, True):
            want = jax_specs(jrules.param_specs(jp, mesh, ("data",),
                                                embed_tp=embed_tp))
            n_cut = 0
            for path, leaf in tu.flatten(tp):
                key = "/".join(path)
                entries = want[key]
                planned = [i - len(entries) for i, e in enumerate(entries)
                           if e == "data"]
                got = rules.data_cut_dim(key, tuple(leaf.shape), cfg,
                                         model, data, embed_tp=embed_tp)
                assert got == (planned[0] if planned else None), (
                    key, data, model, embed_tp)
                n_cut += got is not None
            assert n_cut > 0


FSDP_CASES = (("glm4-9b", {}), ("mixtral-8x7b", {}),
              ("mixtral-8x7b", {"moe": {"n_experts": 3}}),
              ("deepseek-v2-236b", {}), ("recurrentgemma-9b", {}),
              ("xlstm-125m", {"ssm": {"n_heads": 4}}), ("whisper-small", {}),
              ("internvl2-1b", {"d_ff": 256}))


@pytest.mark.parametrize("m", (1, 2))
@pytest.mark.parametrize("arch,kw", FSDP_CASES)
def test_data_parts_make_the_model_part(arch, kw, m):
    kw = dict(kw)
    moe = kw.pop("moe", None)
    cfg = _slice_cfg(arch, kw)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    whole = T.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    d = 2
    for mr in range(m):
        model_part = rules.tp_slice_rank(whole, cfg, m, mr)
        parts = [rules.data_slice_rank(model_part, cfg, m, d, r)
                 for r in range(d)]
        n_cut = 0
        for path, w in tu.flatten(model_part):
            key = "/".join(path)
            dim = rules.data_cut_dim(key, tuple(tu.get(whole, path).shape),
                                     cfg, m, d)
            got = [tu.get(p, path) for p in parts]
            if dim is None:
                assert all(g is w for g in got), key
                continue
            n_cut += 1
            assert all(g.shape[dim] * d == w.shape[dim] for g in got), key
            assert torch.equal(torch.cat(got, dim=dim), w), key
        assert n_cut > 0


def rank_ctx(data_size, data_rank, model_size=1, model_rank=0):
    """A ``ShardCtx`` that reports a rank of a (data, model) mesh without
    a process group (what ``init_cache`` and the rules read)."""
    from repro_torch.sharding import ShardCtx
    return type("RankCtx", (ShardCtx,), {
        "data_size": data_size, "data_rank": data_rank,
        "model_size": model_size, "model_rank": model_rank})()


def test_cache_rows_refuses_the_sequence_split():
    # nothing is refused any more: a batch the data extent does not
    # divide (or smaller than it) is every data rank's, whole
    ctx = rank_ctx(2, 1)
    assert rules.cache_rows(4, ctx) == slice(2, 4)
    assert rules.data_rows(6, ctx) == slice(3, 6)
    for n in (1, 3):
        assert not rules.batch_splits(n, ctx)
        assert rules.cache_rows(n, ctx) == slice(0, n)
        assert rules.batch_ctx(n, ctx).batch_whole
    assert rules.batch_splits(1, rank_ctx(1, 0))
    assert not rules.batch_ctx(4, rules.batch_ctx(1, ctx)).batch_whole
    with pytest.raises(ValueError, match="does not split"):
        rules.data_rows(3, ctx)
    seq = rules.batch_ctx(1, ctx)
    assert rules.seq_block(420, seq) == (210, 420)
    assert rules.seq_block(421, seq) == (0, 421)      # stays whole
    assert rules.seq_block(420, ctx) == (0, 420)      # the batch splits
    assert rules.cache_slot_cut("units/b0/k", (3, 1, 420, 2, 8), seq) == (
        2, 210, 420)
    assert rules.cache_slot_cut("rem/b0/xk", (1, 420, 2, 8), seq) is None
    with pytest.raises(ValueError, match="batch_whole"):
        type(rank_ctx(1, 0))(batch_whole=True)


@pytest.mark.parametrize("m", (1, 2))
@pytest.mark.parametrize("arch", arch_ids())
def test_sequence_split_cache_is_the_plans(arch, m):
    """At a batch of 1 on (data 2, model m): each rank's executed cache is
    its model part with the plan's data dimensions halved into its block;
    at an odd slot count every leaf stays whole over data."""
    cfg = get_config(arch)
    for S in (CACHE_S, CACHE_S - 1):
        whole = T.init_cache(cfg, 1, S, device="meta")
        plan = {"/".join(p): s for p, s in tu.flatten(rules.cache_specs(
            whole, {"data": 2, "model": m}, ("data",),
            batch_shardable=False))}
        n_cut = 0
        for mr in range(m):
            model_part = {"/".join(p): tuple(t.shape) for p, t in tu.flatten(
                T.init_cache(cfg, 1, S, device="meta",
                             ctx=rank_ctx(1, 0, m, mr)))}
            for r in range(2):
                ctx = rank_ctx(2, r, m, mr)
                got = {"/".join(p): tuple(t.shape) for p, t in tu.flatten(
                    T.init_cache(cfg, 1, S, device="meta", ctx=ctx))}
                seq = rules.batch_ctx(1, ctx)
                for p, t in tu.flatten(whole):
                    path = "/".join(p)
                    dims = [i for i, e in enumerate(plan[path])
                            if e == "data"]
                    want = list(model_part[path])
                    cut = rules.cache_slot_cut(path, tuple(t.shape), seq)
                    if dims:
                        n = t.shape[dims[0]] // 2
                        want[dims[0]] = n
                        assert cut == (dims[0], r * n, (r + 1) * n), path
                        n_cut += 1
                    else:
                        assert cut is None, path
                    assert got[path] == tuple(want), (path, S)
        assert (n_cut > 0) == (arch != "xlstm-125m" and S % 2 == 0), (
            arch, S)
