"""Tensor parallelism over ``model`` (``sharding/rules.py`` ``tp_slice``,
``sharding/collectives.py``, the model's column- and row-parallel
layers) on gloo ranks of the CPU, vs the single-process port and the
JAX package.

Two spawns (``repro_torch.launch.mesh.run_ranks``, rank body
``test_torch_mesh_ranks.tensor_parallel``, one thread a rank): 2 ranks
over reduced glm4 (QKV bias, H 4 on KV 2: the "kv" head layout), gemma
(geglu, tied embeddings, ``embed_scale``), a 6-head / 3-kv-head variant
("expand", a kv head's query heads on both ranks), a vocabulary of 511
(it does not split: replicated), mixtral at 4 experts
(expert-parallel) and at 3 (each expert's F split), deepseek (MLA, its
experts over the ranks), recurrentgemma (rglru, rglru, local MQA:
"expand"), xlstm (mLSTM and sLSTM, 4 heads), whisper (crossdec over the
encoder) and internvl2 (the vision prefix's ``aux`` rows); 4 ranks over
glm4 ("expand"), a 6-head / 2-kv-head variant ("replicate"), deepseek,
xlstm (a head a rank) and whisper. Each rank cuts the same numpy-drawn
whole tree to its part and holds:

  * prefill logits, three greedy decode steps' logits and the cache
    after them, the ranks' vocabulary columns and cache parts
    (``tp_cache_slice``) put together, within 1e-6 x max|logits| of the
    single-process port and of the JAX package's ``prefill`` /
    ``decode_step`` (MLA: also the absorbed decode; the xLSTM at 5e-6,
    and deepseek and recurrentgemma against the JAX package at the
    single process's own distance from it plus 1e-6: ``XLSTM_TOL``,
    ``JAX_GAP_CASES``); the greedy tokens (argmax across ranks) equal;
  * one ``make_train_step`` step (SGD lr 1, the gradient read back): the
    loss within 2e-5 of both, the ranks' gradient slices put together
    within 2e-5 of the single-process gradients (glm4 also of JAX's);
  * ``seq_parallel`` (glm4, the recurrent and encoder cases),
    ``embed_tp`` and remat change nothing beyond 1e-6;
    ``tp_bf16_reduce`` under bf16 parameters stays within the bf16
    contract (1e-2 x max|logits|) of the f32 reduce;
  * ``launch.serve.run`` and ``launch.train.run`` given the rank's ctx
    decode the single-process tokens and report its losses (glm4 and
    whisper, its frames as ``aux``);
  * every block kind has its cut (``tp_not_ported`` is None).

The same spawns then run FSDP over a data axis of 2
(``test_torch_mesh_ranks.fsdp``): (data 2, model 1) on the 2 ranks over
glm4, mixtral (its stacks "whole" at model 1), deepseek, recurrentgemma,
xlstm, whisper and internvl2; (data 2, model 2) on the 4 over the same
and mixtral at 3 experts ("experts" and "ffn"). A rank holds its data
part of its model part of the whole tree and serves and trains its row
of the 2-row batch; held against the single process on the whole batch
and the JAX package at the tolerances above:

  * prefill and decode logits, greedy tokens and the cache, the ranks'
    rows and vocabulary columns put together, against one process on
    the whole batch, at the tolerance plus how far splitting the batch
    alone moves one process: a batch of 1 takes other products'
    rounding (up to 1.5e-6 x max|logits| at recurrentgemma's decode).
    That distance is the largest of: one process decoding each row as a
    batch of 1 from the whole batch's prefill cache; without MoE, one
    process serving each row as a batch of 1 (a MoE prefill's dispatch
    is the whole batch's on every rank, so a batch of 1 is not its
    reference); at (data 2, model 2), the (data 2, model 1) ranks', each
    one process on its row with the whole batch's dispatch;
  * the loss (every rank the whole batch's) and the whole-batch
    gradients, the data parts put together over the data ranks and
    the model parts over the model ranks (glm4's also against the JAX
    package's); a rank holds 1/2 of its model part of every leaf the
    plan cuts over data, and ``tp_gather`` of its part is the whole tree
    and ``tp_slice`` of that its part, bit for bit (every case);
  * remat (the gathers inside the checkpointed units) changes nothing
    beyond 1e-6;
  * ``launch.serve.run`` and ``launch.train.run`` decode the single
    process's tokens and report its losses, and the trainer's
    checkpoint, written from the data and model parts, is the
    one-process tree whose cut (``tp_slice_rank`` + ``data_slice_rank``)
    is each rank's parameters bit for bit;
  * a batch of 1, which the data extent does not divide, served whole
    on every data rank with each attention cache's slots cut in two
    (the plan's ``__seq__``: the sequence-split decode cache), every
    case above at a cache one slot longer than the prompt and the decode
    steps (even: both halves get prefill slots, the decode writes land
    on data rank 1, recurrentgemma's ring of 8 wraps across its halves)
    and glm4 also at the odd length, whose caches stay whole: the
    prefill and decode logits within 1e-6 x max|logits| (the xLSTM at
    5e-6) of one process serving the row as a batch of 1 and of the JAX
    package's ``prefill`` / ``decode_step`` at batch 1 (MLA: the
    absorbed decode too), the data ranks' logits bit-equal, the tokens
    equal, and the ranks' cache parts (their slot blocks over data,
    their heads over model) put together equal to one process's cache;
    the executed cache shapes are the plan's (``cache_specs(...,
    batch_shardable=False)``) for every architecture at both meshes.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_mesh_ranks as R  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.interop import params_to_numpy  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.registry import arch_ids  # noqa: E402
from repro_torch.sharding import CPU_CTX  # noqa: E402
from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.sharding.rules import (cache_specs, data_cut_dim,  # noqa: E402
                                        data_slice_rank, tp_cache_slice,
                                        tp_leaf_slice, tp_not_ported,
                                        tp_slice_rank)

VAL_TOL = 1e-6
GRAD_TOL = 2e-5
BF16_TOL = 1e-2
CASES = [(w, n) for w, names in R.TP_RANKS.items() for n in names]
# the single process sits 0.8-1.1e-6 x max|logits| from the JAX package on
# these (the RG-LRU's scan order, MLA's f32 sums; the port's own parity
# tests hold the families at 2e-5): the ranks are held to the reference at
# that distance plus the tensor-parallel tolerance
JAX_GAP_CASES = ("deepseek", "recurrentgemma")
# the xLSTM cells carry f32 rounding through their recurrent state: one
# process is 1.5-2.6e-6 x max|logits| from the JAX package at this config,
# a rank's logits and state ~1.4e-6 from one process (the rank's column
# slices of a projection round differently): both are held at 5e-6
XLSTM_TOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> the ranks' results, in rank order."""
    ckdir = str(tmp_path_factory.mktemp("ckpt"))
    return {w: run_ranks(R.tensor_parallel, w, (ckdir,),
                         rdv_dir=str(tmp_path_factory.mktemp(f"rdv{w}")),
                         timeout_s=60, wall_s=240, threads=1)
            for w in R.TP_RANKS}


@functools.lru_cache(maxsize=None)
def single(name):
    """The single-process port on the case's whole tree."""
    cfg = R.tp_cfg(name)
    params, batch = R.tp_params(cfg), R.tp_batch(cfg)
    out = R.tp_serve(params, cfg, batch, CPU_CTX)
    out["loss"], out["grads"] = R.sgd_grads(params, cfg, batch, CPU_CTX)
    if name == "glm4":
        with torch.no_grad():
            out["forward"] = R.T.forward(params, cfg,
                                         batch["tokens"]).numpy()
            out["forward_odd"] = R.T.forward(
                params, cfg, batch["tokens"][:, :-1]).numpy()
    return out


def to_jax_cfg(c):
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(jbase, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(cls)})
        return v
    return jbase.ModelConfig(**{f.name: conv(getattr(c, f.name))
                                for f in dataclasses.fields(jbase.ModelConfig)})


@functools.lru_cache(maxsize=None)
def single_seq(name, pad):
    """The single-process port serving the batch's first row as a batch
    of 1, its cache ``pad`` slots past the last token."""
    cfg = R.tp_cfg(name)
    batch = {k: v[:1] for k, v in R.tp_batch(cfg).items()}
    return R.tp_serve(R.tp_params(cfg), cfg, batch, CPU_CTX, pad=pad)


@functools.lru_cache(maxsize=None)
def reference(name, seq_pad=None):
    """The JAX package (CPU_CTX) on the same tree, prompts and ``aux``:
    prefill, greedy decode fed the port's tokens (MLA: the absorbed form's
    last step too), the loss. ``seq_pad``: the batch's first row alone
    (a batch of 1, fed ``single_seq``'s tokens) at a cache ``seq_pad``
    slots past the last token; no loss."""
    tcfg = R.tp_cfg(name)
    cfg = to_jax_cfg(tcfg)
    params = jax.tree.map(jnp.asarray, params_to_numpy(R.tp_params(tcfg)))
    rows = slice(None) if seq_pad is None else slice(0, 1)
    batch = {k: (np.asarray(v, np.int32) if k != "aux" else v.numpy())[rows]
             for k, v in R.tp_batch(tcfg).items()}
    npx = R.T.vision_prefix(tcfg)
    L = npx + R.TP_PROMPT + R.TP_GEN + (seq_pad or 0)
    logits, cache = jax.jit(lambda p, t, a: jT.prefill(
        p, cfg, t, aux=a, cache_len=L))(params, batch["tokens"],
                                        batch.get("aux"))
    out = {"prefill": np.asarray(logits), "decode": []}
    step = jax.jit(lambda p, t, c, pos, absorb: jT.decode_step(
        p, cfg, t, c, pos, ctx=jctx.ShardCtx(mla_absorb=absorb)),
        static_argnums=4)
    want = single(name) if seq_pad is None else single_seq(name, seq_pad)
    for i, tok in enumerate(want["tokens"]):
        tok = jnp.asarray(tok[:, None], jnp.int32)
        pos = jnp.int32(npx + R.TP_PROMPT + i)
        logits, cache = step(params, tok, cache, pos, False)
        out["decode"].append(np.asarray(logits))
    if tcfg.mla is not None:
        out["absorbed"] = np.asarray(step(params, tok, cache, pos, True)[0])
    if seq_pad is not None:
        return out
    out["loss"] = float(jax.jit(lambda p, b: jsteps.lm_loss(
        p, cfg, b)[0])(params, batch))
    if name == "glm4":
        g = jax.jit(jax.grad(lambda p, b: jsteps.lm_loss(p, cfg, b)[0]))(
            params, batch)
        out["grads"] = {"/".join(str(k.key) for k in p): np.asarray(v)
                        for p, v in jax.tree_util.tree_flatten_with_path(g)[0]}
    return out


def vocab_whole(parts, cfg):
    """The ranks' logits put together: their vocabulary columns in rank
    order when the vocabulary splits, else every rank's whole (equal)."""
    if parts[0].shape[-1] == cfg.vocab_size:
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0])
        return parts[0]
    return np.concatenate(parts, axis=-1)


def assemble(parts, cfg, world, cut):
    """Leaf trees of the ranks (path -> array) -> the whole leaves:
    ``cut(path, shape, rank)`` gives each rank's (dim, start, length) or
    None (held whole). Where ranks hold the same entries they must
    agree."""
    out = {}
    for path in parts[0]:
        first = parts[0][path]
        cuts = [cut(path, r) for r in range(world)]
        if cuts[0] is None:
            for p in parts[1:]:
                np.testing.assert_array_equal(p[path], first, err_msg=path)
            out[path] = first
            continue
        dim = cuts[0][0]
        shape = list(first.shape)
        shape[dim] = max(c[1] + c[2] for c in cuts)
        whole = np.full(shape, np.nan, np.float32)
        for r, (_, lo, n) in enumerate(cuts):
            idx = [slice(None)] * len(shape)
            idx[dim] = slice(lo, lo + n)
            seen = whole[tuple(idx)]
            mask = ~np.isnan(seen)
            np.testing.assert_array_equal(parts[r][path][mask], seen[mask],
                                          err_msg=path)
            whole[tuple(idx)] = parts[r][path]
        assert not np.isnan(whole).any(), path
        out[path] = whole
    return out


def grads_whole(parts, cfg, world, whole_shapes):
    return assemble(parts, cfg, world, lambda path, r: tp_leaf_slice(
        path, whole_shapes[path], cfg, world, r))


def cache_whole(parts, cfg, world, whole_shapes):
    return assemble(parts, cfg, world, lambda path, r: tp_cache_slice(
        path, whole_shapes[path], cfg, world, r))


def close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("world,name", CASES)
def test_serving_matches_single_process_and_jax(ranks, world, name):
    cfg = R.tp_cfg(name)
    outs = [o["cases"][name] for o in ranks[world]]
    want, ref = single(name), reference(name)
    val_tol = XLSTM_TOL if name == "xlstm" else VAL_TOL

    def hold(parts, key, what, i=None):
        got = vocab_whole(parts, cfg)
        one = want[key] if i is None else want[key][i]
        jax_ = ref[key] if i is None else ref[key][i]
        tol = val_tol * float(np.abs(one).max())
        close(got, one, tol, f"{what} vs port")
        if name in JAX_GAP_CASES:
            # the single process's own distance from the reference: the
            # ranks may add no more than the tensor-parallel tolerance
            tol += float(np.abs(one - jax_).max())
        close(got, jax_, tol, f"{what} vs jax")

    hold([o["prefill"] for o in outs], "prefill", "prefill")
    for i in range(R.TP_GEN):
        hold([o["decode"][i] for o in outs], "decode", f"decode {i}", i)
        for o in outs:
            np.testing.assert_array_equal(o["tokens"][i], want["tokens"][i])
    if cfg.mla is not None:
        hold([o["absorbed"] for o in outs], "absorbed", "absorbed decode")
    cache = cache_whole([o["cache"] for o in outs], cfg, world,
                        {k: v.shape for k, v in want["cache"].items()})
    for path, c in want["cache"].items():
        close(cache[path], c, val_tol * float(np.abs(c).max()), path)
    for o in outs:
        # init_cache holds the kv heads prefill builds on the rank
        assert o["init_cache"] == {k: v.shape for k, v in o["cache"].items()}


@pytest.mark.parametrize("world,name", CASES)
def test_train_step_loss_and_gradients(ranks, world, name):
    cfg = R.tp_cfg(name)
    outs = [o["cases"][name] for o in ranks[world]]
    want = single(name)
    for o in outs:
        assert abs(o["loss"] - want["loss"]) <= GRAD_TOL * abs(want["loss"])
    assert abs(want["loss"] - reference(name)["loss"]) <= GRAD_TOL * abs(
        want["loss"])
    shapes = {k: v.shape for k, v in want["grads"].items()}
    got = grads_whole([o["grads"] for o in outs], cfg, world, shapes)
    for path, g in want["grads"].items():
        close(got[path], g, GRAD_TOL, path)
    # the rank holds its part: each cut leaf 1/m of the whole leaf
    for o in ranks[world]:
        held = 0
        for path, shape in shapes.items():
            cut = tp_leaf_slice(path, shape, cfg, world, o["model_rank"])
            n = int(np.prod(shape))
            held += n if cut is None else n // shape[cut[0]] * cut[2]
        assert o["cases"][name]["held_numel"] == held
        assert held < sum(int(np.prod(s)) for s in shapes.values())


@pytest.mark.parametrize("world", sorted(R.TP_RANKS))
def test_gradients_match_jax(ranks, world):
    cfg = R.tp_cfg("glm4")
    want = reference("glm4")["grads"]
    shapes = {k: v.shape for k, v in want.items()}
    got = grads_whole([o["cases"]["glm4"]["grads"] for o in ranks[world]],
                      cfg, world, shapes)
    for path, g in want.items():
        close(got[path], g, GRAD_TOL, path)


@pytest.mark.parametrize("world", sorted(R.TP_RANKS))
def test_seq_parallel_changes_nothing(ranks, world):
    cfg = R.tp_cfg("glm4")
    outs = ranks[world]
    want = single("glm4")
    for key, ref in (("forward", "forward"), ("forward_sp", "forward"),
                     ("forward_sp_odd", "forward_odd")):
        got = vocab_whole([o[key] for o in outs], cfg)
        close(got, want[ref], VAL_TOL * float(np.abs(want[ref]).max()), key)
    for o in outs:
        plain = o["cases"]["glm4"]
        close(o["serve_sp"]["prefill"], plain["prefill"],
              VAL_TOL * float(np.abs(plain["prefill"]).max()), "sp prefill")
        assert o["loss_sp"] == pytest.approx(plain["loss"], rel=VAL_TOL)
        for path, g in plain["grads"].items():
            close(o["grads_sp"][path], g, VAL_TOL, f"sp {path}")


SP_CASES = [(w, n) for w, n in CASES if n in R.TP_SP_CASES]


@pytest.mark.parametrize("world,name", SP_CASES)
def test_seq_parallel_recurrent_and_encoder(ranks, world, name):
    for o in ranks[world]:
        got = o["cases"][name]
        close(got["forward_sp"], got["forward"],
              VAL_TOL * float(np.abs(got["forward"]).max()), "sp forward")
        assert got["loss_sp"] == pytest.approx(got["loss"], rel=VAL_TOL)
        for path, g in got["grads"].items():
            close(got["grads_sp"][path], g, VAL_TOL, f"sp {path}")


@pytest.mark.parametrize("world", sorted(R.TP_RANKS))
def test_remat_composes_with_the_reduces(ranks, world):
    for o in ranks[world]:
        plain = o["cases"]["glm4"]
        for tag in ("remat", "sp_remat"):
            assert o[f"loss_{tag}"] == pytest.approx(plain["loss"],
                                                     rel=VAL_TOL)
            for path, g in plain["grads"].items():
                close(o[f"grads_{tag}"][path], g, VAL_TOL, f"{tag} {path}")


def test_embed_tp_changes_nothing(ranks):
    for o in ranks[2]:
        plain = o["cases"]["glm4"]
        got = o["serve_embed_tp"]
        close(got["prefill"], plain["prefill"],
              VAL_TOL * float(np.abs(plain["prefill"]).max()), "embed_tp")
        for a, b in zip(got["tokens"], plain["tokens"]):
            np.testing.assert_array_equal(a, b)


def test_bf16_reduce_within_the_bf16_contract(ranks):
    for o in ranks[2]:
        f32, b16 = o["bf16_f32_reduce"], o["bf16_bf16_reduce"]
        assert np.isfinite(b16).all()
        close(b16, f32, BF16_TOL * float(np.abs(f32).max()), "bf16 reduce")


@functools.lru_cache(maxsize=None)
def single_launch():
    return R.tp_launch(CPU_CTX)


def test_serve_and_train_launchers_under_a_model_axis(ranks):
    want = single_launch()
    for o in ranks[2]:
        for arch in R.TP_LAUNCH_ARCHS:
            got = o["launch"][arch]
            np.testing.assert_array_equal(got["tokens"], want[arch]["tokens"])
            np.testing.assert_allclose(got["losses"], want[arch]["losses"],
                                       rtol=GRAD_TOL, atol=0)


def hold_seq_shapes(ranks, world, arch):
    """The rank's executed batch-1 cache (``init_cache(..., ctx=)`` at
    ``SEQ_SHAPE_SLOTS``) has, leaf for leaf, its model part's shape with
    each dimension that ``cache_specs(..., batch_shardable=False)`` gives
    the data axes halved. Returns how many leaves the data axes cut."""
    cfg = R.reduced(R.get_config(arch), d_model=64)
    m = world // 2
    whole = R.T.init_cache(cfg, 1, R.SEQ_SHAPE_SLOTS, device="meta")
    plan = {"/".join(p): s for p, s in tu.flatten(cache_specs(
        whole, {"data": 2, "model": m}, ("data",), batch_shardable=False))}
    n_cut = 0
    for o in ranks[world]:
        got = o["fsdp"]["seq_shapes"][arch]
        for p, t in tu.flatten(whole):
            path = "/".join(p)
            want = list(t.shape)
            cut = tp_cache_slice(path, tuple(want), cfg, m,
                                 o["fsdp"]["model_rank"])
            if cut is not None:
                want[cut[0]] = cut[2]
            for dim, entry in enumerate(plan[path]):
                if entry == "data":
                    want[dim] //= 2
                    n_cut += 1
            assert got[path] == tuple(want), (path, got[path], want)
    return n_cut


@pytest.mark.parametrize("arch", R.TP_OUT_OF_SCOPE)
def test_out_of_scope_blocks_raise_not_ported(ranks, arch):
    # every block kind has its cut over model and over data (FSDP), and
    # nothing is refused: a decode batch the data extent does not divide
    # cuts the attention caches' slots over data instead (the plan's
    # __seq__), as cache_specs(batch_shardable=False) does
    cfg = R.reduced(R.get_config(arch), d_model=64)
    assert tp_not_ported(cfg) is None
    whole = {"/".join(p): tuple(t.shape) for p, t in tu.flatten(
        R.T.init_params(None, cfg, device="meta"))}
    n_cut = 0
    for o in ranks[2]:
        got = o["fsdp"]["out_of_scope"][arch]
        for path, shape in whole.items():
            dim = data_cut_dim(path, shape, cfg, 1, 2)
            want = list(shape)
            if dim is not None:
                want[dim] //= 2
                n_cut += 1
            assert got["held"][path] == tuple(want), path
    assert n_cut > 0
    n_seq = sum(hold_seq_shapes(ranks, w, arch) for w in sorted(R.FSDP_RANKS))
    # xLSTM has no attention cache: its recurrent state stays whole
    assert (n_seq > 0) == (arch != "xlstm-125m")


@pytest.mark.parametrize("world", sorted(R.FSDP_RANKS))
@pytest.mark.parametrize("arch", arch_ids())
def test_seq_cache_shapes_are_the_plans(ranks, world, arch):
    n_cut = hold_seq_shapes(ranks, world, arch)
    assert (n_cut > 0) == (arch != "xlstm-125m")


# ------------------------------------------------ FSDP over the data axes
FSDP_CASES = [(w, n) for w, names in R.FSDP_RANKS.items() for n in names]


def fsdp_by_rank(ranks, world, name):
    """{(data rank, model rank): the rank's results for ``name``}."""
    return {(o["fsdp"]["data_rank"], o["fsdp"]["model_rank"]):
            o["fsdp"]["cases"][name] for o in ranks[world]}


def fsdp_rows(outs, world, get, cfg):
    """The ranks' logits put together: each data rank's vocabulary
    columns over its model ranks (``vocab_whole``), then the data ranks'
    rows in order."""
    m = world // 2
    return np.concatenate([vocab_whole([get(outs[d, r]) for r in range(m)],
                                       cfg) for d in range(2)], axis=0)


def data_whole(parts, dim_of):
    """Leaf trees of the data ranks, in order -> their model part: a leaf
    ``dim_of(path)`` cuts concatenated on that dimension, one held whole
    the same on every data rank."""
    out = {}
    for path, first in parts[0].items():
        dim = dim_of(path)
        if dim is None:
            for p in parts[1:]:
                np.testing.assert_array_equal(p[path], first, err_msg=path)
            out[path] = first
        else:
            out[path] = np.concatenate([p[path] for p in parts], axis=dim)
    return out


def fsdp_grads(outs, world, cfg, shapes, key="grads"):
    m = world // 2
    per_model = [data_whole([outs[d, r][key] for d in range(2)],
                            lambda path: data_cut_dim(path, shapes[path],
                                                      cfg, m, 2))
                 for r in range(m)]
    if m == 1:
        return per_model[0]
    return grads_whole(per_model, cfg, m, shapes)


@functools.lru_cache(maxsize=None)
def single_rows(name):
    """The single-process port serving each data rank's row alone (a
    batch of 1), in data-rank order."""
    cfg = R.tp_cfg(name)
    params, batch = R.tp_params(cfg), R.tp_batch(cfg)
    return [R.tp_serve(params, cfg, {k: v[d:d + 1] for k, v in
                                     batch.items()}, CPU_CTX)
            for d in range(2)]


@functools.lru_cache(maxsize=None)
def single_decode_rows(name):
    """The single-process port decoding each row alone (a batch of 1)
    from its row of the whole batch's prefill cache, fed the whole
    batch's tokens: the decode logits and the cache after them, in
    data-rank order (the prefill logits are the whole batch's)."""
    cfg = R.tp_cfg(name)
    params, batch = R.tp_params(cfg), R.tp_batch(cfg)
    npx = R.T.vision_prefix(cfg)
    L = npx + R.TP_PROMPT + R.TP_GEN
    want = single(name)
    with torch.no_grad():
        _, cache = R.T.prefill(params, cfg, batch["tokens"],
                               aux=batch.get("aux"), cache_len=L)
        out = []
        for d in range(2):
            mine = tu.map_with_path(
                lambda p, t: (t[:, d:d + 1] if p[0] == "units"
                              else t[d:d + 1]).clone(), cache)
            got = {"prefill": want["prefill"][d:d + 1], "decode": []}
            for i in range(R.TP_GEN):
                tok = torch.from_numpy(want["tokens"][i][d:d + 1])[:, None]
                logits, mine = R.T.decode_step(params, cfg, tok, mine,
                                               npx + R.TP_PROMPT + i)
                got["decode"].append(logits.numpy().copy())
            if cfg.mla is not None:
                got["absorbed"] = want["absorbed"][d:d + 1]
            got["cache"] = R._np_tree(mine)
            out.append(got)
    return out


@pytest.mark.parametrize("world,name", FSDP_CASES)
def test_fsdp_serving_matches_single_process_and_jax(ranks, world, name):
    cfg = R.tp_cfg(name)
    outs = fsdp_by_rank(ranks, world, name)
    want, ref = single(name), reference(name)
    val_tol = XLSTM_TOL if name == "xlstm" else VAL_TOL
    # the batch split's references, each one process per row
    splits = [single_decode_rows(name)]
    if cfg.moe is None:
        splits.append(single_rows(name))
    if world == 4:
        m1 = fsdp_by_rank(ranks, 2, name)
        splits.append([m1[d, 0] for d in range(2)])

    def pick(out, key, i):
        return out[key] if i is None else out[key][i]

    def gap(one, get):
        # how far the batch split alone moves one process: the ranks may
        # add no more than the tolerance to it
        return max(float(np.abs(one - np.concatenate(
            [get(a) for a in alone], axis=0)).max()) for alone in splits)

    def hold(get, key, what, i=None):
        got = fsdp_rows(outs, world, get, cfg)
        one, jax_ = pick(want, key, i), pick(ref, key, i)
        tol = val_tol * float(np.abs(one).max()) + gap(
            one, lambda a: pick(a, key, i))
        close(got, one, tol, f"{what} vs port")
        if name in JAX_GAP_CASES:
            tol += float(np.abs(one - jax_).max())
        close(got, jax_, tol, f"{what} vs jax")

    hold(lambda o: o["prefill"], "prefill", "prefill")
    for i in range(R.TP_GEN):
        hold(lambda o: o["decode"][i], "decode", f"decode {i}", i)
        for (d, _), o in outs.items():
            np.testing.assert_array_equal(o["tokens"][i],
                                          want["tokens"][i][d:d + 1])
    if cfg.mla is not None:
        hold(lambda o: o["absorbed"], "absorbed", "absorbed decode")
    m = world // 2
    shapes = {k: v.shape for k, v in want["cache"].items()}
    rows = [cache_whole([outs[d, r]["cache"] for r in range(m)], cfg, m,
                        shapes) if m > 1 else outs[d, 0]["cache"]
            for d in range(2)]
    for path, c in want["cache"].items():
        axis = 1 if path.startswith("units") else 0
        got = np.concatenate([r[path] for r in rows], axis=axis)
        g = max(float(np.abs(c - np.concatenate(
            [a["cache"][path] for a in alone], axis=axis)).max())
            for alone in splits)
        close(got, c, val_tol * float(np.abs(c).max()) + g, path)
    for o in outs.values():
        assert o["init_cache"] == {k: v.shape for k, v in o["cache"].items()}


@pytest.mark.parametrize("world,name", FSDP_CASES)
def test_fsdp_train_step_loss_and_whole_batch_gradients(ranks, world, name):
    cfg = R.tp_cfg(name)
    outs = fsdp_by_rank(ranks, world, name)
    want = single(name)
    ref = reference(name)
    for o in outs.values():
        # every rank reports the whole batch's loss
        assert abs(o["loss"] - want["loss"]) <= GRAD_TOL * abs(want["loss"])
        assert abs(o["loss"] - ref["loss"]) <= GRAD_TOL * abs(ref["loss"])
        # tp_gather of the part is the whole tree, tp_slice of it the part
        assert o["round_trip"]
    shapes = {k: v.shape for k, v in want["grads"].items()}
    got = fsdp_grads(outs, world, cfg, shapes)
    for path, g in want["grads"].items():
        close(got[path], g, GRAD_TOL, path)
        if "grads" in ref:
            close(got[path], ref["grads"][path], GRAD_TOL, f"{path} vs jax")
    # the rank holds 1/2 of its model part of every leaf cut over data
    m = world // 2
    for (_, r), o in outs.items():
        held = 0
        for path, shape in shapes.items():
            cut = tp_leaf_slice(path, shape, cfg, m, r)
            n = int(np.prod(shape))
            n = n if cut is None else n // shape[cut[0]] * cut[2]
            held += n if data_cut_dim(path, shape, cfg, m, 2) is None \
                else n // 2
        assert o["held_numel"] == held


FSDP_REMAT_CASES = [(w, n) for w, n in FSDP_CASES if n in R.FSDP_REMAT]


@pytest.mark.parametrize("world,name", FSDP_REMAT_CASES)
def test_fsdp_remat_composes_with_the_gathers(ranks, world, name):
    for o in fsdp_by_rank(ranks, world, name).values():
        assert o["loss_remat"] == pytest.approx(o["loss"], rel=VAL_TOL)
        for path, g in o["grads"].items():
            close(o["grads_remat"][path], g, VAL_TOL, f"remat {path}")


@pytest.mark.parametrize("world", sorted(R.FSDP_RANKS))
def test_fsdp_launchers_and_checkpoint_round_trip(ranks, world):
    want = single_launch()
    m = world // 2
    for arch in R.TP_LAUNCH_ARCHS:
        cfg = R.reduced(R.get_config(arch), d_model=R.TP_TRAIN["d_model"])
        for o in ranks[world]:
            got = o["fsdp"]["launch"][arch]
            np.testing.assert_array_equal(got["tokens"], want[arch]["tokens"])
            np.testing.assert_allclose(got["losses"], want[arch]["losses"],
                                       rtol=GRAD_TOL, atol=0)
        path = ranks[world][0]["fsdp"]["launch"][arch]["ckpt"]
        whole, extra = load_pytree(path)
        assert extra["arch"] == cfg.name
        assert [(p, tuple(t.shape)) for p, t in tu.flatten(whole)] == [
            (p, tuple(t.shape)) for p, t in tu.flatten(
                R.T.init_params(None, cfg, device="meta"))]
        for o in ranks[world]:
            f = o["fsdp"]
            mine = data_slice_rank(
                tp_slice_rank(whole, cfg, m, f["model_rank"]), cfg, m, 2,
                f["data_rank"])
            for p, t in tu.flatten(mine):
                np.testing.assert_array_equal(
                    t.numpy(), f["launch"][arch]["params"]["/".join(p)],
                    err_msg="/".join(p))


# ------------------------------------- batch 1: the sequence-split cache
SEQ_CASES = [(w, n, R.FSDP_SEQ_PAD) for w, n in FSDP_CASES] + [
    (w, R.FSDP_SEQ_ODD, 0) for w in sorted(R.FSDP_RANKS)]


def seq_by_rank(ranks, world, name, pad):
    key = "seq" if pad == R.FSDP_SEQ_PAD else "seq_odd"
    return {(o["fsdp"]["data_rank"], o["fsdp"]["model_rank"]):
            (o["fsdp"][key] if key == "seq_odd" else o["fsdp"][key][name])
            for o in ranks[world]}


@pytest.mark.parametrize("world,name,pad", SEQ_CASES)
def test_batch1_serving_splits_the_cache_sequence(ranks, world, name, pad):
    cfg = R.tp_cfg(name)
    outs = seq_by_rank(ranks, world, name, pad)
    want, ref = single_seq(name, pad), reference(name, pad)
    val_tol = XLSTM_TOL if name == "xlstm" else VAL_TOL
    m = world // 2
    L = R.T.vision_prefix(cfg) + R.TP_PROMPT + R.TP_GEN + pad
    for o in outs.values():
        assert o["batch_whole"]

    def hold(get, one, jax_, what):
        for r in range(m):
            # every data rank serves the whole batch: bit-equal logits
            np.testing.assert_array_equal(get(outs[0, r]), get(outs[1, r]),
                                          err_msg=what)
        got = vocab_whole([get(outs[0, r]) for r in range(m)], cfg)
        tol = val_tol * float(np.abs(one).max())
        close(got, one, tol, f"{what} vs port")
        if name in JAX_GAP_CASES:
            tol += float(np.abs(one - jax_).max())
        close(got, jax_, tol, f"{what} vs jax")

    hold(lambda o: o["prefill"], want["prefill"], ref["prefill"], "prefill")
    for i in range(R.TP_GEN):
        hold(lambda o: o["decode"][i], want["decode"][i], ref["decode"][i],
             f"decode {i}")
        for o in outs.values():
            np.testing.assert_array_equal(o["tokens"][i], want["tokens"][i])
    if cfg.mla is not None:
        hold(lambda o: o["absorbed"], want["absorbed"], ref["absorbed"],
             "absorbed decode")
    # the cache: each data rank's model parts put together, then the data
    # ranks' slot blocks (cache_slot_cut) in order
    shapes = {k: v.shape for k, v in want["cache"].items()}
    per_data = [cache_whole([outs[d, r]["cache"] for r in range(m)], cfg, m,
                            shapes) if m > 1 else outs[d, 0]["cache"]
                for d in range(2)]
    n_cut = 0
    for path, c in want["cache"].items():
        cuts = [outs[d, 0]["slot_cuts"][path] for d in range(2)]
        if cuts[0] is None:
            np.testing.assert_array_equal(per_data[1][path],
                                          per_data[0][path], err_msg=path)
            got = per_data[0][path]
        else:
            n_cut += 1
            dim = cuts[0][0]
            assert [c_[1:] for c_ in cuts] == [
                (d * c.shape[dim] // 2, (d + 1) * c.shape[dim] // 2)
                for d in range(2)], (path, cuts)
            got = np.concatenate([per_data[d][path] for d in range(2)],
                                 axis=dim)
        close(got, c, val_tol * float(np.abs(c).max()), path)
    attn_cached = name != "xlstm"
    assert (n_cut > 0) == (attn_cached and L % 2 == 0), (name, L, n_cut)
