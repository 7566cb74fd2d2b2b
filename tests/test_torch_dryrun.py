"""The dry run (``repro_torch.launch.dryrun``, ``op_count``,
``roofline``) vs the JAX package's (``repro.launch.dryrun``,
``hlo_analysis``, ``roofline``).

  * one step's dot FLOPs counted on ``meta`` equal the reference's
    ``hlo_analysis.analyze`` of the compiled HLO, exactly, at one
    device on reduced configs (B 2, S 64): glm4-9b train / prefill /
    decode, deepseek-v2-236b train / prefill, xlstm-125m, whisper-small
    and internvl2-1b prefill; gemma3-27b, mixtral-8x7b and
    recurrentgemma-9b prefill (their sliding-window layers' ring cache
    is built without a boolean index, so their prefill runs on
    ``meta``) equal it plus one banded block step a local layer: with a
    single query block the reference's analyzer counts 2 of the band's
    3 block steps in the loop XLA rewrites (a "wide" while; its known
    fault, ROADMAP queue 3); both packages run 3. With several query
    blocks (S 256, blocks 32-128) the two agree with no adjustment;
  * under remat (the dry run's setting) the train step's count equals
    the reference's plus the recompute XLA drops: each unit's last FFN
    down projection, whose output the backward does not read;
  * the dry run's blocks (4096 rows, but the ShardCtx default for a
    config with sliding-window layers) count what the default blocks
    count;
  * ``roofline.model_flops`` / ``hbm_bytes`` / ``_cache_bytes`` equal the
    reference's for every architecture x input shape x {1, 256, 512}
    cards;
  * at model 2 and 4 the ranks' dot FLOPs sum to the one-device count
    plus the work the plan leaves whole, named per case;
  * each rank's parameter shapes at (data, model) = (16, 16) are the
    shard shapes of the reference's ``rules.param_specs`` on
    ``AbstractMesh((16, 16))``, leaf for leaf, but the leaves
    ``sharding.rules.tp_slice`` documents as cut otherwise;
  * one full-width pair through the CLI in a subprocess exits 0.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import roofline as jRL  # noqa: E402
from repro.launch import specs as jSP  # noqa: E402
from repro.launch.steps import make_decode_step as jdecode  # noqa: E402
from repro.launch.steps import make_prefill_step as jprefill  # noqa: E402
from repro.launch.steps import make_train_step as jtrain  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.sharding.ctx import ShardCtx as JCtx  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding.rules import (data_slice_rank, head_layout,  # noqa: E402
                                        tp_slice_rank)

B, S = 2, 64
SHAPE_OF = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sds(shape, dt):
    return jax.ShapeDtypeStruct(shape, dt)


def _reference_flops(arch, kind, remat=False, block=512, S=S):
    """The reference's dot FLOPs of one step at one device: the step
    lowered and compiled, its HLO read by ``hlo_analysis.analyze``."""
    cfg = jreduced(jget_config(arch))
    ctx = JCtx(remat=remat, block_q=block, block_kv=block)
    psds = jSP.param_sds(cfg)
    if kind == "decode":
        cache = jax.eval_shape(lambda: jT.init_cache(cfg, B, S))
        low = jax.jit(jdecode(cfg, ctx=ctx)).lower(
            psds, _sds((B, 1), jnp.int32), cache, _sds((), jnp.int32))
        return hlo_analysis.analyze(low.compile().as_text())["dot_flops"]
    adt = jnp.dtype(cfg.dtype)
    b, n_text = {}, S
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        n_text = S - cfg.frontend.n_prefix
        b["aux"] = _sds((B, cfg.frontend.n_prefix, cfg.d_model), adt)
    if cfg.encoder is not None:
        b["aux"] = _sds((B, cfg.encoder.n_ctx, cfg.d_model), adt)
    b["tokens"] = _sds((B, n_text), jnp.int32)
    if kind == "train":
        b["labels"] = _sds((B, n_text), jnp.int32)
        opt = jadamw(1e-4)
        low = jax.jit(jtrain(cfg, opt, ctx=ctx, loss_chunk=512)).lower(
            psds, jSP.opt_sds(cfg, opt, psds), _sds((), jnp.int32), b)
    else:
        low = jax.jit(jprefill(cfg, ctx=ctx, cache_len=S)).lower(psds, b)
    return hlo_analysis.analyze(low.compile().as_text())["dot_flops"]


def _port_flops(arch, kind, mesh_shape=None, rank=0, seq=S, **ctx_kw):
    cfg = reduced(get_config(arch))
    res = dryrun.run_pair(arch, SHAPE_OF[kind], mesh_shape=mesh_shape,
                          rank=rank, dtype=cfg.dtype, batch=B, seq=seq,
                          cfg=cfg, ctx_kw={"remat": False, **ctx_kw})
    assert res["status"] == "OK", res
    return res["counts"]["dot_flops"]


def _missed_band_steps(arch):
    """The dot FLOPs of one banded block step (q·kᵀ and p·v over a
    min(512, S)-square block) on every local layer: the step the
    reference's analyzer does not count."""
    cfg = reduced(get_config(arch))
    n_local = sum(k == "local" for k in cfg.layer_kinds())
    blk = min(512, S)
    return n_local * 2 * (2 * B * cfg.n_heads * blk * blk
                          * cfg.resolved_head_dim)


@pytest.mark.parametrize("arch,kind", [
    ("glm4-9b", "train"), ("glm4-9b", "prefill"), ("glm4-9b", "decode"),
    ("deepseek-v2-236b", "train"), ("deepseek-v2-236b", "prefill"),
    ("xlstm-125m", "prefill"), ("whisper-small", "prefill"),
    ("internvl2-1b", "prefill"), ("gemma3-27b", "prefill"),
    ("mixtral-8x7b", "prefill"), ("recurrentgemma-9b", "prefill")])
def test_dot_flops_equal_the_reference_hlo(arch, kind):
    want = _reference_flops(arch, kind) + _missed_band_steps(arch)
    assert _port_flops(arch, kind) == want


@pytest.mark.parametrize("block", [32, 64, 128])
def test_band_steps_equal_the_reference_with_several_query_blocks(block):
    """gemma3-27b's prefill at S 256 (window 64): with 2-8 query blocks
    the reference's analyzer counts every band step, and the counts are
    equal with no adjustment, the missed step above being the
    single-block loop's."""
    want = _reference_flops("gemma3-27b", "prefill", block=block, S=256)
    got = _port_flops("gemma3-27b", "prefill", seq=256, block_q=block,
                      block_kv=block)
    assert got == want


def _dead_recompute(arch):
    """The dot FLOPs of each unit's last FFN down projection (the dense
    FFN's ``mlp/wd``, an MoE's shared ``moe/shared/wd``) at B x S
    tokens. Its output only joins the residual stream, so the backward
    reads nothing of it: XLA drops it from the reference's recomputed
    forward, and ``models.transformer._Remat`` reruns the unit whole."""
    cfg = reduced(get_config(arch))
    last = f"b{len(cfg.layer_pattern) - 1}"
    flops = 0
    for path, t in tu.flatten(T.init_params(None, cfg, device="meta")):
        if (path[:2] == ("units", last) and path[-1] == "wd"
                and path[-2] in ("mlp", "shared")):
            flops += t.shape[0] * 2 * B * S * t.shape[-2] * t.shape[-1]
    return flops


@pytest.mark.parametrize("arch", ["glm4-9b", "deepseek-v2-236b"])
def test_remat_train_flops_equal_the_reference_plus_dead_recompute(arch):
    """The dry run's own setting (remat on): the reference's count plus
    ``_dead_recompute``, a term of its own (glm4-9b 112,197,632;
    deepseek-v2-236b, whose routed experts' outputs the router's
    gradient reads, 9,961,472: the shared expert's only)."""
    want = _reference_flops(arch, "train", remat=True)
    assert _dead_recompute(arch) > 0
    assert _port_flops(arch, "train", remat=True) == \
        want + _dead_recompute(arch)


@pytest.mark.parametrize("arch", ["gemma3-27b", "mixtral-8x7b",
                                  "recurrentgemma-9b", "glm4-9b"])
def test_dry_run_blocks_count_what_the_default_blocks_count(arch):
    """At S 1024 (two 512-row blocks, one 4096-row block) the dry run's
    blocks count the prefill the ShardCtx default blocks count. 4096-row
    blocks count the same where every block pair is computed (glm4-9b),
    but more on a sliding-window layer, whose band then reads 3 x 1024
    keys where 512-row blocks read 3 x 512: a config with one keeps the
    default."""
    got = _port_flops(arch, "prefill", seq=1024)
    assert got == _port_flops(arch, "prefill", seq=1024, block_q=512,
                              block_kv=512)
    wide = _port_flops(arch, "prefill", seq=1024, block_q=4096,
                       block_kv=4096)
    windowed = "local" in reduced(get_config(arch)).layer_kinds()
    assert (got < wide) if windowed else (got == wide)


@pytest.mark.parametrize("n_chips", [1, 256, 512])
def test_roofline_analytic_terms_equal_the_reference(n_chips):
    for arch in ARCH_IDS:
        cfg = get_config(arch).with_dtype("bfloat16")
        jcfg = jget_config(arch).with_dtype("bfloat16")
        for shape, shp in INPUT_SHAPES.items():
            assert RL.model_flops(cfg, shape) == \
                jRL.model_flops(jcfg, shape), (arch, shape)
            assert RL.hbm_bytes(cfg, shape, n_chips) == \
                jRL.hbm_bytes(jcfg, shape, n_chips), (arch, shape)
            assert RL._cache_bytes(cfg, shp.global_batch, shp.seq_len) == \
                jRL._cache_bytes(jcfg, shp.global_batch, shp.seq_len)


def _whole_work(arch, m):
    """The prefill's dot FLOPs that the plan leaves whole on every rank,
    beyond one device's count, at model extent ``m``:
      * the "expand" head layout (KV < m): each rank computes its kv
        head's k and v projections whole, so m kv heads' worth are
        computed where one device computes KV;
      * MLA's latent projections ``wq_a`` / ``wkv_a`` and the MoE
        router: whole on every rank, m - 1 extra copies."""
    cfg = reduced(get_config(arch))
    tokens, D = B * S, cfg.d_model
    extra = 0
    if cfg.mla is None and head_layout(cfg.n_heads, cfg.n_kv_heads,
                                       m) == "expand":
        extra += (cfg.n_layers * 2 * (m - cfg.n_kv_heads)
                  * 2 * tokens * D * cfg.resolved_head_dim)
    for path, t in tu.flatten(T.init_params(None, cfg, device="meta")):
        if path[-1] in ("wq_a", "wkv_a", "router"):
            n_units = t.shape[0] if path[0] == "units" else 1
            extra += (m - 1) * n_units * 2 * tokens * D * t.shape[-1]
    return extra


@pytest.mark.parametrize("arch,m", [("glm4-9b", 2), ("glm4-9b", 4),
                                    ("deepseek-v2-236b", 2)])
def test_model_ranks_sum_to_one_device_plus_whole_work(arch, m):
    one = _port_flops(arch, "prefill")
    ranks = [_port_flops(arch, "prefill", (1, m), r) for r in range(m)]
    assert sum(ranks) == one + _whole_work(arch, m)
    if _whole_work(arch, m) == 0:
        assert len(set(ranks)) == 1 and ranks[0] * m == one


def _plan_shapes(arch, mesh):
    cfg = jget_config(arch).with_dtype("bfloat16")
    sds = jSP.param_sds(cfg)
    specs = jrules.param_specs(sds, mesh, ("data",))
    out = {}

    def one(path, leaf, spec):
        shape = list(leaf.shape)
        for d, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                shape[d] //= mesh.shape[a]
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = tuple(shape)
    jax.tree_util.tree_map_with_path(
        one, sds, specs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    return out


def _documented(cfg, m):
    """The leaves ``tp_slice`` cuts otherwise than the plan (its
    docstring's "Where this differs from param_specs"), at model ``m``."""
    pats = []
    if cfg.mla is not None:
        pats.append(r"attn/(wq_a|wkv_a)$")
    elif head_layout(cfg.n_heads, cfg.n_kv_heads, m) == "expand":
        pats.append(r"(^|/)attn/(wk|wv|bk|bv)$")
    # (the whisper encoder's attention has the decoder's heads, H = KV)
    for H, KV, where in ((cfg.n_heads, cfg.n_kv_heads, r"(^|/)attn/"),
                         (cfg.n_heads, cfg.n_heads, r"(^|/)xattn/")):
        if KV and head_layout(H, KV, m) == "replicate":
            pats.append(where + r"(wq|wk|wv|wo|bq|bk|bv)$")
    pats.append(r"(^|/)rg/(win|conv)$")
    if cfg.ssm is not None and cfg.ssm.n_heads % m:
        pats.append(r"(^|/)(mx|sx)/")       # held whole: H % m != 0
    return re.compile("|".join(pats))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_param_shapes_are_the_reference_plans(arch):
    mesh = AbstractMesh((16, 16), ("data", "model"))
    want = _plan_shapes(arch, mesh)
    cfg = get_config(arch).with_dtype("bfloat16")
    mine = data_slice_rank(tp_slice_rank(
        T.init_params(None, cfg, device="meta"), cfg, 16, 0),
        cfg, 16, 16, 0)
    got = {"/".join(p): tuple(t.shape) for p, t in tu.flatten(mine)}
    assert set(got) == set(want)
    documented = _documented(cfg, 16)
    differ = sorted(k for k in got if got[k] != want[k])
    assert [k for k in differ if not documented.search(k)] == [], differ
    # the dry run's rank holds exactly these parameters
    res = dryrun.run_pair(arch, "decode_32k")
    n = sum(int(np.prod(s)) for s in got.values())
    assert res["status"] == "OK" and res["params"] == n
    assert res["param_bytes"] == 2 * n


def test_cli_full_width_pair_exits_zero(tmp_path):
    out = tmp_path / "pair.json"
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "glm4-9b", "--shape", "decode_32k", "--json", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    (res,) = json.loads(out.read_text())
    assert res["status"] == "OK" and res["mesh"] == "16x16"
    roof = res["roofline"]
    assert res["counts"]["dot_flops"] > 0 and roof["compute_s"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    # the data axis gathers each unit of the rank's FSDP parts
    assert res["counts"]["collectives"]["data"]["gather"][0] > 0
