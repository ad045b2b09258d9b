"""The port's sharding rules (``repro_torch.parallel.sharding``), ZeRO-1
specs (``repro_torch.train.optim``) and shapes-only trees
(``lm.param_shapes``/``cache_shapes``, ``train_step.state_template``)
against the reference's, on the abstract production meshes (no devices):
every leaf of every configuration, entry for entry. Entries are compared
after JAX's own normalisation of the port's spec (``PartitionSpec(*spec)``
turns ``("data",)`` into ``"data"`` and ``()`` into ``None``), since JAX
0.9 normalises the reference's. Then the reference's own cases
(``tests/test_sharding.py``) as port tests, and real placements on a
(2, 2) mesh of 4 gloo CPU processes (``tests/torch_gloo.py``)."""
import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.configs import get_config as ref_config
from repro.launch.mesh import make_local_mesh as ref_local_mesh
from repro.models import lm as RLM
from repro.parallel import sharding as RSH
from repro.train import optim as RO
from repro.train import train_step as RTS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import (AbstractMesh as PortAbstractMesh,
                                     device_mesh, make_local_mesh, make_mesh,
                                     make_pipeline_mesh, make_production_mesh,
                                     mesh_axes)
from repro_torch.models import lm
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import P
from repro_torch.train import optim as O
from repro_torch.train.train_step import state_template

import torch_gloo


@pytest.fixture(autouse=True)
def _one_thread():
    """Spec functions are host code; one thread keeps the test workers
    from fighting over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract_mesh(sizes, names):
    """AbstractMesh across JAX versions (as tests/test_sharding.py)."""
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return AbstractMesh(tuple(sizes), tuple(names))


MESH = _abstract_mesh((16, 16), ("data", "model"))
MESH3 = _abstract_mesh((2, 16, 16), ("pod", "data", "model"))
PMESH = make_production_mesh()
PMESH3 = make_production_mesh(multi_pod=True)
MESHES = {"16x16": (MESH, PMESH), "2x16x16": (MESH3, PMESH3)}

_REF_PARAMS = {}


def ref_param_shapes(arch):
    if arch not in _REF_PARAMS:
        cfg = ref_config(arch)
        _REF_PARAMS[arch] = jax.eval_shape(
            lambda: RLM.init_params(cfg, jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def ref_leaves(tree):
    """{path: leaf} of a reference tree, keyed by the reference's
    ``_path_str``."""
    return {RSH._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree):
    return {SH._path_str(p): leaf
            for p, leaf in pytree.tree_flatten_with_path(tree)[0]}


def same_spec(port_spec, ref_spec) -> bool:
    return tuple(JP(*port_spec)) == tuple(ref_spec)


def _spec_diffs(port_tree, ref_tree):
    """Leaves whose specs differ between two trees of shardings."""
    want = ref_leaves(ref_tree)
    got = port_leaves(port_tree)
    assert sorted(got) == sorted(want)
    return [(k, got[k].spec, want[k].spec) for k in want
            if not same_spec(got[k].spec, want[k].spec)]


# ------------------------------------------------------------------ meshes
def test_production_meshes_are_abstract_with_the_reference_axes():
    assert (PMESH.axis_names, PMESH.axis_sizes) == \
        (MESH.axis_names, MESH.axis_sizes)
    assert (PMESH3.axis_names, PMESH3.axis_sizes) == \
        (MESH3.axis_names, MESH3.axis_sizes)
    assert isinstance(PMESH, PortAbstractMesh) and PMESH.size == 256
    assert dict(make_mesh((2, 4), ("data", "model")).shape) == \
        {"data": 2, "model": 4}
    pm = make_pipeline_mesh(3, device="cpu")
    assert mesh_axes(pm) == {"stage": 3}
    assert pm.devices == (torch.device("cpu"),) * 3
    assert make_local_mesh(device="cpu").shape == {"data": 1, "model": 1}


def test_device_mesh_raises_without_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        device_mesh(make_mesh((2, 2), ("data", "model")))


# ----------------------------------------------------------- shapes only
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_equal_reference_eval_shape(arch):
    got = port_leaves(lm.param_shapes(get_config(arch)))
    want = ref_leaves(ref_param_shapes(arch))
    assert sorted(got) == sorted(want)
    for k, leaf in want.items():
        t = got[k]
        assert t.device.type == "meta", k
        assert (tuple(t.shape), _dtype(t.dtype)) == \
            (tuple(leaf.shape), _dtype(leaf.dtype)), k


def test_path_str_of_torch_key_paths():
    from repro_torch.models.attention import KVCache
    tree = {"seg0": {"attn": {"wq": torch.zeros(1)}},
            "cache": KVCache(torch.zeros(1), torch.zeros(1)),
            "xs": [torch.zeros(1)]}
    got = sorted(port_leaves(tree))
    assert got == ["cache/k", "cache/v", "seg0/attn/wq", "xs/0"]


# ------------------------------------------------------------ spec parity
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch):
    shapes = lm.param_shapes(get_config(arch))
    sds = ref_param_shapes(arch)
    for name, (rmesh, pmesh) in MESHES.items():
        for fsdp in (False, True):
            for hd in (False, True):
                got = SH.param_shardings(shapes, pmesh, fsdp=fsdp,
                                         hd_shard=hd)
                want = RSH.param_shardings(sds, rmesh, fsdp=fsdp,
                                           hd_shard=hd)
                assert _spec_diffs(got, want) == [], (name, fsdp, hd)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_match_reference(arch):
    for B, S in ((128, 32768), (2, 1000)):
        cfg, rcfg = get_config(arch), ref_config(arch)
        cache = lm.cache_shapes(cfg, B, S)
        rcache = jax.eval_shape(lambda: RLM.init_cache(rcfg, B, S))
        shapes = {k: (tuple(v.shape), _dtype(v.dtype))
                  for k, v in port_leaves(cache).items()}
        assert shapes == {k: (tuple(v.shape), _dtype(v.dtype))
                          for k, v in ref_leaves(rcache).items()}
        for name, (rmesh, pmesh) in MESHES.items():
            assert _spec_diffs(SH.cache_shardings(cache, pmesh),
                               RSH.cache_shardings(rcache, rmesh)) == [], \
                (B, S, name)


def test_batch_shardings_match_reference():
    for B in (256, 8, 1):
        batch = {"tokens": np.zeros((B, 64), np.int32),
                 "frames": np.zeros((B, 30, 8), np.float32),
                 "patches": np.zeros((B, 4, 6), np.float32)}
        for name, (rmesh, pmesh) in MESHES.items():
            got = SH.batch_shardings(batch, pmesh)
            want = RSH.batch_shardings(batch, rmesh)
            for k in batch:
                assert same_spec(got[k].spec, want[k].spec), (B, name, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_shardings_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    shapes = lm.param_shapes(cfg)
    sds = ref_param_shapes(arch)
    for kind in ("adamw", "adafactor"):
        ocfg = O.OptConfig(kind=kind)
        opt = state_template(cfg, ocfg)["opt"]
        ropt = jax.eval_shape(lambda: RTS.init_state(
            rcfg, RO.OptConfig(kind=kind), jax.random.PRNGKey(0)))["opt"]
        assert {k: tuple(v.shape) for k, v in port_leaves(opt).items()} == \
            {k: tuple(v.shape) for k, v in ref_leaves(ropt).items()}
        for name, (rmesh, pmesh) in MESHES.items():
            for fsdp in (False, True):
                ps = SH.param_shardings(shapes, pmesh, fsdp=fsdp)
                rps = RSH.param_shardings(sds, rmesh, fsdp=fsdp)
                for zero1 in (True, False):
                    got = O.opt_state_shardings(opt, ps, pmesh, zero1=zero1)
                    want = RO.opt_state_shardings(ropt, rps, rmesh,
                                                  zero1=zero1)
                    assert _spec_diffs(got, want) == [], \
                        (kind, name, fsdp, zero1)


def test_zero_spec_matches_reference_on_every_param_leaf():
    for arch in ("deepseek-v3-671b", "zamba2-7b", "whisper-medium"):
        leaves = port_leaves(lm.param_shapes(get_config(arch)))
        for name, (rmesh, pmesh) in MESHES.items():
            for path, t in leaves.items():
                shape = tuple(t.shape)
                for fsdp in (False, True):
                    spec = SH._validate(SH.param_spec(path, shape, pmesh),
                                        shape, pmesh)
                    if fsdp:
                        spec = SH.add_fsdp(spec, shape, pmesh)
                    rspec = JP(*spec)
                    assert same_spec(O.zero_spec(spec, shape, pmesh),
                                     RO.zero_spec(rspec, shape, rmesh)), \
                        (arch, path, name, fsdp)


def test_shard_ctx_rules_match_reference():
    pairs = [(MESH, PMESH), (MESH3, PMESH3),
             (ref_local_mesh(), make_local_mesh(device="cpu"))]
    for rmesh, pmesh in pairs:
        got, want = SH.ShardCtx(pmesh).rules, RSH.ShardCtx(rmesh).rules
        assert sorted(got) == sorted(want)
        for k in want:
            assert same_spec(got[k], want[k]), (k, got[k], want[k])
    # the pipeline mesh has no batch axis: the reference's P((), ...)
    assert SH.ShardCtx(make_pipeline_mesh(2, device="cpu")).rules["bsd"] \
        == P((), None, None)


def test_shard_is_identity_outside_a_context_and_for_plain_tensors():
    x = torch.ones(2, 3, 4)
    assert SH.shard(x, "bsd") is x
    with SH.ShardCtx(PMESH3):
        assert SH.shard(x, "bsd") is x
        assert SH.shard(x, "no-such-kind") is x
    assert lm.NOSHARD(x, "bsd") is x


def test_to_placements_and_spec_order():
    from torch.distributed.tensor import Replicate, Shard
    assert SH.to_placements(P(None, "model"), PMESH3) == \
        (Replicate(), Replicate(), Shard(1))
    assert SH.to_placements(P(("pod", "data"), None, "model"), PMESH3) == \
        (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="order"):
        SH.to_placements(P(("data", "pod")), PMESH3)
    with pytest.raises(ValueError, match="twice"):
        SH.to_placements(P("model", "model"), PMESH3)


# ------------------------------------- the reference's cases (test_sharding)
def spec(path, shape, mesh=PMESH):
    s = SH.param_spec(path, shape, mesh)
    return SH._validate(s, shape, mesh)


def test_embed_vocab_parallel_when_divisible():
    assert spec("embed", (152064, 5120)) == P("model", None)
    assert spec("embed", (51865, 1024)) == P(None, None)


def test_attention_head_sharding_divisibility():
    assert spec("seg0/attn/wq", (32, 6144, 48, 128)) == \
        P(None, None, "model", None)
    assert spec("seg0/attn/wq", (48, 5120, 40, 128)) == \
        P(None, None, None, None)
    assert spec("seg0/attn/wk", (48, 5120, 8, 128)) == \
        P(None, None, None, None)


def test_mlp_and_moe_specs():
    assert spec("seg0/mlp/wi", (48, 5120, 13824)) == P(None, None, "model")
    assert spec("seg0/mlp/wo", (48, 13824, 5120)) == P(None, "model", None)
    assert spec("seg1/moe/wi", (58, 256, 7168, 2048)) == \
        P(None, "model", None, None)
    assert spec("seg1/moe/router", (58, 7168, 256)) == P(None, None, None)


def test_mamba_specs():
    assert spec("seg0/mixer/in_proj", (64, 4096, 16384)) == \
        P(None, None, "model")
    assert spec("seg0/mixer/out_proj", (64, 8192, 4096)) == \
        P(None, "model", None)
    assert spec("seg0/mixer/A_log", (64, 8192, 16)) == P(None, None, None)


def test_cache_spec_kv_vs_seq_sharding():
    s = SH.cache_spec("k", (24, 128, 32768, 16, 64), PMESH)
    assert s == P(None, ("data",), None, "model", None)
    s = SH.cache_spec("k", (48, 128, 32768, 8, 128), PMESH)
    assert s == P(None, ("data",), "model", None, None)
    s = SH.cache_spec("ckv", (61, 128, 32768, 512), PMESH)
    assert s == P(None, ("data",), "model", None)


def test_all_arch_param_shardings_build():
    sizes = PMESH3.shape
    for arch in ("qwen3-14b", "deepseek-v3-671b", "zamba2-7b",
                 "whisper-medium", "falcon-mamba-7b"):
        shapes = lm.param_shapes(get_config(arch))
        shardings = SH.param_shardings(shapes, PMESH3)
        for (path, leaf), sh in zip(pytree.tree_flatten_with_path(shapes)[0],
                                    pytree.tree_leaves(shardings)):
            for e, n in zip(sh.spec, leaf.shape):
                k = 1
                for nm in SH.spec_names(e):
                    k *= sizes[nm]
                assert n % k == 0, (arch, path, leaf.shape, sh.spec)


def test_zero_spec_adds_data_axis():
    assert O.zero_spec(P(None, "model"), (13824, 5120), PMESH) == \
        P("data", "model")
    z = O.zero_spec(P(), (7,), PMESH)
    assert all(e is None for e in z)


def _fraction(leaves, shardings, sizes):
    total = per_dev = 0
    for leaf, sh in zip(leaves, shardings):
        n = int(np.prod(leaf.shape))
        k = 1
        for e in sh.spec:
            for nm in (e if isinstance(e, tuple) else (e,)) \
                    if e is not None else ():
                k *= sizes[nm]
        total += n
        per_dev += n // k
    return per_dev / total


def test_sharded_params_fraction():
    """TP shards the big weights: per-device bytes <= ~1/8 of the total
    for a TP-16 dense model, and the port's fraction is the
    reference's exactly."""
    shapes = lm.param_shapes(get_config("yi-9b"))
    got = _fraction(pytree.tree_leaves(shapes),
                    pytree.tree_leaves(SH.param_shardings(shapes, PMESH)),
                    PMESH.shape)
    sds = ref_param_shapes("yi-9b")
    want = _fraction(jax.tree_util.tree_leaves(sds),
                     jax.tree_util.tree_leaves(RSH.param_shardings(sds, MESH)),
                     dict(zip(MESH.axis_names, MESH.axis_sizes)))
    assert got < 0.15, got
    assert got == want


# ------------------------------------------------- real placements (gloo)
def test_gloo_2x2_placement_local_shards_equal_their_slices():
    """4 CPU processes on a (2, 2) ("data", "model") DeviceMesh: a SMOKE
    model's params placed by ``param_shardings`` (fsdp off and on); every
    rank's local shard equals the slice its spec names."""
    outs = torch_gloo.run_ranks("place", 4, timeout=120)
    specs = outs[0]["specs"]
    cfg = ref_config("qwen3-14b", smoke=True)
    sds = jax.eval_shape(lambda: RLM.init_params(cfg, jax.random.PRNGKey(0)))
    rmesh = _abstract_mesh((2, 2), ("data", "model"))
    for fsdp in (False, True):
        for path, sh in ref_leaves(RSH.param_shardings(
                sds, rmesh, fsdp=fsdp)).items():
            got = [tuple(e) if isinstance(e, list) else e
                   for e in specs[f"{fsdp}:{path}"]]
            assert same_spec(got, sh.spec), (fsdp, path)
    coords = sorted(tuple(o["coord"]) for o in outs)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for o in outs:
        assert o["bad"] == [], o["bad"]
        assert o["leaves"] == len(specs) and o["sharded"] > 0
        assert o["tuple_placements"] == ["S(0)", "S(0)"]
        assert o["tuple_ok"]
        assert o["outside_ctx_identity"] and o["plain_identity"]
        assert o["bsd_placements"] == ["S(0)", "R"] and o["bsd_local_ok"]
    rank3 = next(o for o in outs if o["rank"] == 3)
    assert rank3["tuple_rows"] == [48, 63]
