"""Dry run at production scale: trace every (arch x shape x mesh) cell on
DTensors of fake tensors over a fake process group of 256 or 512 ranks —
the port's counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for 512 host devices with
ShapeDtypeStructs. Here params, optimizer state, batch and caches are
DTensors whose local shards are fake tensors (shapes, no storage) placed
by ``parallel.sharding``'s specs on a ``DeviceMesh`` of a ``"fake"``
process group (``FakeStore``: every collective returns at once). The
step runs eagerly on them: forward, backward and the optimizer update for
training (``make_train_step(..., shard=SH.shard)``), ``lm.prefill`` or
``lm.decode_step`` for serving, every activation placed by ``shard`` as
the reference places it. Nothing is allocated and no kernel launches;
K5's op is traced through its fake (its device is the card's unless
``--device cpu`` is asked for). :class:`cost_analysis.CostCounter` counts
the per-device FLOPs, traffic, collectives and live bytes, and the
roofline is made from the H100's datasheet numbers.

The record has the reference's fields; ``lower_s`` is the time to build
and place the state, ``compile_s`` the trace's (no XLA, so no
``xla_cost_flops_pd_loop_once``). A cell that cannot trace (DTensor has
no sharding rule for an op) records ``status="error"`` and the op. The
process group is made and destroyed by each invocation of
:func:`run_cell`.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \
      --mesh single
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \
      --device cpu --out out/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

from ..configs import ARCH_IDS, get_config
from ..configs.common import SHAPES, ShapeSpec, applicable, input_specs
from ..models import lm
from ..models.config import ModelConfig
from ..parallel import sharding as SH
from ..parallel.dtensor import Reshard
from ..train import optim as O
from ..train.train_step import make_train_step, state_template
from ..train.tree import tree_map
from . import cost_analysis as CA
from .mesh import device_mesh, make_production_mesh

__all__ = ["opt_for", "train_remat", "model_flops", "fake_group",
           "place_tree", "build_cell", "trace_cell",
           "optimized_profile", "run_cell", "main"]


def opt_for(cfg: ModelConfig) -> O.OptConfig:
    # the 671B fits 512 chips only with factored second moments
    total, _ = cfg.param_count()
    kind = "adafactor" if total > 100e9 else "adamw"
    return O.OptConfig(kind=kind)


def train_remat(cfg: ModelConfig) -> str:
    return "full"        # baseline policy


def _spec(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def model_flops(cfg: ModelConfig, shape) -> float:
    sp = _spec(shape)
    total, active = cfg.param_count()
    D = sp.seq_len * sp.global_batch
    if sp.kind == "train":
        return 6.0 * active * D
    if sp.kind == "prefill":
        return 2.0 * active * D
    return 2.0 * active * sp.global_batch      # one token per sequence


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks on a
    ``FakeStore`` (this process is rank ``rank``; collectives return at
    once), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=rank, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def place_tree(meta_tree, shardings, dmesh, device):
    """:func:`parallel.sharding.place` over a tree of meta tensors."""
    return tree_map(lambda m, s: SH.place(m, s, dmesh, device), meta_tree,
                    shardings)


def build_cell(cfg: ModelConfig, shape, amesh, dmesh, device,
               fsdp: bool = False, n_micro: int = 1,
               hd_shard: bool = False):
    """Returns (fn, args): the cell's step and its DTensor arguments on
    ``dmesh`` (call under ``FakeTensorMode`` for a dry run). ``shape`` a
    name of ``SHAPES`` or a ``ShapeSpec``."""
    sp = _spec(shape)
    specs = input_specs(cfg, sp)
    shard = SH.shard
    placed = lambda meta, sh: place_tree(meta, sh, dmesh, device)

    if sp.kind == "train":
        ocfg = opt_for(cfg)
        if cfg.remat == "none":          # caller may have set a policy
            cfg = dataclasses.replace(cfg, remat=train_remat(cfg))
        tmpl = state_template(cfg, ocfg)
        pshard = SH.param_shardings(tmpl["params"], amesh, fsdp=fsdp)
        oshard = O.opt_state_shardings(tmpl["opt"], pshard, amesh)
        state = {"params": placed(tmpl["params"], pshard),
                 "opt": {k: placed(tmpl["opt"][k], oshard[k])
                         for k in tmpl["opt"]}}
        batch = placed(specs, SH.batch_shardings(specs, amesh))
        step = make_train_step(cfg, ocfg, shard=shard, n_micro=n_micro)
        return step, (state, batch)

    pmeta = lm.param_shapes(cfg)
    pshard = SH.param_shardings(pmeta, amesh, fsdp=False, hd_shard=hd_shard)
    params = placed(pmeta, pshard)
    if sp.kind == "prefill":
        batch = placed(specs, SH.batch_shardings(specs, amesh))
        cache_len = sp.seq_len + 128     # room to decode after prefill
        fn = lambda params, batch: lm.prefill(params, cfg, batch, cache_len,
                                              shard)
        return fn, (params, batch)

    # decode: one token against a full cache
    B, S = sp.global_batch, sp.seq_len
    cmeta = lm.cache_shapes(cfg, B, S)
    cache = placed(cmeta, SH.cache_shardings(cmeta, amesh))
    ba = SH.batch_axes(amesh)
    dpp = SH.axis_size(amesh, *ba)
    tshard = SH.NamedSharding(amesh, SH.P(ba if B % dpp == 0 else None))
    tok = SH.place(specs["tokens"], tshard, dmesh, device)
    pos = SH.place(specs["pos"], tshard, dmesh, device)
    fn = lambda params, tok, pos, cache: lm.decode_step(
        params, cfg, tok, pos, cache, shard)
    return fn, (params, tok, pos, cache)


def trace_cell(fn, args, amesh):
    """Run ``fn(*args)`` on DTensors under the cell's ``ShardCtx``, a
    :class:`cost_analysis.CostCounter` and ``parallel.dtensor.Reshard``
    (inside the counter, so the reshards' collectives count); returns
    (counter, reshard counts, result)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with SH.ShardCtx(amesh), implicit_replication(), \
            CA.CostCounter(args) as counter, \
            Reshard() as reshard:
        out = fn(*args)
    return counter, reshard.counts, out


def optimized_profile(arch: str, shape: str) -> Dict:
    """The §Perf-winning settings per family (EXPERIMENTS.md):
    FSDP for all training; cumsum scan for mamba1; dots-remat for SSM
    (NOT for MoE — saves the one-hot einsum outputs); head-dim sharding
    for decode of non-divisible-head archs."""
    cfg = get_config(arch)
    kind = SHAPES[shape].kind
    prof: Dict = {}
    if kind == "train":
        prof["fsdp"] = True
        if cfg.family == "ssm" and cfg.ssm_version == 1:
            prof["ssm_scan"] = "cumsum"
        if cfg.family in ("ssm", "hybrid"):
            prof["remat"] = "dots"
    if kind == "decode" and cfg.n_heads % 16 != 0 and cfg.hd % 16 == 0:
        prof["hd_shard"] = True
    return prof


def _failed_op(e: BaseException) -> str:
    """The op DTensor could not place, as its message names it (``aten.*``
    or ``Sharding propagation failed for ...``), else the exception's
    first line."""
    msg = str(e)
    for line in msg.splitlines():
        if "propagation failed for" in line or "Operator " in line:
            return line.strip()[:300]
    return msg.splitlines()[0][:300] if msg else type(e).__name__


def run_cell(arch: str, shape: str, mesh_kind: str, fsdp: bool = False,
             n_micro: int = 1, moe_impl: Optional[str] = None,
             remat: Optional[str] = None, hd_shard: bool = False,
             ssm_scan: Optional[str] = None,
             profile: Optional[str] = None, device: str = "cuda",
             cfg: Optional[ModelConfig] = None, amesh=None,
             shape_override: Optional[Dict] = None) -> Dict:
    """One cell's record. ``cfg``, ``amesh`` and ``shape_override``
    (``ShapeSpec`` fields) override the arch's config, the production
    mesh and the shape's sizes (a smaller cell of the same code)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if profile == "optimized":
        prof = optimized_profile(arch, shape)
        fsdp = prof.get("fsdp", fsdp)
        remat = prof.get("remat", remat)
        hd_shard = prof.get("hd_shard", hd_shard)
        ssm_scan = prof.get("ssm_scan", ssm_scan)
    cfg = cfg or get_config(arch)
    if moe_impl and cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    if ssm_scan:
        cfg = dataclasses.replace(cfg, ssm_scan=ssm_scan)
    ok, why = applicable(cfg, shape)
    rec: Dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                 "n_micro": n_micro, "moe_impl": cfg.moe_impl}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    sp = dataclasses.replace(SHAPES[shape], **(shape_override or {}))
    if amesh is None:
        amesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = math.prod(amesh.axis_sizes)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    with fake_group(n_chips):
        dmesh = device_mesh(amesh, device)       # its rank tensor is real
        t0 = time.time()
        try:
            with FakeTensorMode():
                fn, args = build_cell(cfg, sp, amesh, dmesh, device,
                                      fsdp=fsdp, n_micro=n_micro,
                                      hd_shard=hd_shard)
                t_lower = time.time() - t0
                counter, reshards, out = trace_cell(fn, args, amesh)
                t_trace = time.time() - t0 - t_lower
                st = counter.analysis()
                mem = counter.memory(out)
        except Exception as e:
            last = traceback.extract_tb(e.__traceback__)[-1]
            rec.update(status="error", error=f"{type(e).__name__}: "
                       f"{_failed_op(e)} (at {os.path.basename(last.filename)}"
                       f":{last.lineno} {last.name})",
                       trace=traceback.format_exc()[-2000:])
            return rec
    flops_pd = float(st["flops"])
    bytes_pd = float(st["traffic_bytes"])
    colls = st["collectives"]
    wire_pd = sum(d["wire_bytes"] for d in colls.values())
    mf = model_flops(cfg, sp)
    roof = CA.roofline(flops_pd, bytes_pd, wire_pd, mf, n_chips)
    rec.update(
        status="ok", n_chips=n_chips,
        lower_s=round(t_lower, 1), compile_s=round(t_trace, 1),
        flops_per_device=flops_pd, bytes_per_device=bytes_pd,
        collectives={k: {kk: (int(vv) if kk == "count" else float(vv))
                         for kk, vv in v.items()}
                     for k, v in colls.items()},
        collective_wire_bytes_pd=wire_pd,
        top_traffic=st["top_traffic"][:8],
        top_flops=st["top_flops"][:6],
        top_collectives=st["top_collectives"][:6], reshards=reshards,
        peak_by_tag=st["peak_by_tag"][:8],
        memory_analysis=mem, roofline=roof,
        params_total=cfg.param_count()[0],
        params_active=cfg.param_count()[1],
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--fsdp", type=int, default=0)
    ap.add_argument("--hd-shard", type=int, default=0)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--profile", default=None,
                    choices=[None, "baseline", "optimized"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (the trace takes its "
                         "branches); cpu where torch has no CUDA")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    recs = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                r = run_cell(a, s, m, fsdp=bool(args.fsdp),
                             n_micro=args.n_micro, moe_impl=args.moe_impl,
                             remat=args.remat, hd_shard=bool(args.hd_shard),
                             profile=args.profile, device=args.device)
                recs.append(r)
                line = {k: v for k, v in r.items()
                        if k not in ("trace", "collectives", "top_traffic",
                                     "top_flops", "memory_analysis",
                                     "top_collectives", "peak_by_tag")}
                print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return recs


if __name__ == "__main__":
    main()
