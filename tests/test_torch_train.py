"""The port's training substrate against the reference's: the counterpart
of each of ``tests/test_train.py``'s 11 functions on the port, and the
port held against ``repro.train`` / ``repro.parallel.compression`` /
``repro.configs.common`` on the same numpy inputs (schedule, int8
quantization, one optimizer step, data, checkpoints both ways, the shape
sets), plus ``launch/train.py`` and ``chip_smoke.rehearse_train`` on the
CPU.

Tolerances, stated with their reasons:

* ``quantize_int8``, ``compress_grads_ef``, ``TokenStream`` and
  checkpoints: equal, bit for bit. The same float32 operations in the same
  order (or numpy's own Philox draws, or stored bytes).
* ``schedule``: within 1e-6 relative (8 float32 ulps) plus 8 ulps of 1
  times ``lr``. The same float32 operations in the same order, but the
  cosine is XLA's own approximation there and another library's here
  (observed up to 5 ulps apart); near the cosine's end, with
  ``min_lr_frac`` 0, ``1 + cos`` cancels, so those ulps of 1 become an
  absolute error of the schedule.
* One optimizer update from the same params and gradients (float32
  states): the float32 states within 4 float32 ulps of their largest
  element (1e-6 relative: the same formula, elementwise, where XLA and
  torch may contract a multiply-add or take ``pow``/``rsqrt`` from other
  libraries), bf16 params within one bf16 ulp of their own magnitude
  (2^-7 relative: a master an ulp apart can round to the neighbour).
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as r_common
from repro.parallel import compression as RC
from repro.train import checkpoint as RCK
from repro.train import data as RD
from repro.train import optim as RO
from repro.train.train_step import init_state as r_init_state
from repro_torch.configs import common as p_common
from repro_torch.configs import get_config
from repro_torch.launch import train as p_launch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.parallel import compression as C
from repro_torch.train import checkpoint as CK
from repro_torch.train import ft
from repro_torch.train import optim as O
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.train_step import (init_state, make_train_step,
                                          state_template)
from repro_torch.train.tree import tree_leaves, tree_paths

import chip_smoke


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------- counterparts of test_train.py
def test_schedule_warmup_and_cosine():
    cfg = O.OptConfig(lr=1.0, warmup=10, total_steps=110, min_lr_frac=0.1)
    assert float(O.schedule(cfg, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(O.schedule(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert abs(float(O.schedule(cfg, torch.tensor(110))) - 0.1) < 1e-6


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, gn = O.clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - 10.0) < 1e-5
    total = torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(clipped)))
    assert abs(float(total) - 1.0) < 1e-5


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_reduces_quadratic(kind):
    cfg = O.OptConfig(kind=kind, lr=0.1, warmup=1, total_steps=200,
                      weight_decay=0.0)
    params = {"w": torch.tensor([[5.0, -3.0], [2.0, 8.0]])}
    state = O.opt_init(cfg, params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = O.opt_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1.0


def test_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    eb = torch.zeros_like(g)
    acc_q = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(50):
        (q,), (eb,) = C.compress_grads_ef((g,), (eb,))
        acc_q = acc_q + q
        acc = acc + g
    rel = float(torch.linalg.norm(acc_q - acc) / torch.linalg.norm(acc))
    assert rel < 0.02


def test_quantize_roundtrip_bounded():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(777)
                         .astype(np.float32))
    q, s = C.quantize_int8(x)
    y = C.dequantize_int8(q, s, x.shape)
    assert float((x - y).abs().max()) <= float(s.max()) * 0.51 + 1e-6


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("yi-9b", smoke=True)
    ocfg = O.OptConfig()
    state = init_state(cfg, ocfg, _gen())
    CK.save(str(tmp_path), 7, state)
    restored, step = CK.restore(str(tmp_path), state_template(cfg, ocfg),
                                device="cpu")
    assert step == 7
    for (ka, a), (kb, b) in zip(tree_paths(state), tree_paths(restored)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka


def test_checkpoint_keep_k(tmp_path):
    state = {"x": torch.zeros((3,))}
    for s in (1, 2, 3, 4, 5):
        CK.save(str(tmp_path), s, state, keep=2)
    assert CK.latest_step(str(tmp_path)) == 5
    dirs = sorted(os.listdir(tmp_path))
    assert len([d for d in dirs if d.startswith("step_")]) == 2


def test_checkpoint_async_write_is_not_torn(tmp_path, monkeypatch):
    """An async save writes the state as it was at the call, though the
    caller updates the state's tensors in place (as the optimizer does)
    before the writer thread serializes them: the writer is held until the
    update is done. Restored tensors equal, bit for bit, the saved ones."""
    cfg = get_config("yi-9b", smoke=True)
    ocfg = O.OptConfig()
    state = init_state(cfg, ocfg, _gen())
    at_save = {k: t.clone() for k, t in tree_paths(state)}
    go, savez = threading.Event(), np.savez

    def held(*a, **kw):
        assert go.wait(60)
        return savez(*a, **kw)

    monkeypatch.setattr(np, "savez", held)
    writer = CK.save(str(tmp_path), 3, state, async_=True)
    with torch.no_grad():
        for t in tree_leaves(state):
            t.add_(1)
    go.set()
    writer.join()
    monkeypatch.undo()
    back, step = CK.restore(str(tmp_path), state_template(cfg, ocfg),
                            device="cpu")
    assert step == 3
    for k, t in tree_paths(back):
        assert torch.equal(t, at_save[k]), k


def test_data_deterministic_and_seekable():
    dc = DataConfig(vocab=1000, global_batch=8, seq_len=64, seed=3)
    s1, s2 = TokenStream(dc), TokenStream(dc)
    assert (s1.batch_at(17)["tokens"] == s2.batch_at(17)["tokens"]).all()
    full = s1.batch_at(5)["tokens"]
    for n_shards in (2, 4, 8):
        parts = [s1.shard_batch_at(5, i, n_shards)["tokens"]
                 for i in range(n_shards)]
        assert (np.concatenate(parts) == full).all()


def test_run_with_restarts_recovers(tmp_path):
    """Injected failure -> restore from checkpoint -> finish all steps."""
    cfg = get_config("yi-9b", smoke=True)
    ocfg = O.OptConfig(lr=1e-3, warmup=2, total_steps=12)
    data = TokenStream(DataConfig(vocab=cfg.vocab, global_batch=2,
                                  seq_len=16, seed=0), cfg)
    step_fn = make_train_step(cfg, ocfg)
    box = {}
    plan = ft.FailurePlan({6: "injected-node-loss"})

    def make_runner(start):
        if CK.latest_step(str(tmp_path)) is not None:
            box["state"], _ = CK.restore(str(tmp_path),
                                         state_template(cfg, ocfg),
                                         device="cpu")
        else:
            box["state"] = init_state(cfg, ocfg, _gen())

        def run(step):
            plan.check(step)
            b = {k: torch.from_numpy(v)
                 for k, v in data.batch_at(step).items()}
            box["state"], m = step_fn(box["state"], b)
            return float(m["loss"])
        return run

    log = ft.run_with_restarts(
        12, make_runner, save_every=4,
        saver=lambda s: CK.save(str(tmp_path), s, box["state"]),
        restorer=lambda: CK.latest_step(str(tmp_path)) or 0)
    assert len(log["restarts"]) == 1
    assert max(log["losses"]) > 0
    assert sorted(log["losses"])[-1] == 11


def test_watchdog_flags_straggler():
    wd = ft.Watchdog(window=16, z_thresh=4.0)
    for i in range(20):
        wd.observe(i, 1.0 + 0.01 * (i % 3))
    assert wd.observe(20, 5.0)
    assert wd.stragglers[-1]["step"] == 20


# (test_microbatch_accumulation_matches_full_batch's counterpart is in
# tests/test_torch_train_step.py, beside the other train-step tests.)


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("warmup,total,lr,min_frac", [
    (10, 110, 1.0, 0.1), (20, 12, 1e-3, 0.1), (1, 50, 3e-4, 0.0),
    (100, 10_000, 3e-4, 0.1)])
def test_schedule_equals_reference(warmup, total, lr, min_frac):
    kw = dict(lr=lr, warmup=warmup, total_steps=total, min_lr_frac=min_frac)
    rc, pc = RO.OptConfig(**kw), O.OptConfig(**kw)
    steps = sorted(set(range(0, total + 5, max(1, total // 97))))
    for s in steps:
        want = np.float32(RO.schedule(rc, jnp.int32(s)))
        got = O.schedule(pc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        tol = 1e-6 * abs(float(want)) + 8 * 2.0 ** -24 * lr
        assert abs(got.item() - float(want)) <= tol, (s, got.item(), want)


@pytest.mark.parametrize("n", [1, 255, 256, 777, 4096 + 3])
def test_quantize_int8_bit_equal_to_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 100)).astype(np.float32)
    x[: n // 7] = 0.0                           # an all-zero block too
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    pq, ps = C.quantize_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert np.array_equal(pq.numpy(), np.asarray(rq))
    assert np.array_equal(ps.numpy().view(np.uint32),
                          np.asarray(rs).view(np.uint32))
    rd = RC.dequantize_int8(rq, rs, (n,))
    pd = C.dequantize_int8(pq, ps, (n,))
    assert np.array_equal(pd.numpy().view(np.uint32),
                          np.asarray(rd).view(np.uint32))


def test_compress_grads_ef_bit_equal_to_reference():
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((3, 100)).astype(np.float32),
         "b": {"c": rng.standard_normal(300).astype(np.float32)}}
    e = {"a": rng.standard_normal((3, 100)).astype(np.float32) * 1e-3,
         "b": {"c": rng.standard_normal(300).astype(np.float32) * 1e-3}}
    rg, re_ = RC.compress_grads_ef(jax.tree_util.tree_map(jnp.asarray, g),
                                   jax.tree_util.tree_map(jnp.asarray, e))
    pg, pe = C.compress_grads_ef(params_from_numpy(g, "cpu"),
                                 params_from_numpy(e, "cpu"))
    for want, got in ((rg, pg), (re_, pe)):
        for (kw_, w), (kg, t) in zip(tree_paths(jax.device_get(want)),
                                     tree_paths(got)):
            assert kw_ == kg
            assert np.array_equal(t.numpy().view(np.uint32),
                                  np.asarray(w).view(np.uint32)), kg


def _opt_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 40), "stack": (2, 8, 24), "bias": (24,)}
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g["w"][0, :5] = 0.0                      # zero gradients
    g["w"][1, :5] = 1e-12                    # and tiny ones
    if dtype == "bfloat16":
        import ml_dtypes
        p = {k: v.astype(ml_dtypes.bfloat16) for k, v in p.items()}
        g = {k: v.astype(ml_dtypes.bfloat16) for k, v in g.items()}
    return p, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(kind, dtype):
    """Two updates from the same params and gradients: every state tensor
    and the params as the reference's (module docstring's bounds)."""
    p, g = _opt_inputs(dtype)
    kw = dict(kind=kind, lr=1e-2, warmup=1, total_steps=10, clip_norm=5.0)
    rcfg, pcfg = RO.OptConfig(**kw), O.OptConfig(**kw)
    rp = jax.tree_util.tree_map(jnp.asarray, p)
    rs = RO.opt_init(rcfg, rp)
    pp = params_from_numpy(p, "cpu")
    ps = O.opt_init(pcfg, pp)
    for _ in range(2):
        rp, rs, rm = RO.opt_update(rcfg, rp, jax.tree_util.tree_map(
            jnp.asarray, g), rs)
        pp, ps, pm = O.opt_update(pcfg, pp, params_from_numpy(g, "cpu"), ps)
        assert abs(float(pm["lr"]) - float(rm["lr"])) \
            <= 1e-6 * float(rm["lr"])
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) \
            <= 1e-6 * float(rm["grad_norm"])
    want = dict(tree_paths(jax.device_get({"params": rp, "opt": rs})))
    for key, t in tree_paths({"params": pp, "opt": ps}):
        w = np.asarray(want[key], np.float32)
        got = t.float().numpy()
        assert got.shape == w.shape, key
        if key == "opt/step":
            assert int(t) == int(w) == 2
        elif key.startswith("params") and dtype == "bfloat16":
            assert (np.abs(got - w) <= 2.0 ** -7 * np.abs(w)).all(), key
        else:
            err = np.abs(got - w).max()
            assert err <= 1e-6 * max(np.abs(w).max(), 1e-30), (key, err)


def test_token_stream_bit_equal_to_reference():
    for model in (None, "yi-9b", "paligemma-3b", "whisper-medium"):
        kw = dict(vocab=64_000, global_batch=8, seq_len=200, seed=5)
        rmc = None if model is None else r_get_config(model, smoke=True)
        pmc = None if model is None else get_config(model, smoke=True)
        rs = RD.TokenStream(RD.DataConfig(**kw), rmc)
        ps = TokenStream(DataConfig(**kw), pmc)
        for step in (0, 3, 1000):
            want, got = rs.batch_at(step), ps.batch_at(step)
            assert sorted(want) == sorted(got)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (model, step, k)
            for n in (2, 4):
                for i in range(n):
                    w = rs.shard_batch_at(step, i, n)
                    g = ps.shard_batch_at(step, i, n)
                    assert all(np.array_equal(g[k], w[k]) for k in w)


def r_get_config(arch, **kw):
    from repro.configs import get_config as rg
    return rg(arch, **kw)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_restores_in_the_other_package(tmp_path, direction):
    """A checkpoint either package writes restores in the other, onto the
    other's own template (``jax.eval_shape`` there, the meta device here),
    to equal arrays: the same keys, bf16 stored as float32."""
    arch = "yi-9b"
    rcfg, pcfg = r_get_config(arch, smoke=True), get_config(arch, smoke=True)
    ro, po = RO.OptConfig(), O.OptConfig()
    if direction == "port_to_reference":
        state = init_state(pcfg, po, _gen(3))
        state["opt"]["step"] += 5
        CK.save(str(tmp_path), 5, state)
        template = jax.eval_shape(lambda: r_init_state(
            rcfg, ro, jax.random.PRNGKey(0)))
        back, step = RCK.restore(str(tmp_path), template)
        want = params_to_numpy(state)
        got = jax.device_get(back)
    else:
        state = jax.device_get(r_init_state(rcfg, ro, jax.random.PRNGKey(3)))
        RCK.save(str(tmp_path), 5, state)
        back, step = CK.restore(str(tmp_path), state_template(pcfg, po),
                                device="cpu")
        want = state
        got = params_to_numpy(back)
    assert step == 5
    wl, gl = dict(tree_paths(want)), dict(tree_paths(got))
    assert sorted(wl) == sorted(gl)
    for k in wl:
        w, g = np.atleast_1d(wl[k]), np.atleast_1d(gl[k])
        assert w.dtype == g.dtype and w.shape == g.shape, k
        assert np.array_equal(w.view(np.uint8), g.view(np.uint8)), k


def test_state_converts_both_ways_bit_for_bit():
    """``models.convert`` carries a whole train state (AdamW and
    Adafactor, with ``error_fb`` and the int32 step) across and back."""
    rcfg = r_get_config("yi-9b", smoke=True)
    for kind in ("adamw", "adafactor"):
        st = jax.device_get(r_init_state(rcfg, RO.OptConfig(kind=kind),
                                         jax.random.PRNGKey(1)))
        st["error_fb"] = jax.device_get(jax.tree_util.tree_map(
            lambda p: jnp.ones(p.shape, jnp.float32), st["params"]))
        port = params_from_numpy(st, "cpu")
        assert port["opt"]["step"].dtype == torch.int32
        assert port["opt"]["step"].shape == ()
        back = params_to_numpy(port)
        la, ta = jax.tree_util.tree_flatten(st)
        lb, tb = jax.tree_util.tree_flatten(back)
        assert ta == tb
        for a, b in zip(la, lb):
            a, b = np.atleast_1d(a), np.atleast_1d(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_state_template_is_meta_and_matches_init_state():
    cfg = get_config("yi-9b")                  # full size: nothing allocated
    for kind in ("adamw", "adafactor"):
        ocfg = O.OptConfig(kind=kind)
        tpl = state_template(cfg, ocfg)
        assert all(t.device.type == "meta" for t in tree_leaves(tpl))
        small = get_config("yi-9b", smoke=True)
        a = {k: (tuple(t.shape), t.dtype)
             for k, t in tree_paths(state_template(small, ocfg))}
        b = {k: (tuple(t.shape), t.dtype)
             for k, t in tree_paths(init_state(small, ocfg, _gen()))}
        assert a == b
    n = sum(t.numel() for t in tree_leaves(tpl["params"]))
    assert abs(n - 8.83e9) < 0.01e9


def test_shape_sets_match_reference():
    assert [dataclasses.astuple(s) for s in p_common.SHAPES.values()] == \
        [dataclasses.astuple(s) for s in r_common.SHAPES.values()]
    for arch in ("yi-9b", "paligemma-3b", "whisper-medium",
                 "falcon-mamba-7b"):
        pc, rc = get_config(arch), r_get_config(arch)
        for shape in p_common.SHAPES:
            assert p_common.applicable(pc, shape) == \
                r_common.applicable(rc, shape)
            want = r_common.input_specs(rc, shape)
            got = p_common.input_specs(pc, shape)
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(w.shape), (arch, k)
                assert str(got[k].dtype) == "torch." + str(w.dtype)


def test_smoke_batch_is_seeded_and_shaped():
    for arch in ("yi-9b", "paligemma-3b", "whisper-medium"):
        cfg = get_config(arch, smoke=True)
        a = p_common.smoke_batch(cfg, B=2, S=24, seed=3, device="cpu")
        b = p_common.smoke_batch(cfg, B=2, S=24, seed=3, device="cpu")
        want = r_common.smoke_batch(r_get_config(arch, smoke=True), B=2,
                                    S=24)
        assert sorted(a) == sorted(want)
        for k in a:
            assert torch.equal(a[k], b[k])
            assert tuple(a[k].shape) == tuple(want[k].shape)
            assert str(a[k].dtype) == "torch." + str(want[k].dtype)
        assert int(a["tokens"].min()) >= 0
        assert int(a["tokens"].max()) < cfg.vocab


def test_local_mesh_names_the_reference_axes():
    mesh = make_local_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            make_local_mesh()


# ------------------------------------------------- the loop and the CLI
def test_train_loop_restarts_once_and_learns(tmp_path):
    cfg = get_config("yi-9b", smoke=True)
    out = p_launch.train_loop(cfg, 30, 4, 32, ckpt_dir=str(tmp_path),
                              save_every=5, inject_failure=13,
                              mesh=make_local_mesh(device="cpu"),
                              log_every=10 ** 9, n_micro=2, compress=True)
    assert len(out["restarts"]) == 1 and out["restarts"][0]["step"] == 13
    ls = [out["losses"][s] for s in range(30)]
    assert all(np.isfinite(ls))
    assert np.mean(ls[-5:]) < np.mean(ls[:5]) - 0.3, ls
    assert CK.latest_step(str(tmp_path)) == 30
    assert "error_fb" in out["state"]


def test_train_cli_on_the_cpu(tmp_path, capsys):
    p_launch.main(["--arch", "yi-9b", "--smoke", "--steps", "12",
                   "--batch", "2", "--seq", "32", "--ckpt", str(tmp_path),
                   "--save-every", "4", "--inject-failure", "5",
                   "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(last) == ["first5_loss", "last5_loss", "restarts",
                            "wall_s"]
    assert last["restarts"] == 1
    assert last["last5_loss"] < last["first5_loss"]


def test_rehearse_train():
    """``chip_smoke.py``'s train phase on the CPU: the loss falls, the
    CPU side of the card-vs-CPU step runs, one restart with the
    uninterrupted run's losses, the saved state restored equal."""
    out = chip_smoke.rehearse_train()
    assert out["restart"]["restored_equal"]
    assert out["restart"]["max_loss_rel_diff"] <= 1e-3
    assert len(out["restart"]["restarts"]) == 1
