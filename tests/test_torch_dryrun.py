"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_pipeline``,
``report``) against the reference's pure functions and table renderer,
against ``parallel.sharding``'s spec arithmetic, and a DTensor train step
over a real 4-rank gloo mesh against the one-process step and against
the fake-group dry run's collectives; ``shard`` is the identity on plain
tensors through ``forward``, ``prefill`` and ``decode_step``.

The reference's dry run cannot run here (``make_local_mesh``'s Explicit
axes), so its ``run_cell`` is never compared; its module sets
``XLA_FLAGS`` for 512 host devices when imported, so it is imported only
in a subprocess. Fake-group and gloo runs are processes of
``tests/torch_gloo.py``, each under its own timeout."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.common import SHAPES, applicable, smoke_batch
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as R
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.parallel import sharding as SH
from repro_torch.train import optim as O
from repro_torch.train.train_step import state_template

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gloo  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = """
import json
from repro.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro.launch import dryrun as D
out = {}
for a in ARCH_IDS:
    cfg = get_config(a)
    for s in SHAPES:
        ok, why = applicable(cfg, s)
        out[a + "|" + s] = {"model_flops": D.model_flops(cfg, s),
                            "opt": D.opt_for(cfg).kind,
                            "remat": D.train_remat(cfg),
                            "profile": D.optimized_profile(a, s),
                            "applicable": [ok, why]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_functions():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pure_functions_equal_the_reference(arch, reference_functions):
    cfg = get_config(arch)
    for s in SHAPES:
        ref = reference_functions[f"{arch}|{s}"]
        assert D.model_flops(cfg, s) == ref["model_flops"], s
        assert D.opt_for(cfg).kind == ref["opt"]
        assert D.train_remat(cfg) == ref["remat"]
        assert D.optimized_profile(arch, s) == ref["profile"], s
        assert list(applicable(cfg, s)) == ref["applicable"], s


# ------------------------------------------------------------------- report
def _records():
    roof = {"compute_s": 0.342, "memory_s": 3.87, "collective_s": 7.84,
            "dominant": "collective", "bound_step_s": 7.84,
            "useful_flop_ratio": 0.6413, "mfu_bound": 0.02798}
    ok = {"arch": "yi-9b", "shape": "train_4k", "status": "ok",
          "compile_s": 70.33, "roofline": roof,
          "memory_analysis": {"argument_size_in_bytes": 648596996,
                              "temp_size_in_bytes": 43286292496}}
    small = dict(ok, shape="decode_32k", compile_s=1.31,
                 roofline=dict(roof, compute_s=1.2e-5, memory_s=0.00031,
                               collective_s=12345.0, mfu_bound=0.0))
    err = {"arch": "falcon-mamba-7b", "shape": "prefill_32k",
           "status": "error", "error": "RuntimeError: Operator aten.bmm."
           "default failed on placements [(Replicate(), Replicate())]"}
    skip = {"arch": "yi-9b", "shape": "long_500k", "status": "skipped",
            "reason": "full-attention arch"}
    perf = [{"iter": 0, "status": "ok", "roofline": roof},
            {"iter": 1, "status": "error", "error": "boom"}]
    return [ok, small, err, skip], [ok, err], perf


@pytest.mark.parametrize("with_perf", [False, True])
def test_report_markdown_equals_the_reference(with_perf, tmp_path,
                                              monkeypatch, capsys):
    from repro.launch import report as ref_report
    single, multi, perf = _records()
    perf = perf if with_perf else []
    out = tmp_path / "out"
    out.mkdir()
    (out / "dryrun_single.json").write_text(json.dumps(single))
    (out / "dryrun_multi.json").write_text(json.dumps(multi))
    if perf:
        (out / "perf_iters.jsonl").write_text(
            "\n".join(json.dumps(r) for r in perf) + "\n")
    monkeypatch.chdir(tmp_path)
    ref_report.main()
    want = capsys.readouterr().out
    R.main([])
    got = capsys.readouterr().out
    assert got.splitlines()[0] == \
        "<!-- generated by repro_torch.launch.report -->"
    assert got.split("\n", 1)[1] == want.split("\n", 1)[1]
    assert R.render(single, multi, perf) == want.split("\n", 1)[1]


# ------------------------------------------------------- per-device bytes
def _spec_bytes(tree, shardings, mesh) -> int:
    """Bytes a device holds of ``tree`` placed by ``shardings``: each
    leaf's size over the axes its spec names (``chip_smoke.py``'s
    ``parallel`` phase reports these sums)."""
    from torch.utils._pytree import tree_leaves
    axes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    total = 0
    for t, sh in zip(tree_leaves(tree), tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, SH.NamedSharding))):
        k = math.prod(axes[a] for e in sh.spec for a in SH.spec_names(e))
        total += t.numel() * t.element_size() // k
    return total


@pytest.fixture(scope="module")
def placed_bytes():
    return torch_gloo.run_ranks("fake_param_bytes", 256, timeout=300,
                                n_procs=1)[0]


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v3-671b"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_placed_bytes_equal_the_spec_arithmetic(arch, kind, fsdp,
                                                placed_bytes):
    mesh = make_production_mesh()
    tmpl = state_template(get_config(arch), O.OptConfig(kind=kind))
    psh = SH.param_shardings(tmpl["params"], mesh, fsdp=fsdp)
    osh = O.opt_state_shardings(tmpl["opt"], psh, mesh)
    key = f"{arch}:{kind}:{fsdp}"
    assert placed_bytes[key + ":params"] == _spec_bytes(tmpl["params"], psh,
                                                        mesh)
    assert placed_bytes[key + ":opt"] == sum(
        _spec_bytes(tmpl["opt"][k], osh[k], mesh) for k in tmpl["opt"])


def test_placed_bytes_are_the_parallel_slices_table(placed_bytes):
    """``chip_smoke.parallel_specs``' rows (GB a device on 16 x 16):
    parameters with FSDP off and on, ZeRO-1 AdamW state with FSDP on."""
    gb = {k: v / 1e9 for k, v in placed_bytes.items()}
    assert round(gb["yi-9b:adamw:False:params"], 3) == 1.482
    assert round(gb["yi-9b:adamw:True:params"], 3) == 0.093
    assert round(gb["yi-9b:adamw:True:opt"], 3) == 0.556
    assert round(gb["deepseek-v3-671b:adamw:False:params"], 2) == 87.70
    assert round(gb["deepseek-v3-671b:adamw:True:params"], 3) == 5.481
    assert round(gb["deepseek-v3-671b:adamw:True:opt"], 2) == 32.81


# --------------------------------------------------- the DTensor train step
@pytest.fixture(scope="module")
def gloo_steps():
    return torch_gloo.run_ranks("train_step", 4, timeout=300)


@pytest.fixture(scope="module")
def fake_steps():
    return torch_gloo.run_ranks("fake_train_step", 4, timeout=300,
                                n_procs=1)[0]


@pytest.mark.parametrize("i", range(len(torch_gloo.STEP_CASES)))
def test_dtensor_train_step_matches_the_one_process_step(i, gloo_steps):
    """SMOKE dense and MoE (AdamW) and deepseek-v3 (Adafactor), bf16,
    FSDP, ``shard`` at every block: every rank's loss the same, within
    2e-3 (relative) of the one-process step's, and the global gradient
    norm within 1e-2 of its (bf16 sums over shards in another order; the
    largest gap seen is deepseek's 4.0e-3, whose routing moves with it);
    both steps count one step."""
    runs = [r["runs"][i] for r in gloo_steps]
    assert len({r["loss"] for r in runs}) == 1
    r = runs[0]
    assert r["dtype"] == "torch.bfloat16"
    assert abs(r["loss"] - r["loss_one_process"]) \
        <= 2e-3 * abs(r["loss_one_process"])
    assert abs(r["grad_norm"] - r["grad_norm_one_process"]) \
        <= 1e-2 * r["grad_norm_one_process"]
    assert r["step"] == [1, 1]


GRAD_TOL = 1e-5         # of the leaf's largest magnitude (seen: 1.5e-6)
MOMENT_TOL = 1e-5       # m, v / vr, vc, of the leaf's largest (2.5e-6)
MOVE_TOL = 0.1          # of the leaf's largest move in the step (0.032)


@pytest.mark.parametrize("i", range(len(torch_gloo.STEP_CASES)))
def test_dtensor_train_step_gradients_and_update_match(i, gloo_steps):
    """The same steps in float32, leaf by leaf against the one-process
    step: each gradient, each optimizer moment after the update (AdamW's
    m and v, Adafactor's factored vr and vc) and each updated parameter
    (and AdamW's float32 master). The DTensor leaves are gathered whole.
    Parameters are held to a tenth of the leaf's largest move (lr 1e-2):
    AdamW's first update g / (|g| + eps) amplifies the sums' rounding
    where |g| is near eps. A gradient placed as a replica where each rank
    holds a term of it, or a moment misplaced, is off by its own size."""
    for r in gloo_steps:
        run = r["float32"][i]
        assert run["dtype"] == "torch.float32" and run["step"] == [1, 1]
        for path, (d, m) in run["grads"].items():
            assert d <= GRAD_TOL * m, (run["arch"], "grad", path, d, m)
        for path, (d, m) in run["opt"].items():
            if path.startswith("master/"):
                move = run["moved"][path[len("master/"):]][0]
                assert d <= MOVE_TOL * move, (run["arch"], path, d, move)
            else:
                assert d <= MOMENT_TOL * m, (run["arch"], path, d, m)
        for path, (d, _) in run["params"].items():
            move = run["moved"][path][0]
            assert d <= MOVE_TOL * move, (run["arch"], path, d, move)
    kinds = {r["kind"] for r in gloo_steps[0]["float32"]}
    assert kinds == {"adamw", "adafactor"}


@pytest.mark.parametrize("i", range(len(torch_gloo.STEP_CASES)))
def test_gloo_collectives_equal_the_fake_dry_run(i, gloo_steps, fake_steps):
    gloo = gloo_steps[0]["runs"][i]["comm"]
    fake = fake_steps["runs"][i]
    assert gloo and gloo == fake["comm"]
    names = {"all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}
    assert {names[k]: v for k, v in gloo.items()} == fake["counter"]


# ------------------------------------------------------------- small cells
@pytest.fixture(scope="module")
def small_cells():
    return torch_gloo.run_ranks("solo_cells", 1, timeout=300)[0]


REF_FIELDS = {"arch", "shape", "mesh", "n_micro", "moe_impl", "status",
              "n_chips", "lower_s", "compile_s", "flops_per_device",
              "bytes_per_device", "collectives", "collective_wire_bytes_pd",
              "top_traffic", "top_flops", "memory_analysis", "roofline",
              "params_total", "params_active"}


def test_small_cells_trace_with_the_reference_fields(small_cells):
    by = {(r["arch"], r["shape"]): r for r in small_cells["cells"]}
    for key in (("yi-9b", "train_4k"), ("yi-9b", "prefill_32k"),
                ("yi-9b", "decode_32k"), ("llama4-scout-17b-a16e",
                                          "train_4k"),
                ("falcon-mamba-7b", "long_500k")):
        r = by[key]
        assert r["status"] == "ok", (key, r.get("error"))
        assert REF_FIELDS <= set(r), REF_FIELDS - set(r)
        assert r["n_chips"] == 4 and r["flops_per_device"] > 0
        assert set(r["roofline"]) >= {"compute_s", "memory_s",
                                      "collective_s", "dominant",
                                      "useful_flop_ratio", "mfu_bound"}
    skip = by[("yi-9b", "long_500k")]
    assert skip["status"] == "skipped"
    assert skip["reason"] == applicable(get_config("yi-9b"), "long_500k")[1]


def test_train_cell_counts_k5_free_small_attention_and_remat(small_cells):
    """At 64 tokens attention takes the small path (no K5); the full
    remat recomputes each block's forward in its backward, so the counted
    FLOPs exceed the 6 N D of the model."""
    r = next(c for c in small_cells["cells"]
             if c["shape"] == "train_4k" and c["arch"] == "yi-9b")
    assert r["roofline"]["useful_flop_ratio"] < 1.0
    assert r["memory_analysis"]["argument_size_in_bytes"] > 0


def test_pipeline_dry_run_counts_hand_offs(small_cells):
    p = small_cells["pipeline"]
    P, M = 2, 4
    assert p["status"] == "ok" and p["stages"] == P and p["n_micro"] == M
    assert p["collective_permutes"] == M          # sends of stage 0
    assert p["p2p_handoffs_pd"] == M              # stage 1 receives M
    assert p["permute_wire_GB_pd"] == round(M * 2 * 8 * 64 * 2 / 1e9, 2)
    assert p["gpipe_bubble_fraction"] == round((P - 1) / (M + P - 1), 3)
    # a stage: M microbatches x 2 layers x 2 products of [2*8, 64] x [64, 128]
    assert p["flops_per_device"] == M * 2 * 2 * (2 * 16 * 64 * 128)


# ------------------------------------------------ shard on plain tensors
@pytest.mark.parametrize("arch", ["yi-9b", "llama4-scout-17b-a16e",
                                  "deepseek-v3-671b", "paligemma-3b",
                                  "whisper-medium", "zamba2-7b"])
def test_shard_is_the_identity_on_plain_tensors(arch):
    """``forward``, ``prefill`` and ``decode_step`` with ``SH.shard``
    under a production ``ShardCtx`` give what they give without it, bit
    for bit."""
    torch.manual_seed(0)
    cfg = get_config(arch, smoke=True)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    batch = smoke_batch(cfg, B=2, S=16, seed=1, device="cpu")
    S_max = 16 + (cfg.n_patches if cfg.family == "vlm" else 0) + 4
    with torch.no_grad():
        want_f = lm.forward(p, cfg, batch)
        want_p, c0 = lm.prefill(p, cfg, batch, S_max)
        with SH.ShardCtx(make_production_mesh()):
            got_f = lm.forward(p, cfg, batch, SH.shard)
            got_p, c1 = lm.prefill(p, cfg, batch, S_max, SH.shard)
        for a, b in zip(want_f[:2], got_f[:2]):
            assert torch.equal(a, b)
        assert torch.equal(want_p, got_p)
        pos = torch.full((2,), S_max - 4, dtype=torch.int32)
        tok = batch["tokens"][:, -1]
        want_d, _ = lm.decode_step(p, cfg, tok, pos, c0)
        with SH.ShardCtx(make_production_mesh()):
            got_d, _ = lm.decode_step(p, cfg, tok, pos, c1, SH.shard)
        assert torch.equal(want_d, got_d)


def test_cli_decode_cell_at_full_width(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on yi-9b's decode_32k, full
    width and depth, on the 16 x 16 fake mesh: one ``ok`` record whose
    argument bytes are the parameters' and the cache's spec arithmetic."""
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-9b", "--shape", "decode_32k", "--mesh", "single", "--device",
         "cpu", "--out", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok", rec.get("error")
    mesh = make_production_mesh()
    cfg = get_config("yi-9b")
    pmeta = lm.param_shapes(cfg)
    cmeta = lm.cache_shapes(cfg, 128, 32768)
    want = (_spec_bytes(pmeta, SH.param_shardings(pmeta, mesh), mesh)
            + _spec_bytes(cmeta, SH.cache_shardings(cmeta, mesh), mesh)
            + 2 * 128 // 16 * 4)                    # tokens and positions
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["status"] == "ok" and "memory_analysis" not in line


def test_chip_smoke_dryrun_phase_rehearses_on_the_cpu(tmp_path):
    """``chip_smoke.rehearse_dryrun``: the 1 x 1 cell's counted FLOPs equal
    the real CPU step's, K5 through a one-rank gloo DTensor equals the
    plain call, yi-9b's decode cell at full width and the small pipeline
    dry run each ``ok``."""
    code = ("import json, chip_smoke as cs; "
            f"out = cs.rehearse_dryrun(out_dir={str(tmp_path)!r}); "
            "print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["fails"] == []
    card = out["vs_card"]
    assert card["flops_equal"] and card["flops_card"] > 0
    assert out["k5_dtensor"]["equal"]
    assert out["cells"]["yi-9b|decode_32k|single"]["status"] == "ok"
