"""The port stands alone: every ``repro_torch`` module (the figure
layer's named: the experiment CLI, theory, wasserstein and the eleven
``repro_torch.bench`` modules; the sharded paradigms' named: the NODES
mesh, the feature-sharded table and its host caches; LM training and
the dry-run's named: the steps, the launchers, the meshes, the
roofline and the kernels' cost model; the LM families' named: the MoE
and SSM blocks and the six configs; the static audits' named:
``repro_torch.analysis`` and its checkers, fixtures and command line; the
four examples and the CI runner with its smokes) and
``chip_smoke.py`` import without
pulling in ``jax``, the reference package ``repro`` or the reference's
``benchmarks`` (checked in a fresh interpreter, so nothing this test
process already imported can hide a dependency)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                       # module only: main() does not run
figures = ["repro_torch.core.experiment", "repro_torch.core.theory",
           "repro_torch.core.wasserstein", "repro_torch.bench.common",
           "repro_torch.bench.run"] + [
    "repro_torch.bench." + m for m in (
        "bench_fig1_metric_stability", "bench_fig2_convergence",
        "bench_fig3_generalization", "bench_fig4_multilayer",
        "bench_fig5_iter_to_acc", "bench_fig6_throughput",
        "bench_table1_tuned", "bench_thm3_wasserstein",
        "bench_theory_slopes")]
sharded = ["repro_torch.sharding", "repro_torch.core.featcache",
           "repro_torch.kernels.neighbor_agg.featshard",
           "repro_torch.kernels.neighbor_agg.ops", "repro_torch.core.engine",
           "repro_torch.core.inference", "repro_torch.core.embedding_store"]
dryrun = ["repro_torch.models.steps", "repro_torch.launch.train",
          "repro_torch.launch.dryrun", "repro_torch.launch.gnn_steps",
          "repro_torch.launch.mesh", "repro_torch.launch.roofline",
          "repro_torch.kernels.cost"]
families = ["repro_torch.models.moe", "repro_torch.models.ssm"] + [
    "repro_torch.configs." + m for m in (
        "llama4_scout_17b_a16e", "llama4_maverick_400b_a17b", "mamba2_130m",
        "zamba2_7b", "whisper_medium", "internvl2_76b")]
analysis = ["repro_torch.analysis"] + [
    "repro_torch.analysis." + m for m in (
        "findings", "thread_audit", "kernel_audit", "trace_audit",
        "fixtures", "__main__")]
examples = ["repro_torch.examples"] + [
    "repro_torch.examples." + m for m in (
        "quickstart", "full_vs_minibatch", "serve_batched",
        "lm_pretrain_smoke")]
ci = ["repro_torch.ci"] + [
    "repro_torch.ci." + m for m in ("__main__", "sweep_smoke",
                                    "sweep_resume_smoke")]
missing = sorted(set(figures + sharded + dryrun + families + analysis
                     + examples + ci) - set(names))
assert not missing, missing
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro", "benchmarks") or m.startswith(
                 ("jax.", "jaxlib.", "repro.", "benchmarks.")))
assert not bad, bad
assert len(names) >= 20, names
print("IMPORTED", len(names))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), REPO, env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED" in out.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without CUDA the script exits nonzero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
