"""Bring-up plumbing that runs without a card: compile-cache resolution,
the launcher's one-worker-per-card plan, the published-peak table, and
`chip_smoke.py`'s device check, cache guard, parity helper (CPU against
CPU) and sharded-vs-unsharded comparison (on the virtual CPU mesh)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_kernels  # noqa: E402
import chip_smoke  # noqa: E402
from vbmc_tpu.parallel.launch import plan_runs, visible_cards  # noqa: E402
from vbmc_tpu.utils import compile_cache as cc  # noqa: E402

CHECKOUT_CACHE = os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("platform, environ, expected", [
    ("gpu", {cc.ENV: "/srv/xla"}, "/srv/xla"),
    ("cpu", {cc.ENV: "/srv/xla"}, "/srv/xla"),
    ("gpu", {}, CHECKOUT_CACHE),
    ("cpu", {}, None),
])
def test_compile_cache_dir(platform, environ, expected):
    assert cc.compile_cache_dir(platform, environ) == expected


def test_compile_cache_dir_ignores_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cc.compile_cache_dir("gpu", {}) == CHECKOUT_CACHE


def test_configure_compile_cache_sets_nothing_when_env_set(monkeypatch):
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv(cc.ENV, "/srv/xla")
    assert cc.configure_compile_cache() == "/srv/xla"
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before


def test_configure_compile_cache_keeps_every_program_in_checkout(
        monkeypatch):
    """Unset on a GPU: the checkout cache, with no minimum compile time."""
    monkeypatch.delenv(cc.ENV, raising=False)
    monkeypatch.setattr(cc.jax, "default_backend", lambda: "gpu")
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert cc.configure_compile_cache() == CHECKOUT_CACHE
        assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])


@pytest.mark.parametrize("n_runs, cards, expected", [
    (5, ["0", "1"], [("0", [0, 2, 4]), ("1", [1, 3])]),
    (3, ["0"], [("0", [0, 1, 2])]),
    (2, ["0", "1", "2", "3"], [("0", [0]), ("1", [1])]),
    (3, [], [(None, [0]), (None, [1]), (None, [2])]),
])
def test_plan_runs_one_worker_per_card(n_runs, cards, expected):
    plan = plan_runs(n_runs, cards)
    assert plan == expected
    assert sorted(i for _, q in plan for i in q) == list(range(n_runs))


@pytest.mark.parametrize("vis, expected", [("2,3", ["2", "3"]), ("", [])])
def test_visible_cards_follows_cuda_visible_devices(vis, expected):
    assert visible_cards({"CUDA_VISIBLE_DEVICES": vis}) == expected


def test_peak_table_knows_h100_and_refuses_unknown():
    assert bench_kernels.peak_for("NVIDIA H100 80GB HBM3")[
        "fp32_tflops"] == 67.0
    with pytest.raises(KeyError):
        bench_kernels.peak_for("cpu")


def test_chip_smoke_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.check_device(jax.devices("cpu"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """Exits non-zero and prints no result on the CPU, and in a directory
    holding chip_smoke.py and nothing else of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        (tmp_path / "chip_smoke.py").write_text(open(script).read())
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_parity_cpu_vs_cpu():
    """The parity helper at tiny widths: float32 against float64 on the
    CPU is within every tolerance the chip run enforces."""
    hp = bench_kernels.host_problem(N=16, S=2, K=2, M=64, D=2)
    cpu = jax.devices("cpu")[0]
    errs = chip_smoke.parity(hp, cpu, cpu)
    assert set(errs) == set(chip_smoke.TOL)
    assert all(rel <= chip_smoke.TOL[k] for k, (_, rel) in errs.items()), errs


def test_no_persistent_cache_keeps_programs_out(tmp_path):
    """Programs compiled inside the guard are neither written to nor read
    from the persistent cache; those compiled after it are written again."""
    from jax.experimental.compilation_cache import compilation_cache as jcc
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jcc.reset_cache()
    try:
        def compile_one(c):
            jax.jit(lambda x: x * c + 1.0)(jnp.ones(7)).block_until_ready()
            return len(os.listdir(tmp_path))

        n1 = compile_one(3.0)
        assert n1 > 0
        with chip_smoke.no_persistent_cache():
            assert compile_one(5.0) == n1
        assert compile_one(7.0) > n1
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])
        jcc.reset_cache()


def test_chip_smoke_sharded_programs_match_unsharded(monkeypatch):
    """The four-card comparison at tiny widths on the virtual 8-device
    mesh, float64: every enforced check is within its tolerance, the quick
    update's GP retrain included."""
    from vbmc_tpu.parallel import context
    monkeypatch.setenv("VBMC_SHARD", "auto")
    hp = bench_kernels.host_problem(N=32, S=8, K=2, M=64, D=2)
    try:
        errs = chip_smoke.sharded_blocks(hp, n_search=64, max_evals=32)
    finally:
        context.reset_mesh()
    assert set(chip_smoke.TOL_SHARD64) <= set(errs)
    assert all(errs[k][1] <= tol
               for k, tol in chip_smoke.TOL_SHARD64.items()), errs
