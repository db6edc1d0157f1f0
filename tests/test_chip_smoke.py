"""chip_smoke.py on the CPU: every phase at a tiny size (the checks and the
float64 comparisons run as they do on the card), ``--multi`` on four of the
eight virtual devices, the refusal to run without a GPU, and the form of
the last line."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture
def report(capsys):
    return chip_smoke.Report("test card, 0 W")


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_phase_whitening_small(report, capsys):
    chip_smoke.phase_whitening(report, n_fwd=4096, n_train=2048, nbatches=4,
                               nepochs=2, n_cmp=1024)
    lines = _lines(capsys)
    assert any("drive recipe" in ln and "negll gap" in ln for ln in lines)
    assert all(ln.startswith("[whitening]") and "card: test card" in ln
               for ln in lines)


def test_phase_coupling_small(report, capsys):
    chip_smoke.phase_coupling(report, rows=256, dim=8, n_layers=2,
                              hidden=(16, 16), n_bins=4, train_steps=2,
                              n_cmp=64)
    lines = _lines(capsys)
    for kind in ("affine", "spline"):
        for prec in ("default", "float32"):
            assert any(f"{kind} vs f64 CPU" in ln and prec in ln
                       for ln in lines), (kind, prec)
    assert any("compile" in ln and "ms/step" in ln for ln in lines)


def test_phase_samplers_small(report, capsys):
    chip_smoke.phase_samplers(report, nuts_chains=16, nuts_dim=4,
                              num_warmup=150, num_samples=150,
                              smc_particles=1024, smc_dim=4)
    lines = _lines(capsys)
    assert any(ln.startswith("[samplers] NUTS") for ln in lines)
    assert any(ln.startswith("[samplers] SMC") for ln in lines)


def test_phase_multi_on_four_virtual_devices(report, capsys):
    assert len(jax.devices()) >= 4
    chip_smoke.phase_multi(report, n_devices=4, rows=64, dim=4, n_layers=2,
                           hidden=(8, 8), train_steps=2, nuts_chains=16,
                           nuts_dim=3, num_warmup=40, num_samples=20,
                           smc_particles=512, smc_dim=3)
    lines = _lines(capsys)
    assert len(lines) == 3 and all("on 4 cards" in ln for ln in lines)


def test_moment_gate_flags_a_biased_variance():
    """Independent N(0, 1) chains pass; the same draws scaled to variance
    0.81 fail the variance gate."""
    import numpy as np
    draws = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (256, 100, 3)), np.float64)
    chip_smoke.check_moments("ok", draws, 0.0, 1.0)
    with pytest.raises(AssertionError, match="moments off"):
        chip_smoke.check_moments("biased", 0.9 * draws, 0.0, 1.0)


def test_smc_gate_flags_a_wrong_log_z():
    """The SMC checks pass on exact draws from the 3-D mixture and fail
    when log Z is off by more than SMC_LOGZ_ATOL."""
    import jax.numpy as jnp
    from enflows_tpu.smc import SMCInfo
    n, dim = 4096, 3
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    sign = jnp.where(jax.random.bernoulli(k1, 0.5, (n, 1)), 1.5, -1.5)
    parts = sign + jax.random.normal(k2, (n, dim))
    lw = jnp.zeros(n)
    log_z = dim * 0.5 * jnp.log(2 * jnp.pi)
    infos = [SMCInfo(beta=jnp.asarray(1.0), ess=n, accept_prob=1.0,
                     resampled=False, log_z=log_z)]
    chip_smoke.check_smc("exact", parts, lw, log_z, infos, dim)
    with pytest.raises(AssertionError, match="logZ error"):
        chip_smoke.check_smc("off", parts, lw,
                             log_z + 2 * chip_smoke.SMC_LOGZ_ATOL, infos,
                             dim)


def test_checks_raise():
    with pytest.raises(AssertionError, match="boom"):
        chip_smoke.check(False, "boom")
    assert chip_smoke.max_rel_err([2.0], [2.0]) == 0.0


@pytest.mark.parametrize("multi", [False, True])
def test_main_last_line_is_the_contract(monkeypatch, capsys, multi):
    calls = []
    monkeypatch.setattr(chip_smoke, "device_summary", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    monkeypatch.setattr(chip_smoke, "enable_persistent_compilation_cache",
                        lambda: "/cache")
    monkeypatch.setattr(chip_smoke, "card_info",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for name in ("phase_whitening", "phase_coupling", "phase_samplers",
                 "phase_multi"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda report, name=name: calls.append(name))
    assert chip_smoke.main(["--multi"] if multi else []) == 0
    lines = _lines(capsys)
    assert lines[0] == "card: NVIDIA H100 80GB HBM3, 700.00 W"
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": 4 if multi else 1}}
    assert calls == (["phase_multi"] if multi else
                     ["phase_whitening", "phase_coupling", "phase_samplers"])


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_main_refuses_cpu():
    out = _run_script(REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
