"""benchmarks/harness.py: the peaks table refuses unknown devices, the
timer keeps compile time apart from steady time, the card query degrades
to a note where nvidia-smi is missing, the roofline counts XLA's
operations, and the shared coupling stack is a moderate warp."""
import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import harness  # noqa: E402


def test_peaks_known_device_names_its_source():
    pk = harness.peaks("NVIDIA H100 80GB HBM3")
    assert pk["source"] and pk["hbm_bytes_per_s"] > 0
    assert pk["bf16_flops"] > pk["tf32_flops"] > pk["fp32_flops"]


def test_peaks_unknown_device_is_an_error():
    with pytest.raises(KeyError, match="no published peaks"):
        harness.peaks(jax.devices()[0].device_kind)


def test_compile_and_time_separates_compile_from_steady():
    x = jnp.arange(8.0)
    out, compile_s, step_s = harness.compile_and_time(
        lambda a: a * 2.0, x, iters=3)
    assert list(out) == [2.0 * i for i in range(8)]
    assert compile_s > 0 and step_s > 0


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert harness.card_info().startswith("nvidia-smi unavailable")
    assert harness.device_summary()["platform"] == "cpu"


def test_xla_cost_counts_and_roofline_takes_the_largest_floor():
    x = jnp.ones((4096,), jnp.float32)
    cost = harness.xla_cost(lambda a: jnp.exp(a) * 2.0 + 1.0, x)
    assert cost["transcendentals"] == 4096
    assert cost["flops"] >= 2 * 4096
    assert cost["bytes accessed"] >= 2 * 4096 * 4
    pk = harness.peaks("NVIDIA H100 80GB HBM3")
    roof = harness.roofline(cost, pk)
    assert roof["sfu"] == 4096 / pk["sfu_ops_per_s"]
    assert roof["floor"] == max(roof["fp32"], roof["sfu"], roof["hbm"])


@pytest.mark.parametrize("kind", ["affine", "spline"])
def test_build_coupling_is_a_moderate_warp(kind):
    """Weights move by 0.03 / sqrt(fan_in): off the identity, and the
    forward keeps its log-determinant far from the +-3-per-dim clamp."""
    dim = 8
    stack = harness.build_coupling(kind, dim=dim, n_layers=2,
                                   hidden=(16, 16), n_bins=4)
    x = jax.random.normal(jax.random.PRNGKey(0), (256, dim))
    y, ladj = stack.forward_and_ladj(x)
    assert float(jnp.max(jnp.abs(y - x))) > 1e-3
    assert float(jnp.max(jnp.abs(ladj))) < dim
