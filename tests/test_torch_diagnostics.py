"""The port's diagnostics (`lives_tpu_torch.diagnostics`) against
lives_tpu's, on the CPU: `run_startup_tests(device="cpu")` passes the six
checks the JAX self-test runs, and each check fails where its subject is
broken; `benchmark_memcpy` reports the JAX keys; `CostPredictor` gives
the JAX predictor's predictions, bit for bit, over seeded sequences."""

import numpy as np
import pytest
import torch

from lives_tpu import diagnostics as jd
from lives_tpu_torch import diagnostics as td


def test_startup_tests_pass_on_the_cpu():
    res = td.run_startup_tests(device="cpu")
    assert res == {k: True for k in jd.run_startup_tests()}
    assert len(res) == 6


def test_startup_tests_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        td.run_startup_tests()


def test_a_broken_subject_fails_its_check(monkeypatch, capsys):
    import lives_tpu_torch.ops.colorspace as cs
    monkeypatch.setattr(cs, "rgb_to_yuv",
                        lambda r, g, b: (r, g, b))
    res = td.run_startup_tests(verbose=True, device="cpu")
    assert res["conversion_parity"] is False
    assert sum(res.values()) == 5
    assert "FAIL conversion_parity" in capsys.readouterr().out


def test_jpeg_check_is_gated_naming_the_missing_coder(monkeypatch, capsys):
    import lives_tpu_torch.native as native

    def absent():
        raise RuntimeError("no libjpeg here")
    monkeypatch.setattr(native, "load_jpegcoef", absent)
    res = td.run_startup_tests(verbose=True, device="cpu")
    assert res["jpeg_encode_decode_lanes"] is True
    out = capsys.readouterr().out
    assert "SKIP jpeg_encode_decode_lanes" in out and "no libjpeg here" in out


def test_benchmark_memcpy_keys_equal_jax():
    got, ref = td.benchmark_memcpy(), jd.benchmark_memcpy()
    assert sorted(got) == sorted(ref)
    assert all(v > 0 for v in got.values())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_features,window", [(2, 64), (3, 16), (1, 8)])
def test_cost_predictor_equals_jax(seed, n_features, window):
    rng = np.random.default_rng(seed)
    tp, jp = td.CostPredictor(n_features, window), \
        jd.CostPredictor(n_features, window)
    coef = rng.uniform(0.1, 2.0, n_features + 1)
    for k in range(3 * window):
        f = rng.uniform(0, 10, n_features + int(rng.integers(0, 2)))
        cost = float(coef[:n_features] @ f[:n_features] + coef[-1]
                     + rng.normal(0, 0.05))
        q = rng.uniform(0, 10, n_features)
        assert tp.predict(q) == jp.predict(q)
        tp.observe(f, cost)
        jp.observe(f, cost)
        assert tp.ema == jp.ema
    assert tp.predict(q) > 0
