"""Port parity: the CLI (``cli.py``) against the JAX package's, on the CPU.

``calibrate --patterns 1`` draws the same numpy patterns in the same order
as JAX's ``calibrate`` and runs the quantized functions' plain versions:
its report has JAX's keys (plus ``v_dtype``) and every error within 1e-4
of JAX's at the same seed (the functions agree to ~1e-6 at ``block_kv``
128). ``benchmark``, ``serve-bench --model tiny`` and ``device-info
--json`` run at tiny sizes with ``--device cpu`` and give JAX's JSON keys;
``--device cuda`` without a GPU raises instead of running on the CPU.
"""

import argparse
import json
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu import cli as jax_cli
from photonic_flash_attention_tpu_torch import cli
from photonic_flash_attention_tpu_torch.config import reset_config

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_config():
    reset_config()
    yield
    reset_config()


def test_calibrate_matches_jax(tmp_path):
    want_path, got_path = tmp_path / "jax.json", tmp_path / "port.json"
    jax_rc = jax_cli.calibrate(argparse.Namespace(patterns=1, seed=0, output=str(want_path)))
    rc = cli.main(["calibrate", "--patterns", "1", "--device", "cpu", "-o", str(got_path)])
    want, got = json.loads(want_path.read_text()), json.loads(got_path.read_text())
    assert rc == jax_rc == 0
    assert set(got) == set(want) | {"v_dtype"} and got["v_dtype"] == "float32"
    assert got["patterns"] == want["patterns"] == 1
    assert list(got["modes"]) == list(want["modes"])
    for mode, w in want["modes"].items():
        g = got["modes"][mode]
        assert set(g) == set(w), mode
        for key, value in w.items():
            if isinstance(value, bool):
                assert g[key] == value, (mode, key)
            else:
                assert abs(g[key] - value) <= 1e-4, (mode, key, g[key], value)


BENCH_ROW_KEYS = {"batch_size", "seq_length", "latency_ms", "tokens_per_second", "kernel_used",
                  "energy_mj"}


def test_benchmark_json(tmp_path):
    out = tmp_path / "bench.json"
    rc = cli.main(["benchmark", "--seq-lengths", "16", "32", "--batch-sizes", "1", "2",
                   "--embed-dim", "64", "--num-heads", "4", "--iterations", "2", "--warmup", "1",
                   "--causal", "--device", "cpu", "-o", str(out)])
    payload = json.loads(out.read_text())
    assert rc == 0
    assert set(payload) == {"benchmark", "config", "engine_stats", "results"}
    assert payload["config"] == {"embed_dim": 64, "num_heads": 4, "causal": True,
                                 "iterations": 2, "backend": "cpu"}
    assert [(r["seq_length"], r["batch_size"]) for r in payload["results"]] == [
        (16, 1), (16, 2), (32, 1), (32, 2)]
    for row in payload["results"]:
        assert set(row) == BENCH_ROW_KEYS
        assert set(row["latency_ms"]) == {"mean", "std", "min", "max"}
        assert row["tokens_per_second"] > 0 and isinstance(row["kernel_used"], str)
    assert payload["engine_stats"]["total_calls"] == 4 * 3


def test_serve_bench_json(tmp_path):
    out = tmp_path / "serve.json"
    rc = cli.main(["serve-bench", "--model", "tiny", "--batch", "2", "--prompt-len", "16",
                   "--new-tokens", "4", "--page-size", "16", "--device", "cpu", "-o", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0
    assert report["model"] == "tiny" and set(report["modes"]) == {"bf16", "int8"}
    assert "int8_decode_speedup" in report
    for mode, row in report["modes"].items():
        assert {"prefill_s", "decode_wall_s", "decode_ms_per_step", "decode_tokens",
                "decode_tokens_per_s", "decode_steps", "kv_dtype"} <= set(row)
        assert row["decode_tokens"] == 2 * 3  # the first token comes from the prefill
        assert row["kv_dtype"] == mode


def test_zero_state_matches_the_model():
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    cfg = GPT2Config.tiny()
    state = cli._zero_state(cfg, torch.device("cpu"))
    want = GPT2LMHead(cfg).state_dict()
    assert list(state) == list(want)
    for name, t in state.items():
        assert t.shape == want[name].shape and t.dtype == want[name].dtype
        assert not t.any()


def test_device_info_json(capsys):
    assert jax_cli.device_info(argparse.Namespace(json=True)) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["device-info", "--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["backend"] == "cpu" and got["device_count"] == len(got["devices"]) == 1
    assert set(got["devices"][0]) >= {"id", "platform", "device_kind", "process_index"}
    assert set(got["config"]) == set(want["config"])
    assert cli.main(["device-info", "--device", "cpu"]) == 0
    assert "router: flash_threshold=" in capsys.readouterr().out


@pytest.mark.parametrize("command", [["device-info"], ["calibrate", "--patterns", "1"],
                                     ["benchmark", "--seq-lengths", "16"],
                                     ["serve-bench", "--model", "tiny"]])
def test_cuda_without_a_gpu_raises(command):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cli.main(command)  # --device cuda is the default
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cli.main(command + ["--device", "cuda"])


def test_console_script_is_declared():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["pfa-torch"] == "photonic_flash_attention_tpu_torch.cli:main"
    assert np.all([v.startswith("photonic_flash_attention_tpu.cli") for k, v in scripts.items()
                   if k != "pfa-torch"])
