"""The ops shell on the GPU, at a small size.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_shell.py -m cuda --noconftest -q

The checks of ``chip_smoke.py``'s shell path: the workload balancer's tasks
bit-equal to direct engine calls (K1 launched once a task); GPT-2 served
beside a live ``MetricsServer`` with the tokens of an engine of the same
batch width and other pool and window settings, ``/metrics`` carrying the engine's and HBM's series and the
health monitor counting the card; the resilient wrapper bit-equal to the
engine, raising an injected kernel failure with no last resort and no
KERNEL_FAILURE rung, and QUANT_ACCURACY moving the engine's call off K1's
int8 modes; the adaptive optimizer's cached hit launching nothing and the
fingerprint of a CUDA tensor equal to its CPU copy's; the simulators on the
card's record; the research modules finite on the card; the sanitizer
refusing a CUDA tensor with a NaN.
"""

import json
import urllib.request

import pytest
import torch

from photonic_flash_attention_tpu_torch.config import reset_config, set_global_config
from photonic_flash_attention_tpu_torch.core.engine import get_engine, reset_engine
from photonic_flash_attention_tpu_torch.ops import _build

INT8_MODES = ("pfa_flash_fwd_int8qk", "pfa_flash_fwd_int8full")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    reset_config()
    reset_engine()
    set_global_config(auto_kernel_selection=False)  # the heuristic: fixed kinds
    yield torch.device("cuda")
    reset_config()
    reset_engine()


def _qkv(b, sq, h, d, skv=None, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    skv = sq if skv is None else skv
    return tuple(torch.randn(b, n, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                 for n in (sq, skv, skv))


def _launches(fn):
    before = dict(_build.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                 if v != before.get(k, 0)}


@pytest.mark.cuda
def test_balancer_tasks_equal_direct_engine_calls(cuda_device):
    from photonic_flash_attention_tpu_torch.scaling import (
        ComputeNode, DistributedTask, DistributedWorkloadBalancer, TaskState,
    )

    inputs = [_qkv(2, 512, 4, 64, seed=i) for i in range(4)]
    b = DistributedWorkloadBalancer()
    b.register_node(ComputeNode("gpu0"))
    tasks = [DistributedTask(f"t{i}", payload={"q": q, "k": k, "v": v, "causal": True})
             for i, (q, k, v) in enumerate(inputs)]
    for t in tasks:
        b.submit_task(t)
    _, got = _launches(b.run_until_drained)
    assert got.get("pfa_flash_fwd") == len(tasks)
    for t, (q, k, v) in zip(tasks, inputs):
        assert t.state == TaskState.DONE
        assert torch.equal(t.result, get_engine()(q, k, v, causal=True)[0])


@pytest.mark.cuda
def test_serving_beside_the_metrics_server(cuda_device):
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from photonic_flash_attention_tpu_torch.monitoring import MetricsServer, get_health_monitor

    get_engine()(*_qkv(1, 512, 4, 64), causal=True)  # the engine's series
    cfg = GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                     dtype=torch.float32)
    state = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    prompts = [[464 % 512, 3290 % 512, 318], [15496 % 512, 995 % 512], [1, 2, 3, 4]]
    kw = dict(page_size=16, kv_dtype=torch.int8, max_batch=4)
    ref = ServingEngine(cfg, state, device="cuda", num_pages=64, decode_window=4,
                        **kw).generate(prompts, max_new_tokens=8)
    server = MetricsServer(port=0, host="127.0.0.1")
    port = server.start()
    try:
        eng = ServingEngine(cfg, state, device="cuda", num_pages=32, **kw)
        outs, got = _launches(lambda: eng.generate(prompts, max_new_tokens=8))
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30)
        metrics = metrics.read().decode()
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                                   timeout=30).read())
    finally:
        server.stop()
    assert outs == ref
    assert got.get("pfa_flash_fwd") and got.get("pfa_paged_decode_fused")
    for series in ("pfa_engine_total_calls", "pfa_hbm_bytes_in_use", "pfa_hbm_utilization"):
        assert f"\n{series} " in f"\n{metrics}", series
    assert health["checks"]["device_reachable"]["value"] == torch.cuda.device_count()
    results = get_health_monitor().run_checks()
    assert results["device_reachable"].status.value == "healthy"
    assert results["hbm"].value is not None and results["hbm"].status.value != "unknown"


@pytest.mark.cuda
def test_resilient_wrapper_raises_on_the_card(cuda_device):
    from photonic_flash_attention_tpu_torch.config import get_config
    from photonic_flash_attention_tpu_torch.resilience import ResilientAttentionWrapper
    from photonic_flash_attention_tpu_torch.utils.exceptions import KernelLaunchError

    q, k, v = _qkv(2, 512, 4, 64)
    engine = get_engine()
    w = ResilientAttentionWrapper(lambda q, k, v, mask=None, **kw: engine(q, k, v, mask, **kw))
    assert torch.equal(w(q, k, v, causal=True)[0], engine(q, k, v, causal=True)[0])
    left = {"n": 3}

    def injected(q, k, v, mask=None, **kw):
        if left["n"]:
            left["n"] -= 1
            raise KernelLaunchError("pfa_flash_fwd failed: injected")
        return engine(q, k, v, mask, **kw)

    flaky = ResilientAttentionWrapper(injected, max_failures_before_degrade=1)
    for _ in range(3):
        with pytest.raises(KernelLaunchError):
            flaky(q, k, v, causal=True)
    status = flaky.get_status()
    assert status["last_resort_uses"] == 0 and status["degradation"]["level"] == "NORMAL"
    assert get_config().flash_threshold == 512
    _, got = _launches(lambda: flaky(q, k, v, causal=True))
    assert got.get("pfa_flash_fwd") == 1


@pytest.mark.cuda
def test_quant_accuracy_moves_launches_to_bf16(cuda_device):
    from photonic_flash_attention_tpu_torch.resilience import (
        DegradationTrigger, GracefulDegradationManager,
    )

    q, k, v = _qkv(2, 256, 4, 64, skv=1024)
    set_global_config(quant_mode="int8")
    engine = get_engine()
    _, before = _launches(lambda: engine(q, k, v))
    assert any(before.get(m) for m in INT8_MODES)
    ladder = GracefulDegradationManager()
    ladder.degrade(DegradationTrigger.QUANT_ACCURACY)
    _, raised = _launches(lambda: engine(q, k, v))
    assert raised == {"pfa_flash_fwd": 1}
    ladder.recover(DegradationTrigger.QUANT_ACCURACY)
    _, after = _launches(lambda: engine(q, k, v))
    assert any(after.get(m) for m in INT8_MODES)


@pytest.mark.cuda
def test_optimizer_hit_launches_nothing_and_fingerprints_match(cuda_device):
    from photonic_flash_attention_tpu_torch.ops.flash import flash_attention
    from photonic_flash_attention_tpu_torch.optimization import AdaptiveOptimizer
    from photonic_flash_attention_tpu_torch.optimization.caching import _array_fingerprint

    q, k, v = _qkv(2, 512, 4, 64)
    opt = AdaptiveOptimizer()
    fn = lambda q, k, v: flash_attention(q, k, v, causal=True)  # noqa: E731
    first, got = _launches(lambda: opt.optimize_operation(fn, q, k, v, cacheable=True))
    assert got.get("pfa_flash_fwd") == 1
    hit, got = _launches(lambda: opt.optimize_operation(fn, q, k, v, cacheable=True))
    assert hit is first and got == {}
    assert opt.get_stats()["profiler"]["operations"]
    for x in (q, torch.arange(1000, device="cuda", dtype=torch.int32),
              torch.randn(33, 65, device="cuda")):
        assert _array_fingerprint(x) == _array_fingerprint(x.cpu())


@pytest.mark.cuda
def test_simulators_on_the_cards_record(cuda_device):
    from photonic_flash_attention_tpu_torch.hardware import (
        KernelPipelineSimulator, TopologySimulator, detect_tpu_hardware,
    )
    from photonic_flash_attention_tpu_torch.parallel.telemetry import collective_bytes

    caps = detect_tpu_hardware()[0].capabilities
    best = KernelPipelineSimulator(caps).best(4, 2048, 2048, 12, 64, causal=True)
    assert best.t_total_us > 0
    for n in (1, 2, 4, 8):
        t = TopologySimulator((n,), caps)
        assert t.topology == "switch"
        assert t.collective_cost("psum", 2**24).bytes_moved == collective_bytes("psum", 2**24, n)


@pytest.mark.cuda
def test_research_and_security_on_the_card(cuda_device):
    from photonic_flash_attention_tpu_torch.research import ResearchBenchmark
    from photonic_flash_attention_tpu_torch.utils.exceptions import SecurityError
    from photonic_flash_attention_tpu_torch.utils.security import (
        InputSanitizer, sanitize_state_dict,
    )

    results = ResearchBenchmark(batch=1, seq=128, embed=128, heads=4).run(iters=2)
    assert len(results) == 3 and all(r.finite for r in results)
    x = torch.randn(2, 16, device="cuda")
    assert InputSanitizer().sanitize_tensor(x) is x
    x[1, 3] = float("nan")
    with pytest.raises(SecurityError):
        InputSanitizer().sanitize_tensor(x)
    module = torch.nn.Linear(8, 8).cuda()
    assert sanitize_state_dict(module) is module
    with torch.no_grad():
        module.weight[0, 0] = float("inf")
    with pytest.raises(SecurityError, match="weight"):
        sanitize_state_dict(module)
