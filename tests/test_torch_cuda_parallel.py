"""The parallel path on the GPU over a real NCCL group of world size 1.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda --noconftest -q

One card gives one rank (NCCL refuses two ranks on one device), so the
multi-rank behaviour is held against JAX on the CPU under gloo
(``tests/test_torch_parallel_*.py``); here every sharded path runs through
NCCL at world 1 at a small size: ring attention (its forward bit-equal to
one K1-with-lse call; its 4-rank step schedule played in one process
within 1e-2 / 1e-3 of it; its gradient within the repo's 5e-2 of autograd
through K1 and K4/K5), Ulysses, the engine's RING and ULYSSES, the GPipe
pipeline, GPT-2 tiny trained on a (data 1, model 1) mesh and served on one.
"""


import pytest
import torch

from photonic_flash_attention_tpu_torch.ops import _build
from photonic_flash_attention_tpu_torch.ops.flash import flash_attention, flash_attention_with_lse
from photonic_flash_attention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

GRAD_BOUND = 5e-2


def rel_err_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-9))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(seq mesh, (data, model) mesh) over a world of one NCCL rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    import torch.distributed as dist

    from photonic_flash_attention_tpu_torch.parallel import create_mesh
    from photonic_flash_attention_tpu_torch.parallel.multihost import initialize_multihost

    store = tmp_path_factory.mktemp("nccl") / "store"
    info = initialize_multihost(f"file://{store}", 1, 0)
    assert info["backend"] == "nccl" and info["process_count"] == 1
    yield create_mesh((1,), ("seq",)), create_mesh((1, 1), ("data", "model"))
    dist.destroy_process_group()


def _qkv(b, s, hq, hkv, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
            for h in (hq, hkv, hkv)] + [gen]


def _streams(b, s, gen, lens):
    bias = torch.randn(b, s, device="cuda", generator=gen)
    bias = torch.where(torch.rand(b, s, device="cuda", generator=gen) < 0.1,
                       torch.full_like(bias, DEFAULT_MASK_VALUE), bias)
    bias[:, 0] = 0.0
    return torch.tensor(lens, dtype=torch.int32, device="cuda"), bias


@pytest.mark.cuda
def test_ring_forward_world1_is_one_k1_call(meshes):
    from photonic_flash_attention_tpu_torch.parallel.ring import make_ring_attention

    q, k, v, gen = _qkv(2, 1024, 8, 2, 64, 0)
    lens, bias = _streams(2, 1024, gen, [700, 1024])
    want, _ = flash_attention_with_lse(q, k, v, causal=True, kv_lens=lens, k_bias=bias)
    _build.reset_launches()
    fn = make_ring_attention(meshes[0], data_axis=None, model_axis=None, causal=True)
    got = fn(q, k, v, kv_lens=lens, k_bias=bias)
    assert _build.LAUNCHES["pfa_flash_fwd_streams"] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [[1500, 2048], [700, 300]], ids=["lens", "skip"])
def test_ring_schedule_of_four_ranks(meshes, lens):
    """Each of 4 ranks' steps through ``ring_step`` on the card (clipped
    lengths, bias shards, skipped blocks), merged, against one K1 call."""
    from photonic_flash_attention_tpu_torch.parallel.ring import ring_step, softmax_merge

    n, s = 4, 2048
    q, k, v, gen = _qkv(2, s, 8, 2, 64, 1)
    kv_lens, bias = _streams(2, s, gen, lens)
    want_o, want_lse = flash_attention_with_lse(q, k, v, causal=True, kv_lens=kv_lens, k_bias=bias)
    sl = s // n
    cut = lambda t, i: t[:, i * sl:(i + 1) * sl].contiguous()  # noqa: E731
    outs, lses = [], []
    for me in range(n):
        acc = None
        for step in range(n):
            src = (me - step) % n
            part = ring_step(cut(q, me), cut(k, src), cut(v, src), me=me, n=n, step=step,
                             causal=True, sm_scale=64 ** -0.5, kv_lens=kv_lens, lens_host=lens,
                             k_bias=cut(bias, src))
            if part is not None:
                acc = part if acc is None else softmax_merge(*acc, *part)
        outs.append(acc[0])
        lses.append(acc[1])
    assert rel_err_norm(torch.cat(outs, 1), want_o) <= 1e-2
    fin = torch.isfinite(want_lse)
    assert float((torch.cat(lses, 2)[fin] - want_lse[fin]).abs().max()) <= 1e-3


def _grads(fn, leaves, g):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, g)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_grads_world1(meshes, kind):
    from photonic_flash_attention_tpu_torch.parallel.ring import make_ring_attention
    from photonic_flash_attention_tpu_torch.parallel.ulysses import make_ulysses_attention

    q, k, v, gen = _qkv(1, 1024, 8, 8, 64, 2)
    g = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
    fn = (make_ring_attention(meshes[0], data_axis=None, model_axis=None, causal=True,
                              differentiable=True) if kind == "ring"
          else make_ulysses_attention(meshes[0], data_axis=None, causal=True))
    o, got = _grads(fn, (q, k, v), g)
    want_o, want = _grads(lambda a, b, c: flash_attention(a, b, c, causal=True), (q, k, v), g)
    assert torch.equal(o, want_o)
    for a, b in zip(got, want):
        assert rel_err_norm(a, b) <= GRAD_BOUND


@pytest.mark.cuda
def test_engine_forced_sequence_parallel_kinds(meshes):
    from photonic_flash_attention_tpu_torch.core.engine import AttentionEngine
    from photonic_flash_attention_tpu_torch.core.router import KernelKind

    q, k, v, _ = _qkv(1, 1024, 8, 8, 64, 3)
    eng = AttentionEngine()
    eng.set_mesh(meshes[0], seq_axis="seq")
    want = flash_attention(q, k, v, causal=True)
    for kind in (KernelKind.RING, KernelKind.ULYSSES):
        out, _ = eng._run(kind, q, k, v, None, None, None, True, False)
        assert torch.equal(out, want), kind


@pytest.mark.cuda
def test_pipeline_world1(meshes):
    from photonic_flash_attention_tpu_torch.parallel import create_mesh, make_pipeline

    pipe = make_pipeline(create_mesh((1,), ("stage",)), lambda w, x: torch.tanh(x @ w), 4)
    w = torch.randn(1, 32, 32, device="cuda")
    x = torch.randn(8, 32, device="cuda")
    assert torch.allclose(pipe(w, x), torch.tanh(x @ w[0]))


def _tiny():
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    cfg = GPT2Config(vocab_size=1024, n_positions=256, n_embd=128, n_layer=2, n_head=2)  # D 64
    state = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    return cfg, state


@pytest.mark.cuda
def test_sharded_trainer_world1(meshes):
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2LMHead, param_sharding_rules
    from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches

    cfg, state = _tiny()
    batch = next(synthetic_lm_batches(batch=4, seq=128, vocab=cfg.vocab_size, seed=0))
    losses = {}
    for name in ("unsharded", "mesh"):
        model = GPT2LMHead(cfg)
        model.load_state_dict(state)
        model.to("cuda")
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        kw = dict(mesh=meshes[1], param_specs=param_sharding_rules(model.state_dict())) \
            if name == "mesh" else {}
        trainer = Trainer(model, opt, **kw)
        st = trainer.init_state()
        losses[name] = []
        for _ in range(2):
            st, m = trainer.train_step(st, batch)
            losses[name].append(float(m["loss"]))
    assert losses["mesh"] == pytest.approx(losses["unsharded"], rel=1e-3)


@pytest.mark.cuda
def test_sharded_serving_world1(meshes, tmp_path):
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine

    cfg, state = _tiny()
    prompts = [[5, 9, 100, 7, 3], list(range(1, 41))]
    kw = dict(device="cuda", num_pages=64, page_size=16, max_batch=2, kv_dtype=torch.int8,
              decode_window=2)
    want = ServingEngine(cfg, state, **kw).generate(prompts, max_new_tokens=6)
    _build.reset_launches()
    assert ServingEngine(cfg, state, mesh=meshes[1], **kw).generate(
        prompts, max_new_tokens=6) == want
    assert _build.LAUNCHES["pfa_paged_decode_fused"] > 0
    eng = ServingEngine(cfg, state, mesh=meshes[1], **kw)
    sids = [eng.submit(p, 6) for p in prompts]
    eng.step()
    eng.save(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="pass mesh="):
        ServingEngine.restore(str(tmp_path / "ckpt"), cfg, state, device="cuda")
    eng2 = ServingEngine.restore(str(tmp_path / "ckpt"), cfg, state, device="cuda",
                                 mesh=meshes[1])
    while any(not eng2._sequences[s].done for s in sids):
        eng2.step()
    assert [eng2._sequences[s].tokens[len(p):] for s, p in zip(sids, prompts)] == want
