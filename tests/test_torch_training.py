"""Port parity for the training slice: data, loss, gradients, Trainer.

GPT-2 tiny (head dim 64) in fp32, with weights from the JAX
``GPT2LMHead.init`` carried across by ``models/from_jax.py::params_from_jax``
(which also maps JAX gradients onto the port's parameter names). Both
packages' ``flash_threshold`` and ``flash_min_tokens`` are lowered, so the
attention takes the flash route: the JAX Pallas forward and backward in
interpret mode, and the port's plain versions of K1 (with lse) and K4/K5.

Bounds: step-0 gradients ``rel_err_norm`` <= 1e-3 per parameter; losses
of 3 AdamW steps against ``optax.adamw`` within 1e-3 relative; the port's
accumulation and remat against its own large batch and plain step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from photonic_flash_attention_tpu import config as jax_config_module
from photonic_flash_attention_tpu.config import get_config as jax_get_config
from photonic_flash_attention_tpu.models.attention import (
    dispatch_attention as jax_dispatch,
    padding_mask_to_lens_bias as jax_lens_bias,
)
from photonic_flash_attention_tpu.ops.fused import fused_attention as jax_fused
from photonic_flash_attention_tpu.models.gpt2 import (
    GPT2Config as JaxConfig,
    GPT2LMHead as JaxGPT2,
)
from photonic_flash_attention_tpu.training import (
    Trainer as JaxTrainer,
    TrainState as JaxTrainState,
    synthetic_lm_batches as jax_batches,
)
from photonic_flash_attention_tpu.training.trainer import lm_loss as jax_lm_loss
from photonic_flash_attention_tpu_torch import config as config_module
from photonic_flash_attention_tpu_torch.config import get_config, reset_config
from photonic_flash_attention_tpu_torch.models import attention as port_attention
from photonic_flash_attention_tpu_torch.models.attention import (
    dispatch_attention,
    padding_mask_to_lens_bias,
)
from photonic_flash_attention_tpu_torch.models.from_jax import params_from_jax
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.ops import flash as port_flash
from photonic_flash_attention_tpu_torch.ops.fused import fused_attention
from photonic_flash_attention_tpu_torch.training import (
    DataPipeline,
    Trainer,
    TrainState,
    make_train_step,
    synthetic_lm_batches,
)
from photonic_flash_attention_tpu_torch.training.trainer import lm_loss

from .conftest import rel_err_norm

BATCH, SEQ = 2, 64
JAX_CFG = dataclasses.replace(JaxConfig.tiny(), n_head=2, dtype=jnp.float32)
PORT_CFG = dataclasses.replace(GPT2Config.tiny(), n_head=2, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _flash_route():
    """Flash route at every size in both packages; the port's config is
    reset afterwards (the JAX one by tests/conftest.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_get_config().update(flash_threshold=1, flash_min_tokens=1)
    get_config().update(flash_threshold=1, flash_min_tokens=1)
    yield
    reset_config()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    variables = JaxGPT2(JAX_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return variables["params"]


def _port_model(params) -> GPT2LMHead:
    model = GPT2LMHead(PORT_CFG)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def _batch(seed=0, accum=1):
    return next(synthetic_lm_batches(batch=BATCH, seq=SEQ, vocab=PORT_CFG.vocab_size,
                                     accum_steps=accum, seed=seed))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("accum", [1, 3])
def test_synthetic_batches_are_jax_batches(accum):
    port = synthetic_lm_batches(batch=3, seq=16, vocab=100, accum_steps=accum, seed=7)
    ref = jax_batches(batch=3, seq=16, vocab=100, accum_steps=accum, seed=7)
    for _ in range(3):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "loss_mask"])
def test_lm_loss_matches_jax(jax_params, masked):
    batch = _batch(seed=1)
    if masked:
        batch["loss_mask"] = (np.arange(SEQ)[None] % 3 != 0).repeat(BATCH, 0).astype(np.int32)
    with torch.no_grad():
        port = float(lm_loss(_port_model(jax_params), _torch_batch(batch)))
    ref = float(jax.jit(lambda p, b: jax_lm_loss(JaxGPT2(JAX_CFG).apply, p, b))(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()}))
    assert abs(port - ref) <= 1e-5 * abs(ref)


def test_step0_grads_match_jax(jax_params, monkeypatch):
    batch = _batch(seed=2)
    model = _port_model(jax_params)
    calls = []
    bwd = port_flash.flash_attention_bwd
    monkeypatch.setattr(port_flash, "flash_attention_bwd",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    lm_loss(model, _torch_batch(batch)).backward()
    assert len(calls) == PORT_CFG.n_layer  # the flash route's backward ran
    grads = jax.jit(jax.grad(lambda p, b: jax_lm_loss(JaxGPT2(JAX_CFG).apply, p, b)))(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, p in model.named_parameters():
        got, want = p.grad.numpy(), ref[name].numpy()
        if name.endswith("attn.k_proj.bias"):
            # Zero in exact arithmetic (the softmax cancels a shift shared
            # by every key of a row): both sides hold only rounding noise.
            assert np.abs(got).max() <= 1e-6 and np.abs(want).max() <= 1e-6, name
            continue
        assert rel_err_norm(got, want) <= 1e-3, name


def test_trainer_adamw_matches_optax(jax_params):
    batches = [_batch(seed=s) for s in range(3)]
    jax_trainer = JaxTrainer(JaxGPT2(JAX_CFG), optax.adamw(1e-4))
    state = JaxTrainState(step=jnp.int32(0), params=jax_params,
                          opt_state=optax.adamw(1e-4).init(jax_params))
    model = _port_model(jax_params)
    trainer = Trainer(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                               betas=(0.9, 0.999), eps=1e-8,
                                               weight_decay=1e-4))
    port_state = trainer.init_state()
    for batch in batches:
        state, ref = jax_trainer.train_step(state, batch)
        port_state, got = trainer.train_step(port_state, batch)
        assert abs(float(got["loss"]) - float(ref["loss"])) <= 1e-3 * abs(float(ref["loss"]))
        assert abs(float(got["grad_norm"]) - float(ref["grad_norm"])) <= (
            1e-3 * float(ref["grad_norm"]))
    assert port_state.step == int(state.step) == 3


def _sgd_step(params, batch, **kwargs):
    """One SGD step of the port: (model after it, metrics)."""
    model = _port_model(params)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_train_step(model, opt, **kwargs)
    _, metrics = step(TrainState(0, model, opt), _torch_batch(batch))
    return model, metrics


def test_accumulation_matches_large_batch(jax_params):
    big = _batch(seed=3)
    micro = {k: v.reshape(2, BATCH // 2, SEQ) for k, v in big.items()}
    m_big, r_big = _sgd_step(jax_params, big)
    m_acc, r_acc = _sgd_step(jax_params, micro, accum_steps=2)
    for key in ("loss", "grad_norm"):
        assert abs(float(r_big[key]) - float(r_acc[key])) <= 1e-5 * float(r_big[key])
    for a, b in zip(m_big.parameters(), m_acc.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_remat_matches_plain(jax_params):
    batch = _batch(seed=4)
    m_plain, r_plain = _sgd_step(jax_params, batch)
    m_remat, r_remat = _sgd_step(jax_params, batch, remat=True)
    assert abs(float(r_plain["loss"]) - float(r_remat["loss"])) <= 1e-6 * float(r_plain["loss"])
    for a, b in zip(m_plain.parameters(), m_remat.parameters()):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


def test_fit_evaluate_and_history(jax_params):
    model = _port_model(jax_params)
    trainer = Trainer(model, torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4))
    saves = []
    state = trainer.fit(trainer.init_state(), synthetic_lm_batches(
        batch=BATCH, seq=SEQ, vocab=PORT_CFG.vocab_size, seed=5), steps=4, log_every=2,
        checkpoint_fn=lambda s, step: saves.append(step), checkpoint_every=2)
    assert state.step == 4 and saves == [2, 4] and len(trainer.history) == 2
    loss = trainer.evaluate(state, [_batch(seed=6)])
    assert np.isfinite(loss) and loss > 0 and model.training


def test_unported_training_options_raise(jax_params):
    model = _port_model(jax_params)
    opt = torch.optim.SGD(model.parameters(), lr=0)
    with pytest.raises(NotImplementedError, match="A12"):
        Trainer(model, opt, mesh=object())


DROP_CFG = dataclasses.replace(PORT_CFG, attn_pdrop=0.1)


def _dropout_run(params, steps=2, seed=0, **kwargs):
    """``steps`` AdamW steps of GPT-2 tiny with attn_pdrop 0.1 through
    ``Trainer(dropout_rng=Generator(seed))``: (losses, the model after)."""
    model = GPT2LMHead(DROP_CFG)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    trainer = Trainer(model, torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4),
                      dropout_rng=torch.Generator().manual_seed(seed), **kwargs)
    state, losses = trainer.init_state(), []
    for i in range(steps):
        state, metrics = trainer.train_step(state, _batch(seed=20 + i, accum=kwargs.get(
            "accum_steps", 1)))
        losses.append(float(metrics["loss"]))
    return losses, model


def test_dropout_training_is_reproducible_from_its_seed(jax_params):
    """Two runs from one dropout seed are equal to the bit; another seed, or
    no dropout, gives another loss; the flash route's dropout backward ran
    (K4/K5's plain version with the mask)."""
    a, model_a = _dropout_run(jax_params)
    b, model_b = _dropout_run(jax_params)
    c, _ = _dropout_run(jax_params, seed=1)
    assert a == b
    for pa, pb in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(pa, pb)
    assert a[0] != c[0]
    with torch.no_grad():
        plain = float(lm_loss(_port_model(jax_params), _torch_batch(_batch(seed=20))))
    assert abs(a[0] - plain) > 1e-4 and abs(a[0] - plain) < 0.1 * plain


def test_dropout_remat_gives_the_same_gradients(jax_params, monkeypatch):
    """remat recomputes the forward with the same seeds: the same masks, so
    the same loss and parameters after an SGD step; microbatches take
    their own seeds."""
    calls = []
    bwd = port_flash.flash_attention_bwd
    monkeypatch.setattr(port_flash, "flash_attention_bwd",
                        lambda *a, **k: calls.append(k["dropout_rate"]) or bwd(*a, **k))
    batch = _torch_batch(_batch(seed=4))
    results = []
    for remat in (False, True):
        model = GPT2LMHead(DROP_CFG)
        model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)))
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        step = make_train_step(model, opt, remat=remat, dropout_rng=torch.Generator().manual_seed(3))
        _, metrics = step(TrainState(0, model, opt), batch)
        results.append((float(metrics["loss"]), [p.detach().clone() for p in model.parameters()]))
    assert calls == [0.1] * (2 * PORT_CFG.n_layer)
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    losses, _ = _dropout_run(jax_params, steps=1, accum_steps=2)
    assert np.isfinite(losses[0])


def test_dropout_only_in_train_mode(jax_params):
    model = GPT2LMHead(DROP_CFG)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)))
    ids = torch.from_numpy(_batch(seed=6)["input_ids"]).long()
    with torch.no_grad():
        want = _port_model(jax_params)(ids)
        assert torch.equal(model.eval()(ids, dropout_seed=5), want)
        model.train()
        a, b = model(ids, dropout_seed=5), model(ids, dropout_seed=5)
    assert torch.equal(a, b) and not torch.equal(a, want)


def _qkv(b, s, h=2, d=64, seed=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "b, s, kwargs, route",
    [
        (4, 600, {}, "flash"),
        (8, 256, {}, "fused"),  # below flash_threshold
        (4, 600, {"mask": True}, "fused"),
        (4, 600, {"need_weights": True}, "fused"),
        (2, 600, {}, "fused"),  # below flash_min_tokens
    ],
    ids=["flash", "short", "mask", "weights", "few_tokens"],
)
def test_dispatch_routes_as_jax(monkeypatch, b, s, kwargs, route):
    reset_config()  # the package defaults: threshold 512, min tokens 2048
    jax_get_config().update(flash_threshold=512, flash_min_tokens=2048)
    calls = []
    for name in ("flash_attention", "fused_attention"):
        fn = getattr(port_attention, name)
        monkeypatch.setattr(port_attention, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    arrs = _qkv(b, s)
    mask = None
    if kwargs.get("mask"):
        mask = np.tril(np.ones((s, s), bool))[None, None] | (np.arange(s) % 5 == 0)
    need = kwargs.get("need_weights", False)
    out, w = dispatch_attention(
        *(torch.from_numpy(a) for a in arrs), None if mask is None else torch.from_numpy(mask),
        causal=True, need_weights=need)
    ref, ref_w = jax_dispatch(*(jnp.asarray(a) for a in arrs),
                              None if mask is None else jnp.asarray(mask),
                              causal=True, need_weights=need)
    assert calls == [f"{route}_attention"]
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= 1e-4
    assert (w is None) == (ref_w is None)
    if need:
        assert np.max(np.abs(w.numpy() - np.asarray(ref_w))) <= 1e-5


@pytest.mark.parametrize("weights_only", [False, True], ids=["out", "weights_only"])
def test_fused_attention_matches_jax(weights_only):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 48, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 80, 2, 64)).astype(np.float32) for _ in range(2))
    mask = rng.random((2, 1, 48, 80)) > 0.3
    bias = rng.standard_normal((1, 4, 48, 80)).astype(np.float32)
    kw = dict(causal=True, sm_scale=0.2, need_weights=True, weights_only=weights_only)
    out, w = fused_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                             bias=torch.from_numpy(bias), **kw)
    ref, ref_w = jax_fused(*(jnp.asarray(a) for a in (q, k, v, mask)),
                           bias=jnp.asarray(bias), **kw)
    assert (out is None) == (ref is None) == weights_only
    if not weights_only:
        assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= 1e-5
    assert np.max(np.abs(w.numpy() - np.asarray(ref_w))) <= 1e-6


def test_config_is_a_copy_of_the_jax_config(monkeypatch):
    reset_config()
    assert get_config().to_dict() == jax_config_module.GlobalConfig().to_dict()
    assert [e[:2] for e in config_module._ENV_OVERRIDES] == [
        e[:2] for e in jax_config_module._ENV_OVERRIDES]
    monkeypatch.setenv("PFA_FLASH_THRESHOLD", "128")
    monkeypatch.setenv("PFA_FLASH_MIN_TOKENS", "oops")  # malformed: default kept
    reset_config()
    assert get_config().flash_threshold == 128 and get_config().flash_min_tokens == 2048
    with pytest.raises(ValueError, match="Unknown config key"):
        get_config().update(no_such_knob=1)


def test_padding_mask_to_lens_bias_matches_jax():
    keep = np.ones((3, 10), bool)
    keep[0, 7:] = False
    keep[1, [2, 5]] = False
    keep[2] = False
    lens, bias = padding_mask_to_lens_bias(torch.from_numpy(keep))
    ref_lens, ref_bias = jax_lens_bias(jnp.asarray(keep))
    assert lens.dtype == torch.int32 and bias.dtype == torch.float32
    assert np.array_equal(lens.numpy(), np.asarray(ref_lens))
    assert np.array_equal(bias.numpy(), np.asarray(ref_bias))


def test_flash_route_key_padding_gradients_match_jax():
    """Key padding as kv_lens + k_bias stays on the flash route and
    differentiates through the masked core: dq, dk, dv and the k_bias
    gradient against ``jax.grad`` of the JAX dispatch (bound 1e-5,
    dk_bias 1e-4)."""
    arrs = _qkv(2, 64)
    rng = np.random.default_rng(11)
    keep = rng.random((2, 64)) > 0.25
    keep[:, 0] = True
    keep[1, 40:] = False
    lens, bias = padding_mask_to_lens_bias(torch.from_numpy(keep))
    g = rng.standard_normal(arrs[0].shape).astype(np.float32)

    def jax_loss(q, k, v, b):
        out, _ = jax_dispatch(q, k, v, causal=True, kv_lens=jnp.asarray(lens.numpy()), k_bias=b)
        return jnp.sum(out * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(bias.numpy()))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs] + [bias.requires_grad_()]
    out, _ = dispatch_attention(*leaves[:3], causal=True, kv_lens=lens, k_bias=leaves[3])
    (out * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv", "dk_bias"), leaves, want):
        assert rel_err_norm(t.grad.numpy(), w) <= (1e-4 if name == "dk_bias" else 1e-5), name


def test_data_pipeline_yields_every_batch_as_tensors():
    src = ({"x": np.full((2, 2), i)} for i in range(5))
    with DataPipeline(src, prefetch=2, device="cpu") as pipe:
        got = list(pipe)
    assert [int(b["x"][0, 0]) for b in got] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu" for b in got)


def test_data_pipeline_reraises_a_source_error():
    def bad():
        yield {"x": np.zeros((1,))}
        raise RuntimeError("boom")

    it = iter(DataPipeline(bad(), device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
