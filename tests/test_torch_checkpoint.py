"""The port's checkpoints against the JAX package's.

The cases of ``tests/unit/test_checkpoint.py`` run on the port
(``CheckpointManager`` over ``torch.save`` trees, engine state, the KV
cache); a cache written by JAX's ``save_kv_cache`` (token-minor pools, no
``layout`` key) restores in the port with an equal ``gather_kv``; engine
state saved from a JAX engine loads into the port's; and a GPT-2 tiny
trainer resumed from a checkpoint takes the uninterrupted run's third step.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core.checkpoint import (
    engine_state_dict as jax_engine_state_dict,
    save_kv_cache as jax_save_kv_cache,
)
from photonic_flash_attention_tpu.core.engine import AttentionEngine as JaxEngine
from photonic_flash_attention_tpu.core.kv_cache import PagedKVCache as JaxCache
from photonic_flash_attention_tpu.core.router import AdaptiveRouter as JaxRouter
from photonic_flash_attention_tpu_torch.core.checkpoint import (
    CheckpointManager,
    engine_state_dict,
    restore_engine_state,
    restore_kv_cache,
    save_kv_cache,
)
from photonic_flash_attention_tpu_torch.core.engine import AttentionEngine
from photonic_flash_attention_tpu_torch.core.kv_cache import PagedKVCache
from photonic_flash_attention_tpu_torch.core.router import AdaptiveRouter
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from photonic_flash_attention_tpu_torch.training import Trainer, synthetic_lm_batches
from photonic_flash_attention_tpu_torch.utils.exceptions import CheckpointError


def make_params(rng):
    return {
        "layer": {
            "kernel": torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)),
            "bias": torch.zeros(8),
        },
        "head": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).bfloat16(),
    }


def _assert_trees_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


# -- CheckpointManager (tests/unit/test_checkpoint.py::TestCheckpointManager) --


def test_save_restore_roundtrip(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    params = make_params(rng)
    mgr.save(10, params, metadata={"note": "test"})
    out = mgr.restore(target="cpu")
    assert out["meta"]["step"] == 10 and out["meta"]["note"] == "test"
    assert out["engine_state"] is None
    _assert_trees_equal(out["params"], params)


def test_latest_and_specific_step(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    p1, p2 = make_params(rng), make_params(rng)
    mgr.save(1, p1)
    mgr.save(2, p2)
    assert mgr.latest_step() == 2
    assert torch.equal(mgr.restore(step=1)["params"]["head"], p1["head"])
    assert torch.equal(mgr.restore()["params"]["head"], p2["head"])


def test_retention(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, make_params(rng))
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]


def test_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(CheckpointError):
        mgr.restore()
    os.makedirs(tmp_path / "step_3")
    with pytest.raises(CheckpointError, match="incomplete"):
        mgr.restore(step=3)


def test_incomplete_checkpoint_ignored(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, make_params(rng))
    # a crashed save: the directory exists, meta.json is missing
    os.makedirs(tmp_path / "step_9", exist_ok=True)
    (tmp_path / "step_9" / "params.pt.tmp").write_bytes(b"partial")
    assert mgr.latest_step() == 5
    assert not [n for n in os.listdir(tmp_path / "step_5") if n.endswith(".tmp")]


# -- engine state ---------------------------------------------------------------


def _port_engine():
    return AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))


def test_engine_state_roundtrip(tmp_path, rng):
    eng = _port_engine()
    q = torch.from_numpy(rng.standard_normal((1, 128, 4, 64)).astype(np.float32))
    for _ in range(3):
        eng(q, q, q)
    state = engine_state_dict(eng)
    assert state["router_latency"] and state["version"] == 1
    eng2 = _port_engine()
    restore_engine_state(eng2, state)
    assert engine_state_dict(eng2)["router_latency"] == state["router_latency"]
    # through the manager, as JSON
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(2)}, engine_state=state)
    assert mgr.restore()["engine_state"] == json.loads(json.dumps(state))


def test_jax_engine_state_loads_into_the_port(rng):
    jeng = JaxEngine(router=JaxRouter(exploration_rate=0.0, seed=0))
    q = jnp.asarray(rng.standard_normal((1, 128, 4, 64)), jnp.float32)
    jeng(q, q, q)
    state = json.loads(json.dumps(jax_engine_state_dict(jeng)))
    measured = {kind: table for kind, table in state["router_latency"].items() if table}
    assert measured
    eng = _port_engine()
    restore_engine_state(eng, state)
    assert engine_state_dict(eng)["router_latency"] == measured


# -- the KV cache -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_kv_cache_roundtrip(tmp_path, rng, dtype):
    cache = PagedKVCache(num_pages=16, page_size=8, num_kv_heads=2, head_dim=16, dtype=dtype,
                         device="cpu")
    sid = cache.allocate_sequence()
    k = torch.from_numpy(rng.standard_normal((20, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((20, 2, 16)).astype(np.float32))
    cache.append(sid, k, v)
    k_orig, v_orig = cache.gather_kv(sid)

    p = str(tmp_path / "kv")
    save_kv_cache(cache, p)
    with open(os.path.join(p, "tables.json")) as f:
        assert json.load(f)["layout"] == "token_major"
    restored = restore_kv_cache(p, device="cpu")
    assert restored.sequence_length(sid) == 20
    k_new, v_new = restored.gather_kv(sid)
    assert torch.equal(k_orig, k_new) and torch.equal(v_orig, v_new)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(cache, name), getattr(restored, name)
        assert (a is None and b is None) or torch.equal(a, b)
    # allocation state also restored: new sequences don't collide
    sid2 = restored.allocate_sequence(8)
    assert sid2 != sid
    assert not set(restored._sequences[sid2].page_ids) & set(restored._sequences[sid].page_ids)
    assert restored.get_memory_stats()["sequences"] == 2


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_jax_saved_cache_restores_in_the_port(tmp_path, dtype):
    jdt = {"bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    rng = np.random.default_rng(11)
    jc = JaxCache(num_pages=16, page_size=8, num_kv_heads=2, head_dim=16, dtype=jdt)
    sids = [jc.allocate_sequence() for _ in range(3)]
    for sid, n in zip(sids, (20, 3, 9)):
        jc.append(sid, jnp.asarray(rng.standard_normal((n, 2, 16)), jnp.float32),
                  jnp.asarray(rng.standard_normal((n, 2, 16)), jnp.float32))
    jc.free_sequence(sids[1])
    p = str(tmp_path / "jax_kv")
    jax_save_kv_cache(jc, p)

    tc = restore_kv_cache(p, device="cpu")
    assert tc.k_pages.shape == (2, 16, 8, 16)  # token-major
    for sid in (sids[0], sids[2]):
        for got, want in zip(tc.gather_kv(sid), jc.gather_kv(sid)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = [sids[0], sids[2]]
    for got, want in zip(tc.page_table(live), jc.page_table(live)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tc._free == jc._free and tc._next_seq_id == jc._next_seq_id
    # (JAX's file keeps no allocation counters, so neither restore has them.)
    counters = ("alloc_count", "free_count", "oom_events", "peak_pages_used")
    jstats = jc.get_memory_stats()
    assert {k: v for k, v in tc.get_memory_stats().items() if k not in counters} == {
        k: v for k, v in jstats.items() if k not in counters}


# -- training resume --------------------------------------------------------------


def _trainer(cfg, state=None):
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    if state is not None:
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optimizer"])
    return Trainer(model, opt)


def test_trainer_resumes_at_step_three(tmp_path):
    cfg = dataclasses.replace(GPT2Config.tiny(), n_layer=1)
    batch = next(synthetic_lm_batches(batch=1, seq=16, vocab=cfg.vocab_size, seed=0))
    ref = _trainer(cfg)
    state = ref.init_state()
    for _ in range(3):
        state, metrics = ref.train_step(state, batch)
    want_loss, want_params = float(metrics["loss"]), ref.model.state_dict()

    run = _trainer(cfg)
    state = run.init_state()
    for _ in range(2):
        state, _ = run.train_step(state, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, {"model": run.model.state_dict(),
                          "optimizer": run.optimizer.state_dict(), "step": state.step})
    del run, state

    saved = mgr.restore(target="cpu")["params"]
    resumed = _trainer(cfg, saved)
    state = resumed.init_state()
    state.step = saved["step"]
    state, metrics = resumed.train_step(state, batch)
    assert state.step == 3
    assert float(metrics["loss"]) == want_loss
    for name, t in resumed.model.state_dict().items():
        assert torch.equal(t, want_params[name]), name
