"""The decode window: JAX's occupancy-bucketed page tables, resume, caches.

For GPT-2, Llama (GQA: 8 query heads over 2 KV heads) and T5 tiny, weights
from the JAX inits through ``models/from_jax.py``: one request stream whose
longest sequence crosses page buckets, with retirements and admissions
between windows, served by the JAX engine and by the port on the CPU. The
page-table width of every window (the JAX engine's logged from the
``tables_in`` its ``_window`` receives, the port's from the table its
eager window receives) and the greedy tokens must be equal. Then, port
only: a save just before a width change resumes to the uninterrupted
tokens (greedy and sampled), the width tables refresh in place, and
``clear_plan_caches()`` drops the engine's window state. The replay
accounting of ``ops/_build.py`` is pure ``Counter`` arithmetic, tested
here; the card's graphs are held against the eager window by
``chip_smoke.py``.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photonic_flash_attention_tpu.core.serving import ServingEngine as JaxEngine
from photonic_flash_attention_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from photonic_flash_attention_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from photonic_flash_attention_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from photonic_flash_attention_tpu.models.llama import LlamaForCausalLM as JaxLlama
from photonic_flash_attention_tpu.models.t5 import T5Config as JaxT5Config
from photonic_flash_attention_tpu.models.t5 import T5ForConditionalGeneration as JaxT5
from photonic_flash_attention_tpu_torch.core.error_recovery import clear_plan_caches
from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
from photonic_flash_attention_tpu_torch.models.from_jax import (
    llama_params_from_jax,
    params_from_jax,
    t5_params_from_jax,
)
from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config
from photonic_flash_attention_tpu_torch.models.llama import LlamaConfig
from photonic_flash_attention_tpu_torch.models.t5 import T5Config
from photonic_flash_attention_tpu_torch.ops import _build

#: Two slots, five requests: three are admitted as others retire. The
#: width goes from 1 page to 2 and 4 (the 40-token prompt), then back.
PROMPT_LENS = (3, 5, 20, 40, 9)
NEW_TOKENS = (4, 6, 12, 12, 7)
ENGINE = dict(num_pages=64, page_size=16, max_batch=2, max_pages_per_seq=8, decode_window=4)
SAMPLING = dict(temperature=0.8, top_k=20, seed=1234)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt2():
    jcfg = dataclasses.replace(JaxGPT2Config.tiny(), dtype=jnp.float32)
    params = JaxGPT2(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
    return jcfg, params, tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, params)), {}


def _llama():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32)
    params = JaxLlama(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    return jcfg, params, tcfg, llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params)), {}


def _t5():
    jcfg = JaxT5Config.tiny()
    params = JaxT5(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                              jnp.zeros((1, 4), jnp.int32))["params"]
    state = t5_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, T5Config.tiny(), state, {"enc_max_len": 64}


FAMILIES = {"gpt2": _gpt2, "llama": _llama, "t5": _t5}


def _prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(2, 512, n).tolist() for n in PROMPT_LENS]


def _submit_all(eng):
    return [eng.submit(p, n) for p, n in zip(_prompts(), NEW_TOKENS)]


def _drain(eng, sids):
    while not all(eng._sequences[s].done for s in sids):
        assert eng.step() > 0
    return [eng._sequences[s].tokens[eng._sequences[s].prompt_len:] for s in sids]


def _log_port_widths(eng):
    """Record the width of every table the port's eager window receives."""
    widths, run = [], eng._window_eager

    def logged(win, tables, n_steps, do_sample):
        widths.append(tables.shape[1])
        return run(win, tables, n_steps, do_sample)

    eng._window_eager = logged
    return widths


@pytest.fixture(scope="module")
def families():
    """Each family's (JAX cfg, JAX params, port cfg, port state_dict, extra
    engine arguments), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = FAMILIES[name]()
        return cache[name]

    return get


def _port(families, name, **kw):
    _, _, tcfg, state, extra = families(name)
    return ServingEngine(tcfg, state, device="cpu", **ENGINE, **extra, **kw)


@pytest.fixture(scope="module")
def runs(families):
    """Per family, the JAX engine's and the port's (widths, greedy tokens)
    over the request stream; the JAX engine's widths from the ``tables_in``
    each call of its ``_window`` receives."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, params, _, _, extra = families(name)
            jeng = JaxEngine(jcfg, params, **ENGINE, **extra)
            jwidths, window = [], jeng._window

            def logged(*args, **kwargs):
                jwidths.append(args[3].shape[1])
                return window(*args, **kwargs)

            jeng._window = logged
            jax_toks = _drain(jeng, _submit_all(jeng))
            eng = _port(families, name)
            widths = _log_port_widths(eng)
            cache[name] = {"jax": (jwidths, jax_toks), "port": (widths, _drain(eng, _submit_all(eng)))}
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_widths_match_jax(runs, name):
    jwidths, _ = runs(name)["jax"]
    widths, _ = runs(name)["port"]
    assert widths == jwidths
    # The stream crosses buckets: three widths at least, and the tables
    # narrow again after the long request retires.
    assert len(set(widths)) >= 3
    assert any(b < a for a, b in zip(widths, widths[1:]))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_greedy_tokens_match_jax(runs, name):
    _, jax_toks = runs(name)["jax"]
    _, toks = runs(name)["port"]
    assert [len(t) for t in toks] == list(NEW_TOKENS)
    assert toks == jax_toks


def _steps_before_width_change(families, name, **kw):
    """The number of ``step()`` calls after which the next window changes
    the width: each call's width logged (None without a window)."""
    eng = _port(families, name, **kw)
    sids = _submit_all(eng)
    widths = _log_port_widths(eng)
    per_step = []
    while not all(eng._sequences[s].done for s in sids):
        n = len(widths)
        eng.step()
        per_step.append(widths[-1] if len(widths) > n else None)
    seen = [(i, w) for i, w in enumerate(per_step) if w is not None]
    return next(i for (_, a), (i, b) in zip(seen, seen[1:]) if a != b)


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_save_before_width_change_resumes(families, name, sample, tmp_path):
    kw = SAMPLING if sample else {}
    eng = _port(families, name, **kw)
    want = _drain(eng, _submit_all(eng))
    steps = _steps_before_width_change(families, name, **kw)
    eng = _port(families, name, **kw)
    sids = _submit_all(eng)
    for _ in range(steps):
        eng.step()
    eng.save(str(tmp_path))
    _, _, tcfg, state, _ = families(name)
    eng2 = ServingEngine.restore(str(tmp_path), tcfg, state, device="cpu")
    assert eng2._win is None and not eng2._graphs
    assert _drain(eng2, sids) == want


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_width_tables_refresh_in_place(families, name):
    eng = _port(families, name)
    sids = _submit_all(eng)
    eng.step()
    ptrs = {w: t.data_ptr() for w, t in eng._win.tables.items()}
    _drain(eng, sids)
    sid = eng.submit(_prompts()[0], 8)
    eng.step()  # admission after every retirement: the tables refresh
    seq = eng._sequences[sid]
    want = np.zeros((ENGINE["max_batch"], ENGINE["max_pages_per_seq"]), np.int32)
    want[seq.slot, : len(seq.page_ids)] = seq.page_ids
    assert len(eng._win.tables) >= 3
    for w, t in eng._win.tables.items():
        assert t.is_contiguous() and t.shape == (ENGINE["max_batch"], w)
        np.testing.assert_array_equal(t.numpy(), want[:, :w])
        if w in ptrs:
            assert t.data_ptr() == ptrs[w]
    assert eng.window_graph_stats() == {"graphs": 0, "capture_ms": [], "pool_bytes": 0}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_clear_plan_caches_drops_window_state(families, runs, name):
    eng = _port(families, name)
    sids = _submit_all(eng)
    for _ in range(3):
        eng.step()
    assert eng._win is not None and eng._win.tables
    clear_plan_caches()
    assert eng._win is None and not eng._graphs and eng._tables_dirty
    assert _drain(eng, sids) == runs(name)["port"][1]


def test_replay_launches_arithmetic():
    captured = collections.Counter({"pfa_paged_decode_fused": 24, "pfa_softmax": 1, "idle": 0})
    assert _build.replay_launches(captured, 31) == {"pfa_paged_decode_fused": 744,
                                                    "pfa_softmax": 31}
    assert _build.replay_launches(captured, 0) == {}
    assert _build.replay_launches({}, 5) == {}
    with pytest.raises(ValueError):
        _build.replay_launches(captured, -1)


def test_count_replays_adds_to_launches():
    saved = collections.Counter(_build.LAUNCHES), collections.Counter(_build.CAPTURED)
    try:
        _build.reset_launches()
        _build.LAUNCHES["pfa_paged_decode_fused"] = 2  # the window's eager first step
        _build.CAPTURED["pfa_paged_decode_fused"] = 2  # its capture
        _build.count_replays(collections.Counter(_build.CAPTURED), 3)
        assert _build.LAUNCHES == {"pfa_paged_decode_fused": 8}
        assert _build.CAPTURED == {"pfa_paged_decode_fused": 2}
    finally:
        _build.reset_launches()
        _build.LAUNCHES.update(saved[0])
        _build.CAPTURED.update(saved[1])
