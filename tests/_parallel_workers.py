"""The worker side of the port's multi-rank tests on the CPU (no JAX here).

``run_world`` spawns ``world`` processes (the ``spawn`` start method: each
starts from a fresh import), which join one gloo process group through a
``FileStore`` under the test's ``tmp_path``
(``parallel/multihost.py::initialize_multihost(device="cpu")``), run one
of the case functions below on the same inputs and save what they return.
One spawn carries every case of a world size, so a file pays the start of
its workers once. A worker that raises writes its traceback; the others
are then stopped, and ``run_world`` raises with it.

Each case function takes (rank, world, inputs) and returns a tree of
tensors; the test file compares it with the JAX package's results, which
it computes in the pytest process on JAX's virtual CPU mesh.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

SPAWN_TIMEOUT_S = 300


def run_world(world: int, cases: str, inputs, tmp_path: Path) -> list:
    """Run the case function ``cases`` on ``world`` ranks: one result a
    rank, in rank order."""
    out = tmp_path / f"world{world}_{cases}"
    out.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, out / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, str(out / "store"), cases, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    errors = [(out / f"err{r}.txt").read_text() for r in range(world)
              if (out / f"err{r}.txt").exists()]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"{cases} at world {world}: exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _entry(rank: int, world: int, store: str, cases: str, out: str) -> None:
    torch.set_num_threads(1)
    try:
        from photonic_flash_attention_tpu_torch.parallel.multihost import initialize_multihost

        initialize_multihost(f"file://{store}", world, rank, device="cpu")
        result = globals()[cases](rank, world, torch.load(os.path.join(out, "inputs.pt")))
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - a worker reports any failure, then exits
        with open(os.path.join(out, f"err{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def _leaves(case: dict, names):
    return [case[n].clone().requires_grad_() for n in names]


def _grads(fn, case: dict) -> dict:
    """Gradients of sum(fn(...) ** 2) in q, k, v (and k_bias when given)."""
    names = ["q", "k", "v"] + (["k_bias"] if "k_bias" in case else [])
    leaves = dict(zip(names, _leaves(case, names)))
    out = fn(leaves["q"], leaves["k"], leaves["v"], kv_lens=case.get("kv_lens"),
             k_bias=leaves.get("k_bias"))
    out.float().square().sum().backward()
    return {f"d{n}": t.grad for n, t in leaves.items()}


# -- ring and Ulysses ------------------------------------------------------------


def attention_cases(rank: int, world: int, inputs: dict) -> dict:
    """Ring forward and gradient cases over a (world,) seq mesh, Ulysses
    where the heads divide, and, at world 4, the ring on (2, 2) meshes."""
    from photonic_flash_attention_tpu_torch.parallel import (
        create_mesh,
        make_ring_attention,
        make_ulysses_attention,
    )

    mesh = create_mesh((world,), ("seq",))
    out = {}
    for name, c in inputs["ring_fwd"].items():
        fn = make_ring_attention(mesh, data_axis=None, model_axis=None, causal=c["causal"])
        out[f"ring_fwd/{name}"] = fn(c["q"], c["k"], c["v"], kv_lens=c.get("kv_lens"),
                                     k_bias=c.get("k_bias"))
    for name, c in inputs["ring_grad"].items():
        fn = make_ring_attention(mesh, data_axis=None, model_axis=None, causal=c["causal"],
                                 differentiable=True)
        out[f"ring_grad/{name}"] = _grads(fn, c)
    for name, c in inputs["ulysses"].items():
        uly = make_ulysses_attention(mesh, data_axis=None, causal=c["causal"])
        ring = make_ring_attention(mesh, data_axis=None, model_axis=None, causal=c["causal"])
        kw = dict(kv_lens=c.get("kv_lens"), k_bias=c.get("k_bias"))
        out[f"ulysses/{name}"] = uly(c["q"], c["k"], c["v"], **kw)
        out[f"ulysses_ring/{name}"] = ring(c["q"], c["k"], c["v"], **kw)
        out[f"ulysses_grad/{name}"] = _grads(uly, c)
    for name, c in inputs.get("mesh2d", {}).items():
        mesh2 = create_mesh((2, 2), c["axes"])
        fn = make_ring_attention(mesh2, causal=True)
        out[f"mesh2d/{name}"] = fn(c["q"], c["k"], c["v"])
    return out


# -- pipeline, meshes, errors, engine, telemetry -----------------------------------


def _raises(fn) -> str:
    """The type and message of what ``fn`` raises ('' when nothing)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares the type with JAX's
        return f"{type(e).__name__}: {e}"
    return ""


def misc_cases(rank: int, world: int, inputs: dict) -> dict:
    """The pipeline at ``world`` stages, the mesh and multihost surface, the
    DistributionError cases, the engine's RING/ULYSSES and the telemetry."""
    from photonic_flash_attention_tpu_torch.config import reset_config, set_global_config
    from photonic_flash_attention_tpu_torch.core.engine import AttentionEngine
    from photonic_flash_attention_tpu_torch.core.router import AdaptiveRouter
    from photonic_flash_attention_tpu_torch.parallel import create_mesh, make_pipeline
    from photonic_flash_attention_tpu_torch.parallel.mesh import axis_index, mesh_shape
    from photonic_flash_attention_tpu_torch.parallel.multihost import (
        initialize_multihost,
        pod_mesh,
        process_summary,
    )
    from photonic_flash_attention_tpu_torch.parallel.telemetry import get_telemetry
    from photonic_flash_attention_tpu_torch.parallel.ulysses import make_ulysses_attention

    out = {}
    stage = create_mesh((world,), ("stage",))
    for name, c in inputs["pipeline"].items():
        pipe = make_pipeline(stage, lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                             num_microbatches=c["m"])
        out[f"pipeline/{name}"] = pipe({"w": c["w"], "b": c["b"]}, c["x"])
    pipe = make_pipeline(stage, lambda p, x: x @ p, num_microbatches=3)
    w = inputs["pipeline"]["m4"]["w"]
    out["errors/pipeline_batch"] = _raises(lambda: pipe(w, torch.zeros(4, w.shape[1])))
    out["errors/pipeline_stages"] = _raises(lambda: pipe(w[:1], torch.zeros(3, w.shape[1])))
    out["errors/pipeline_axis"] = _raises(lambda: make_pipeline(stage, lambda p, x: x, 2,
                                                                stage_axis="nope"))
    out["errors/two_minus_one"] = _raises(lambda: create_mesh((-1, -1), ("a", "b")))
    out["errors/not_covering"] = _raises(lambda: create_mesh((world + 1,), ("a",)))
    out["errors/rank_mismatch"] = _raises(lambda: create_mesh((world, 1), ("a",)))
    seq = create_mesh((world,), ("seq",))
    q = torch.zeros(1, 64 * world, 2 * world + 1, 16)
    out["errors/ulysses_heads"] = _raises(
        lambda: make_ulysses_attention(seq, data_axis=None)(q, q, q))
    out["errors/ulysses_kv_heads"] = _raises(
        lambda: make_ulysses_attention(seq, data_axis=None)(
            torch.zeros(1, 64 * world, world, 16), torch.zeros(1, 64 * world, 1, 16),
            torch.zeros(1, 64 * world, 1, 16)))
    out["errors/ulysses_axis"] = _raises(lambda: make_ulysses_attention(stage))
    out["mesh/minus_one"] = mesh_shape(create_mesh((-1, 1), ("data", "model")))
    out["mesh/default"] = mesh_shape(create_mesh())
    out["mesh/index"] = axis_index(create_mesh((1, world), ("data", "model")), "model")
    out["mesh/pod"] = mesh_shape(pod_mesh((-1,), ("data",), dcn_axis="data"))
    out["multihost/again"] = initialize_multihost(device="cpu")
    out["multihost/summary"] = process_summary()

    # The engine: RING and ULYSSES join the registry on a seq mesh.
    set_global_config(auto_kernel_selection=False, ring_threshold=256)
    try:
        eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))
        c = inputs["engine"]
        eng.set_mesh(seq, seq_axis="seq")
        got, _ = eng(c["q"], c["k"], c["v"], causal=True)
        out["engine/ring"] = (eng.last_kernel_used, got)
        from photonic_flash_attention_tpu_torch.core.router import (
            KernelKind,
            WorkloadCharacteristics,
        )

        b, s, h, d = c["q"].shape
        wl = WorkloadCharacteristics(batch_size=b, q_len=s, kv_len=s, num_heads=h, head_dim=d,
                                     causal=True, dtype="float32", num_kv_heads=h)
        out["engine/kinds"] = [k.value for k in eng._available_kernels(wl)]
        set_global_config(auto_kernel_selection=True)
        for kind, ms in ((KernelKind.FUSED, 5.0), (KernelKind.FLASH, 3.0),
                         (KernelKind.FLASH_UNROLLED, 2.5), (KernelKind.RING, 2.0),
                         (KernelKind.ULYSSES, 1.0)):
            eng.router.record_measurement(kind, wl, ms)
        got, _ = eng(c["q"], c["k"], c["v"], causal=True)
        out["engine/ulysses"] = (eng.last_kernel_used, got)
        eng.set_mesh(seq, seq_axis="seq")  # a new mesh drops the callables
        out["engine/cache_after_set_mesh"] = len(eng._seq_fns)
        eng.clear_mesh()
        out["engine/kinds_cleared"] = [k.value for k in eng._available_kernels(wl)]
    finally:
        reset_config()
    tel = get_telemetry()
    out["telemetry"] = tel.get_stats()
    return out


# -- training ----------------------------------------------------------------------


def training_cases(rank: int, world: int, inputs: dict) -> dict:
    """GPT-2 tiny, 3 AdamW steps on (data 2), (model 2) and data-only meshes
    from the same init; sequence parallel through the trainer on (model 1,
    seq 2) with specs (Ulysses: 4 heads over 2 ranks) and on (data 1, seq
    2) without them (ring: 1 head), with the engine's mesh set after the
    trainer is built, and the telemetry's collectives of each; a sharded
    checkpoint round trip on (model 2)."""
    from photonic_flash_attention_tpu_torch.config import set_global_config
    from photonic_flash_attention_tpu_torch.core.checkpoint import CheckpointManager
    from photonic_flash_attention_tpu_torch.core.engine import get_engine
    from photonic_flash_attention_tpu_torch.models.gpt2 import (
        GPT2Config,
        GPT2LMHead,
        param_sharding_rules,
    )
    from photonic_flash_attention_tpu_torch.parallel import create_mesh
    from photonic_flash_attention_tpu_torch.parallel.telemetry import get_telemetry
    from photonic_flash_attention_tpu_torch.training.trainer import Trainer

    set_global_config(**inputs["config"])
    base_cfg = dataclasses.replace(GPT2Config.tiny(), **inputs["cfg"])

    def trainer(shape, names, specs: bool, cfg=base_cfg):
        model = GPT2LMHead(cfg)
        model.load_state_dict(inputs["state"])
        opt = torch.optim.AdamW(model.parameters(), **inputs["adamw"])
        mesh = create_mesh(shape, names)
        rules = param_sharding_rules(model.state_dict()) if specs else None
        return Trainer(model, opt, mesh=mesh, param_specs=rules), mesh

    def run(t, state, batches):
        metrics = []
        for b in batches:
            state, m = t.train_step(state, b)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        return state, metrics

    out = {}
    for name, shape, names, specs in (("data2", (2, 1), ("data", "model"), True),
                                      ("model2", (1, 2), ("data", "model"), True),
                                      ("data2_nospecs", (2,), ("data",), False)):
        t, _ = trainer(shape, names, specs)
        _, out[name] = run(t, t.init_state(), inputs["batches"])
    # Sequence parallel: the engine's mesh, set after the trainer is built,
    # has a seq axis of 2 ranks.
    tel = get_telemetry()
    ring_cfg = dataclasses.replace(base_cfg, **inputs["ring_cfg"])
    for name, shape, names, specs, cfg in (
            ("seq2", (1, 2), ("model", "seq"), True, base_cfg),
            ("data_seq2_ring", (1, 2), ("data", "seq"), False, ring_cfg)):
        t, mesh = trainer(shape, names, specs, cfg)
        get_engine().set_mesh(mesh, seq_axis="seq")
        tel.reset()
        try:
            _, out[name] = run(t, t.init_state(), inputs["seq_batches"])
        finally:
            get_engine().clear_mesh()
        out[f"{name}/collectives"] = dict(tel.get_stats()["axes"].get("seq", {}).get("by_op", {}))
    # Sharded checkpoint: 2 steps, save, restore into a fresh trainer, step 3.
    t, mesh = trainer((1, 2), ("data", "model"), True)
    state, first = run(t, t.init_state(), inputs["batches"][:2])
    mgr = CheckpointManager(inputs["ckpt_dir"])
    mgr.save(2, {"model": t.model.state_dict(), "optimizer": t.optimizer.state_dict()},
             mesh=mesh)
    t2, mesh2 = trainer((1, 2), ("data", "model"), True)
    saved = mgr.restore(mesh=mesh2)["params"]
    t2.model.load_state_dict(saved["model"])
    t2.optimizer.load_state_dict(saved["optimizer"])
    state2 = t2.init_state()
    state2.step = 2
    _, last = run(t2, state2, inputs["batches"][2:])
    out["resumed"] = first + last
    out["unsharded_restore"] = _raises(lambda: mgr.restore())
    return out


# -- serving -----------------------------------------------------------------------


def serving_cases(rank: int, world: int, inputs: dict) -> dict:
    """Tokens of the GPT-2 tiny engine on a (1, world) mesh and unsharded:
    float and int8 pools, chunked prefill, sampling; the sharded
    save/restore round trip."""
    from photonic_flash_attention_tpu_torch.core.serving import ServingEngine
    from photonic_flash_attention_tpu_torch.models.gpt2 import GPT2Config
    from photonic_flash_attention_tpu_torch.parallel import create_mesh

    mesh = create_mesh((1, world), ("data", "model"))
    cfg = dataclasses.replace(GPT2Config.tiny(), dtype=inputs["dtype"])
    state = inputs["state"]
    out = {}
    for name, kw in inputs["cases"].items():
        base = dict(device="cpu", num_pages=64, page_size=16, max_batch=2, **kw)
        prompts, n_new = inputs["prompts"][name], inputs["n_new"]
        out[f"sharded/{name}"] = ServingEngine(cfg, state, mesh=mesh, **base).generate(
            prompts, max_new_tokens=n_new)
        out[f"unsharded/{name}"] = ServingEngine(cfg, state, **base).generate(
            prompts, max_new_tokens=n_new)
    # Save mid-generation, restore with and without the mesh, finish.
    kw = dict(device="cpu", num_pages=64, page_size=16, max_batch=2, kv_dtype=torch.int8)
    eng = ServingEngine(cfg, state, mesh=mesh, **kw)
    sids = [eng.submit(p, inputs["n_new"]) for p in inputs["prompts"]["bf16"]]
    eng.step()
    eng.save(inputs["ckpt_dir"])
    out["restore/no_mesh"] = _raises(
        lambda: ServingEngine.restore(inputs["ckpt_dir"], cfg, state, device="cpu"))
    eng2 = ServingEngine.restore(inputs["ckpt_dir"], cfg, state, device="cpu", mesh=mesh)
    out["restore/files"] = sorted(os.listdir(inputs["ckpt_dir"]))
    for e in (eng, eng2):
        while any(not e._sequences[s].done for s in sids):
            e.step()
    out["restore/uninterrupted"] = [eng._sequences[s].tokens for s in sids]
    out["restore/resumed"] = [eng2._sequences[s].tokens for s in sids]
    out["indivisible"] = _raises(lambda: ServingEngine(
        dataclasses.replace(cfg, n_head=3), state, mesh=mesh, device="cpu"))
    return out
