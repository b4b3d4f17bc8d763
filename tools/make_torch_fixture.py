"""Write the fixtures that the PyTorch port is held against.

The port (``src/repro_torch``) has no truth-table compiler yet and never
imports JAX, so it serves a level-3 artifact that the reference package
compiled.  This tool makes that artifact and the reference outputs it is
compared with, from fixed seeds:

* ``model_a_l3.npz`` — ``repro.engine.CompiledLUTNet.save`` of fpga4hep
  model A generated the way ``python -m repro.launch.serve --lut`` does
  (``LN.init`` at PRNGKey(0), one ``train=True`` forward over 256 rows
  drawn at PRNGKey(1), ``generate_tables``, ``compile_network`` at
  optimize level 3) with ``block_b=16``;
* ``model_a_ref.npz`` (compressed) — the three raw ``(idx, table, bw_in)``
  triples, 4096 seeded input codes in ``[0, 8)`` (row 0 all 0, row 1
  all 7), and the reference outputs of the mixed (level-3), uniform
  (``compile_network(triples)``) and per-layer
  (``compile_network(triples, fused=False)``) artifacts on those codes;
* ``model_a_train.npz`` (compressed) — the training flow on
  ``jet_substructure_data(8000, 0)`` (rows ``[:7000]`` train, ``[7000:]``
  held out): model A's ``LN.init(cfg, PRNGKey(0), mask_seed=0)``
  (``init.<layer>.<leaf>``), the losses (``losses``) and final model
  (``trained.<layer>.<leaf>``) of ``train_logicnet(apriori, steps=20,
  batch=256, lr=1e-2, seed=0)``, its ``generate_tables``
  (``table_<i>`` / ``idx_<i>``), ``verify_tables``' float-path codes on
  the first 200 held-out rows (``verify_codes``), and the held-out
  accuracy of a 600-step run (``accuracy_600``).  Models are stored as
  ``repro_torch.core.logicnet.reference_to_arrays`` flattens them;
* ``lm_smoke.npz`` (compressed) — for the qwen3-1.7b and gemma3-27b smoke
  configs (``<arch>.`` prefix): the reference's ``init_params`` at
  PRNGKey(0) flattened with dotted names (``params.<name>``, as
  ``repro_torch.models.model.from_reference`` takes them), seeded tokens
  ``(2, 64)``, and at float32 and bfloat16 compute (``<dtype>.`` prefix):
  ``forward`` logits on all 64 positions (``prefill``), teacher-forced
  ``decode_step`` logits over the first 12 tokens into a 12-slot cache
  held in the compute dtype (``decode``; ``init_cache``'s bfloat16 cache
  would round k and v to bfloat16 at float32 compute too, and one float32
  rounding step there may move a value by one bfloat16 step), and the
  tokens of every request of the decode loop of ``examples/serve_lm.py``
  run with ``--requests 5 --slots 2 --max-new 6 --cache-len 64``
  (``serve_ids`` in finishing order, ``serve_out`` their tokens);
* ``lm_smoke_moe_ssm.npz`` (compressed) — the same record as
  ``lm_smoke.npz`` for the smoke configs of the MoE and SSM families
  (olmoe-1b-7b, qwen3-moe-235b-a22b, mamba2-370m, zamba2-2.7b), with each
  run's MoE ``capacity_factor`` (``<arch>.<dtype>.capacity_factor``; 0
  without MoE): the config's own (1.25, so decode drops (token, k) pairs)
  at float32, and E / k at bfloat16, where no pair is dropped, so that a
  router choice that one bfloat16 step of noise can flip (a near-tie)
  moves only its own token and the ones that attend to it, not every
  later token of its group.  Only the KV leaves of the decode cache are
  held in the compute dtype; an SSM layer's state stays float32, as
  ``init_cache`` makes it.  The serve loop recycles slots, so an SSM
  slot starts its next request from the previous one's state, as the
  reference's does.  A MoE run also holds the reference's router choices
  (the top-k experts, int8, in its order): ``prefill_topi`` (layers, 2,
  64, K) of the ``prefill`` run and ``decode_topi`` (layers, 2, 12, K) of
  the ``decode`` run, recorded in those same runs (:func:`router_choices`);
* ``lm_smoke_encdec_vlm.npz`` (compressed) — for the whisper-medium and
  qwen2-vl-2b smoke configs: the params and tokens ``(2, 64)`` as above,
  seeded bfloat16 inputs of the stub frontends (``frames`` (2, 16, 64) for
  whisper, ``vision_embeds`` (2, 16, 64) for qwen2-vl, stored as float32),
  and at each compute dtype: ``forward`` logits on all 64 positions
  (``prefill``; qwen2-vl's also without ``vision_embeds``,
  ``prefill_text``), whisper's encoder memory (``memory``: the float32
  output of ``_forward_encoder``), and 8 teacher-forced ``decode_step``
  logits (``decode``) with their greedy tokens (``decode_tokens``) from a
  cache whose ``k`` / ``v`` are held in the compute dtype and whose
  ``mem_k`` / ``mem_v`` (bfloat16, as ``init_cache`` makes them) hold each
  decoder layer's ``cross_memory`` of that memory, as the reference's
  ``_forward_encdec`` computes them: nothing in the reference fills them;
* ``model_d_ref.npz`` (compressed) — fpga4hep model D (Table 6.1: 16 ->
  64 -> 32 -> 32 sparse at fan-in 5, 2-bit codes, then a sparse 5-neuron
  head at fan-in 6 with 4-bit outputs; full widths) generated as model A
  is (``model_a_tables``' recipe): its four raw ``(idx, table, bw_in)``
  triples, 4096 seeded input codes in ``[0, 4)`` (row 0 all 0, row 1 all
  3), and the reference outputs on them of the layout the reference's
  engine picks, ``uniform`` (``compile_network(triples)``: the slabs fit
  its 8 MiB budget), and of ``per_layer`` (``fused=False``).  Rows are
  independent, so the first ``b`` rows of an output are the reference's
  output at batch ``b``.

Run from the repo root (JAX on the CPU runs the Pallas kernels in
interpret mode)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/make_torch_fixture.py

``--only model_d`` writes ``model_d_ref.npz`` alone, ``--only
lm_moe_ssm`` ``lm_smoke_moe_ssm.npz`` and ``--only lm_encdec_vlm``
``lm_smoke_encdec_vlm.npz`` (regenerating ``model_a_l3.npz`` rewrites
its pass timings).

``tests/test_torch_engine.py`` regenerates each in memory and asserts
they equal the committed files, so the fixture cannot drift from the
reference.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures", "torch_port")
ARTIFACT_NAME = "model_a_l3.npz"
REF_NAME = "model_a_ref.npz"
MODEL_D_NAME = "model_d_ref.npz"
TRAIN_NAME = "model_a_train.npz"
LM_NAME = "lm_smoke.npz"
LM_ARCHS = ("qwen3-1.7b", "gemma3-27b")
LM_MOE_SSM_NAME = "lm_smoke_moe_ssm.npz"
LM_MOE_SSM_ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b", "mamba2-370m",
                    "zamba2-2.7b")
LM_ENCDEC_VLM_NAME = "lm_smoke_encdec_vlm.npz"
LM_ENCDEC_VLM_ARCHS = ("whisper-medium", "qwen2-vl-2b")
LM_ENCDEC_DECODE = 8
KV_LEAVES = ("k", "v", "shared_k", "shared_v")
LM_DTYPES = ("float32", "bfloat16")
LM_SEQ = 64            # a multiple of both smoke configs' attn_chunk
LM_DECODE = 12
LM_SERVE = {"requests": 5, "slots": 2, "max_new": 6, "cache_len": 64}
TRAIN_STEPS = 20
LONG_STEPS = 600
N_VERIFY = 200
BLOCK_B = 16
N_CODES = 4096
CODES_SEED = 0


def model_a_tables():
    """Raw truth tables of generated model A, as ``serve --lut`` makes them."""
    return generated_tables("A")


def generated_tables(name: str):
    """Raw truth tables of fpga4hep model ``name`` generated the way
    ``serve --lut`` makes model A's."""
    import jax

    from repro.configs import fpga4hep
    from repro.core import logicnet as LN

    cfg = fpga4hep.MODELS[name]()
    model = LN.init(cfg, jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (256, cfg.in_features),
                           minval=-1, maxval=3)
    _, model = LN.forward(cfg, model, x, train=True)
    return cfg, LN.generate_tables(cfg, model)


def input_codes(n_in: int, bw: int) -> np.ndarray:
    """Seeded (N_CODES, n_in) int32 codes; rows 0 and 1 are all 0 / all max."""
    codes = np.random.default_rng(CODES_SEED).integers(
        0, 1 << bw, (N_CODES, n_in), dtype=np.int32)
    codes[0] = 0
    codes[1] = (1 << bw) - 1
    return codes


def build():
    """``(level-3 CompiledLUTNet, reference arrays dict)``, nothing written."""
    from repro import engine

    cfg, tables = model_a_tables()
    triples = [(np.asarray(t.indices, np.int32), np.asarray(t.table, np.int32),
                int(t.bw_in)) for t in tables]
    mixed = engine.compile_network(tables, optimize_level=3,
                                   in_features=cfg.in_features,
                                   block_b=BLOCK_B)
    uniform = engine.compile_network(triples, in_features=cfg.in_features,
                                     block_b=BLOCK_B)
    per_layer = engine.compile_network(triples, in_features=cfg.in_features,
                                       fused=False, block_b=BLOCK_B)
    assert (mixed.layout, uniform.layout, per_layer.layout) == (
        "mixed", "uniform", "per_layer")
    codes = input_codes(cfg.in_features, cfg.bw)
    ref = {"codes": codes, "bws": np.asarray([b for _, _, b in triples],
                                            np.int32)}
    for li, (idx, tab, _) in enumerate(triples):
        ref[f"idx_{li}"] = idx
        ref[f"table_{li}"] = tab
    for name, net in (("mixed", mixed), ("uniform", uniform),
                      ("per_layer", per_layer)):
        ref[f"out_{name}"] = np.asarray(net(codes), np.int32)
    return mixed, ref


def build_model_d() -> dict[str, np.ndarray]:
    """The arrays of ``model_d_ref.npz``, nothing written."""
    from repro import engine

    cfg, tables = generated_tables("D")
    triples = [(np.asarray(t.indices, np.int32), np.asarray(t.table, np.int32),
                int(t.bw_in)) for t in tables]
    uniform = engine.compile_network(triples, in_features=cfg.in_features,
                                     block_b=BLOCK_B)
    per_layer = engine.compile_network(triples, in_features=cfg.in_features,
                                       fused=False, block_b=BLOCK_B)
    assert (uniform.layout, per_layer.layout) == ("uniform", "per_layer")
    codes = input_codes(cfg.in_features, cfg.bw)
    ref = {"codes": codes, "bws": np.asarray([b for _, _, b in triples],
                                            np.int32)}
    for li, (idx, tab, _) in enumerate(triples):
        ref[f"idx_{li}"] = idx
        ref[f"table_{li}"] = tab
    for name, net in (("uniform", uniform), ("per_layer", per_layer)):
        ref[f"out_{name}"] = np.asarray(net(codes), np.int32)
    return ref


def build_train() -> dict[str, np.ndarray]:
    """The training-flow arrays of ``model_a_train.npz``, nothing written."""
    import jax

    from repro.configs import fpga4hep
    from repro.core import logicnet as LN
    from repro.core.train import train_logicnet
    from repro.data import jet_substructure_data
    from repro_torch.core.logicnet import reference_to_arrays

    cfg = fpga4hep.model_a()
    x, y = jet_substructure_data(8000, seed=0)
    xt, yt, xv, yv = x[:7000], y[:7000], x[7000:], y[7000:]
    out = reference_to_arrays(LN.init(cfg, jax.random.PRNGKey(0),
                                      mask_seed=0), "init")
    res = train_logicnet(cfg, xt, yt, xv, yv, method="apriori",
                         steps=TRAIN_STEPS, batch=256, lr=1e-2, seed=0)
    out["losses"] = np.asarray(res.losses, np.float32)
    out.update(reference_to_arrays(res.model, "trained"))
    tables = LN.generate_tables(cfg, res.model)
    for i, tt in enumerate(tables):
        out[f"table_{i}"] = np.asarray(tt.table, np.int32)
        out[f"idx_{i}"] = np.asarray(tt.indices, np.int32)
    f_codes, t_codes = LN.verify_tables(cfg, res.model, tables,
                                        xv[:N_VERIFY])
    assert (np.asarray(f_codes) == np.asarray(t_codes)).all()
    out["verify_codes"] = np.asarray(f_codes, np.int32)
    long = train_logicnet(cfg, xt, yt, xv, yv, method="apriori",
                          steps=LONG_STEPS, batch=256, lr=1e-2, seed=0)
    out["accuracy_600"] = np.asarray(long.accuracy, np.float32)
    return out


def flatten_params(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A reference parameter pytree as numpy arrays with dotted names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten_params(arrays: dict[str, np.ndarray]) -> dict:
    """The inverse of :func:`flatten_params`: a nested dict of arrays."""
    tree: dict = {}
    for name, a in arrays.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a
    return tree


def reference_serve(cfg, params, requests: int, slots: int, max_new: int,
                    cache_len: int) -> list[dict]:
    """The decode loop of ``examples/serve_lm.py`` (its ``main`` after the
    config and params), returning the finished requests in order."""
    import jax
    import jax.numpy as jnp

    from repro.launch.steps import make_decode_step
    from repro.models import model as M

    decode = jax.jit(make_decode_step(cfg))
    rng = np.random.default_rng(0)
    queue = [{"id": i,
              "prompt": rng.integers(1, cfg.vocab,
                                     rng.integers(4, 12)).tolist()}
             for i in range(requests)]
    done: list[dict] = []
    cache = M.init_cache(cfg, slots, cache_len)
    pos = jnp.zeros((slots,), jnp.int32)
    cur_tok = jnp.zeros((slots, 1), jnp.int32)
    active: list[dict | None] = [None] * slots

    def admit():
        nonlocal pos, cur_tok
        for s in range(slots):
            if active[s] is None and queue:
                req = queue.pop(0)
                active[s] = {"id": req["id"], "prompt": req["prompt"],
                             "fed": 0, "out": []}
                pos = pos.at[s].set(0)
                cur_tok = cur_tok.at[s, 0].set(req["prompt"][0])
                active[s]["fed"] = 1

    admit()
    while any(s is not None for s in active):
        logits, cache = decode(params, cache, cur_tok, pos)
        next_ids = np.asarray(jnp.argmax(logits, axis=-1))
        pos = pos + 1
        for s in range(slots):
            req = active[s]
            if req is None:
                continue
            if req["fed"] < len(req["prompt"]):
                cur_tok = cur_tok.at[s, 0].set(req["prompt"][req["fed"]])
                req["fed"] += 1
                continue
            req["out"].append(int(next_ids[s]))
            cur_tok = cur_tok.at[s, 0].set(int(next_ids[s]))
            if (len(req["out"]) >= max_new
                    or int(pos[s]) >= cache_len - 1):
                done.append(req)
                active[s] = None
        admit()
    return done


@contextlib.contextmanager
def router_choices():
    """While active, every call of the reference's MoE router, under
    ``jit`` and inside the layer scan too, appends its top-k experts
    (numpy, in call order: layer by layer, step by step) to the list this
    yields.  The logits of a run are the same bit for bit with and
    without it."""
    import jax

    from repro.models import moe as MOE

    rec = []
    inner = MOE._router

    def router(p, x, cfg):
        topi, weights, aux = inner(p, x, cfg)
        jax.debug.callback(lambda t: rec.append(np.asarray(t)), topi,
                           ordered=True)
        return topi, weights, aux

    MOE._router = router
    try:
        yield rec
    finally:
        jax.effects_barrier()
        MOE._router = inner


def fixture_config(base, compute_dtype: str):
    """The config of a fixture run: ``base`` at ``compute_dtype``; a MoE
    config at bfloat16 also at capacity E / k (nothing dropped)."""
    import dataclasses

    cfg = dataclasses.replace(base, compute_dtype=compute_dtype)
    if cfg.moe is not None and compute_dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def build_lm(archs=LM_ARCHS, config=None) -> dict[str, np.ndarray]:
    """The arrays of ``lm_smoke.npz`` (or, with ``LM_MOE_SSM_ARCHS`` and
    :func:`fixture_config`, of ``lm_smoke_moe_ssm.npz``), nothing
    written."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models import model as M

    out = {}
    for arch in archs:
        base = get_smoke_config(arch)
        params = M.init_params(base, jax.random.PRNGKey(0))
        for name, a in flatten_params(params).items():
            out[f"{arch}.params.{name}"] = a
        tokens = np.random.default_rng(1).integers(
            0, base.vocab, (2, LM_SEQ)).astype(np.int32)
        out[f"{arch}.tokens"] = tokens
        for cd in LM_DTYPES:
            cfg = (dataclasses.replace(base, compute_dtype=cd)
                   if config is None else config(base, cd))
            if config is not None:
                out[f"{arch}.{cd}.capacity_factor"] = np.float32(
                    cfg.moe.capacity_factor if cfg.moe else 0.0)
            record = (router_choices() if cfg.moe is not None
                      else contextlib.nullcontext([]))
            fwd = jax.jit(lambda p, t, cfg=cfg: M.forward(
                p, cfg, {"tokens": t})[0])
            with record as pre_routes:
                out[f"{arch}.{cd}.prefill"] = np.asarray(fwd(params, tokens),
                                                         np.float32)
            dec = jax.jit(lambda p, c, t, pos, cfg=cfg: M.decode_step(
                p, cfg, c, t, pos))
            cache = M.init_cache(cfg, 2, LM_DECODE)
            cache = {k: v.astype(cd) if k in KV_LEAVES else v
                     for k, v in cache.items()}
            steps = []
            record = (router_choices() if cfg.moe is not None
                      else contextlib.nullcontext([]))
            with record as dec_routes:
                for t in range(LM_DECODE):
                    logits, cache = dec(params, cache, tokens[:, t:t + 1],
                                        jnp.full((2,), t, jnp.int32))
                    steps.append(np.asarray(logits[:, 0], np.float32))
            out[f"{arch}.{cd}.decode"] = np.stack(steps, axis=1)
            if cfg.moe is not None:
                out[f"{arch}.{cd}.prefill_topi"] = np.stack(
                    pre_routes).astype(np.int8)
                # calls step by step, every layer: (steps, layers, 2, 1, K)
                per = np.stack(dec_routes).reshape(
                    LM_DECODE, cfg.n_layers, 2, cfg.moe.top_k)
                out[f"{arch}.{cd}.decode_topi"] = per.transpose(
                    1, 2, 0, 3).astype(np.int8)
            done = reference_serve(cfg, params, **LM_SERVE)
            # every request ends after max_new tokens at these flags
            out[f"{arch}.{cd}.serve_ids"] = np.asarray(
                [r["id"] for r in done], np.int32)
            out[f"{arch}.{cd}.serve_out"] = np.asarray(
                [r["out"] for r in done], np.int32)
    return out


def build_lm_moe_ssm() -> dict[str, np.ndarray]:
    """The arrays of ``lm_smoke_moe_ssm.npz``, nothing written."""
    return build_lm(LM_MOE_SSM_ARCHS, fixture_config)


def frontend_inputs(cfg, rows: int, seed: int = 2) -> dict[str, np.ndarray]:
    """Seeded bfloat16 outputs of the stub frontends (as float32 arrays):
    ``frames`` (rows, enc_frames, d_model) for an encoder-decoder,
    ``vision_embeds`` (rows, vision_tokens, d_model) for a VLM."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    out = {}
    if cfg.enc_dec:
        out["frames"] = (cfg.enc_frames, cfg.d_model)
    if cfg.vision_tokens > 0:
        out["vision_embeds"] = (cfg.vision_tokens, cfg.d_model)
    return {k: np.asarray(jnp.asarray(rng.standard_normal(
        (rows, *shape)), jnp.bfloat16), np.float32)
        for k, shape in out.items()}


def reference_cross_memory(params, cfg, memory):
    """Each decoder layer's ``cross_memory`` of the encoder's ``memory``,
    stacked over layers, as the reference's ``_forward_encdec`` computes
    them (its layer weights cast to the compute dtype first)."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as ATT
    from repro.models import model as M

    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = M._cast_weights(jax.tree.map(lambda a: a[i],
                                          params["dec_layers"]),
                             jnp.dtype(cfg.compute_dtype))
        k, v = ATT.cross_memory(lp["xattn"], cfg, memory)
        ks.append(k)
        vs.append(v)
    return jnp.stack(ks), jnp.stack(vs)


def build_lm_encdec_vlm() -> dict[str, np.ndarray]:
    """The arrays of ``lm_smoke_encdec_vlm.npz``, nothing written."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models import model as M

    out = {}
    for arch in LM_ENCDEC_VLM_ARCHS:
        base = get_smoke_config(arch)
        params = M.init_params(base, jax.random.PRNGKey(0))
        for name, a in flatten_params(params).items():
            out[f"{arch}.params.{name}"] = a
        tokens = np.random.default_rng(1).integers(
            0, base.vocab, (2, LM_SEQ)).astype(np.int32)
        out[f"{arch}.tokens"] = tokens
        inputs = frontend_inputs(base, 2)
        for k, v in inputs.items():
            out[f"{arch}.{k}"] = v
        batch = {"tokens": jnp.asarray(tokens),
                 **{k: jnp.asarray(v, jnp.bfloat16)
                    for k, v in inputs.items()}}
        for cd in LM_DTYPES:
            cfg = dataclasses.replace(base, compute_dtype=cd)
            fwd = jax.jit(lambda p, b, cfg=cfg: M.forward(p, cfg, b)[0])
            out[f"{arch}.{cd}.prefill"] = np.asarray(fwd(params, batch),
                                                     np.float32)
            if cfg.vision_tokens > 0:
                out[f"{arch}.{cd}.prefill_text"] = np.asarray(
                    fwd(params, {"tokens": batch["tokens"]}), np.float32)
            cache = M.init_cache(cfg, 2, LM_ENCDEC_DECODE)
            cache = {k: v.astype(cd) if k in KV_LEAVES else v
                     for k, v in cache.items()}
            if cfg.enc_dec:
                memory = jax.jit(lambda p, f, cfg=cfg: M._forward_encoder(
                    p, cfg, f.astype(cd)))(params, batch["frames"])
                out[f"{arch}.{cd}.memory"] = np.asarray(memory, np.float32)
                mk, mv = reference_cross_memory(params, cfg, memory)
                cache["mem_k"] = mk.astype(cache["mem_k"].dtype)
                cache["mem_v"] = mv.astype(cache["mem_v"].dtype)
            dec = jax.jit(lambda p, c, t, pos, cfg=cfg: M.decode_step(
                p, cfg, c, t, pos))
            steps = []
            for t in range(LM_ENCDEC_DECODE):
                logits, cache = dec(params, cache, tokens[:, t:t + 1],
                                    jnp.full((2,), t, jnp.int32))
                steps.append(np.asarray(logits[:, 0], np.float32))
            out[f"{arch}.{cd}.decode"] = np.stack(steps, axis=1)
            out[f"{arch}.{cd}.decode_tokens"] = np.argmax(
                out[f"{arch}.{cd}.decode"], axis=-1).astype(np.int32)
    return out


def write_model_d(directory: str = FIXTURE_DIR) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, MODEL_D_NAME)
    np.savez_compressed(path, **build_model_d())
    return path


def write_lm_moe_ssm(directory: str = FIXTURE_DIR) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, LM_MOE_SSM_NAME)
    np.savez_compressed(path, **build_lm_moe_ssm())
    return path


def write_lm_encdec_vlm(directory: str = FIXTURE_DIR) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, LM_ENCDEC_VLM_NAME)
    np.savez_compressed(path, **build_lm_encdec_vlm())
    return path


def write(directory: str = FIXTURE_DIR) -> tuple[str, ...]:
    os.makedirs(directory, exist_ok=True)
    mixed, ref = build()
    art = mixed.save(os.path.join(directory, ARTIFACT_NAME))
    ref_path = os.path.join(directory, REF_NAME)
    np.savez_compressed(ref_path, **ref)
    train_path = os.path.join(directory, TRAIN_NAME)
    np.savez_compressed(train_path, **build_train())
    lm_path = os.path.join(directory, LM_NAME)
    np.savez_compressed(lm_path, **build_lm())
    return (art, ref_path, train_path, lm_path, write_lm_moe_ssm(directory),
            write_lm_encdec_vlm(directory), write_model_d(directory))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=FIXTURE_DIR,
                    help="directory to write the .npz files into")
    ap.add_argument("--only", choices=("model_d", "lm_moe_ssm",
                                       "lm_encdec_vlm"),
                    help="write this fixture alone")
    args = ap.parse_args()
    only = {"model_d": write_model_d, "lm_moe_ssm": write_lm_moe_ssm,
            "lm_encdec_vlm": write_lm_encdec_vlm}
    paths = ((only[args.only](args.out),) if args.only
             else write(args.out))
    for path in paths:
        print(f"{path}: {os.path.getsize(path)} B")


if __name__ == "__main__":
    main()
