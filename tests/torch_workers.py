"""Rank bodies of the port's multi-rank CPU tests, run by ``torch_dist.run_world``.

Each body reads the test's inputs (numpy trees drawn by the JAX package in
the test process), runs the port on its rank of a ``gloo`` world and saves
what the test compares.  Nothing here imports JAX or ``mimic_tpu``.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from mimic_tpu_torch import config as tconfig
from mimic_tpu_torch import parallel
from mimic_tpu_torch.bridge import to_numpy, to_torch, tree_map
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models.config import get_model_config
from torch_dist import load_inputs, save_outputs


def build_cfg(spec):
    """``(name, top-level fields, text fields[, perceiver fields])`` → the
    port's ``ModelConfig``."""
    name, top, text, *perceiver = spec
    cfg = get_model_config(name).replace(**top)
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, **text))
    if perceiver and perceiver[0]:
        cfg = cfg.replace(perceiver=dataclasses.replace(cfg.perceiver, **perceiver[0]))
    return cfg


def lvlm_batch(arrays) -> tlvlm.LVLMBatch:
    b = tlvlm.LVLMBatch(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})
    return b._replace(input_ids=b.input_ids.long())


def flat_specs(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_specs(v, f"{path}[{k!r}]"))
        return out
    return {path: tuple(tree)}


def port_enc(d):
    return tconfig.config_from_dict(tconfig.EncoderConfig, d)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def parallel_world(rank, n, workdir):
    inp = load_inputs(workdir)
    mesh = parallel.make_mesh(2, 2, device_type="cpu")
    out = {"coord": mesh.get_coordinate(), "logits": {}}
    try:
        parallel.make_mesh(3, 1, device_type="cpu")
    except ValueError as e:
        out["mesh_error"] = str(e)
    out["specs"] = {key: flat_specs(parallel.param_shardings(to_torch(p, "cpu"), mesh))
                    for key, (spec, p) in inp["models"].items()}
    for name, case in inp["forward"].items():
        spec, params = inp["models"][case["model"]]
        cfg = build_cfg(spec)
        sharded = parallel.shard_params(to_torch(params, "cpu"), mesh)
        batch = parallel.shard_batch(lvlm_batch(case["batch"]), mesh)
        shift = to_torch(case["shift"], "cpu") if case["shift"] is not None else None
        with parallel.use_mesh(mesh), torch.no_grad():
            logits = tlvlm.lvlm_forward(sharded, cfg, batch, shift=shift,
                                        multi_head=case["multi_head"]).logits
        out["logits"][name] = logits.numpy()
    save_outputs(workdir, rank, out)


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_generate.py
# ---------------------------------------------------------------------------


def generate_world(rank, n, workdir):
    from mimic_tpu_torch.serve.engine import ServeEngine, ServeRequest

    inp = load_inputs(workdir)
    mesh = parallel.make_mesh(2, 2, device_type="cpu")
    cfg = build_cfg(inp["spec"])
    params = parallel.shard_params(to_torch(inp["params"], "cpu"), mesh)
    batch = parallel.shard_batch(lvlm_batch(inp["batch"]), mesh)
    ids = (inp["eos"], inp["pad"])
    out = {"coord": mesh.get_coordinate()}
    with parallel.use_mesh(mesh), torch.no_grad():
        greedy = tg.greedy_generate(params, cfg, batch, 4, *ids)
        beam = tg.beam_generate(params, cfg, batch, 4, 3, *ids)
        out["greedy"], out["beam"] = greedy.tokens.numpy(), beam.tokens.numpy()
        out["beam_scores"] = beam.scores.numpy()
        tcfg = build_cfg(inp["engine_spec"])
        eng = ServeEngine(tcfg, parallel.shard_params(to_torch(inp["engine_params"], "cpu"), mesh),
                          num_slots=2, max_len=48, prefill_buckets=(8, 16, 32), decode_block=2,
                          device="cpu")
        for i, p in enumerate(inp["prompts"]):
            eng.submit(ServeRequest(uid=i, input_ids=p, max_new_tokens=5))
        out["engine"] = [r.tokens for r in eng.run()]
        out["cache_heads"] = eng._cache["k"].shape[3]
    save_outputs(workdir, rank, out)


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py
# ---------------------------------------------------------------------------


def ring_meshes():
    """The ring tests' meshes of four ranks, each with its batch axis: the
    sequence over ``sp`` 4; over ``sp`` 2 with the batch whole on both rings;
    over ``sp`` 2 with the batch split over ``data``."""
    return {
        "sp4": (init_device_mesh("cpu", (4,), mesh_dim_names=("sp",)), None),
        "sp2": (init_device_mesh("cpu", (2, 2), mesh_dim_names=("rep", "sp")), None),
        "sp2-data": (init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "sp")), "data"),
    }


def ring_world(rank, n, workdir):
    from mimic_tpu_torch.ops.ring_attention import ring_attention_sharded

    inp = load_inputs(workdir)
    meshes = ring_meshes()
    out = {}
    for case, arrays in inp["cases"].items():
        q, k, v, km = (torch.from_numpy(arrays[x]) for x in ("q", "k", "v", "km"))
        for name, (mesh, batch_axis) in meshes.items():
            if batch_axis is not None:
                q_, k_, v_, km_ = (parallel.shard_batch(x, mesh) for x in (q, k, v, km))
            else:
                q_, k_, v_, km_ = q, k, v, km
            got = ring_attention_sharded(mesh, q_, k_, v_, km_, causal=arrays["causal"],
                                         batch_axis=batch_axis)
            out[(case, name)] = [x.numpy() for x in got]
    mesh = meshes["sp4"][0]
    q, k, v, km = (torch.from_numpy(inp["cases"]["causal"][x]).requires_grad_(x != "km")
                   for x in ("q", "k", "v", "km"))
    got = ring_attention_sharded(mesh, q, k, v, km)
    cot = [torch.from_numpy(c) for c in inp["grad_cotangents"]]
    out["grads"] = [g.numpy() for g in torch.autograd.grad(got, (q, k, v), cot)]
    save_outputs(workdir, rank, out)


# ---------------------------------------------------------------------------
# tests/test_torch_ring_train.py
# ---------------------------------------------------------------------------


def ring_train_world(rank, n, workdir):
    from mimic_tpu_torch.parallel.mesh import axis_group
    from mimic_tpu_torch.shift import params as tsp
    from mimic_tpu_torch.train import optim as to
    from mimic_tpu_torch.train import step as ts

    inp = load_inputs(workdir)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "sp"))
    cfg = build_cfg(inp["spec"])
    frozen = parallel.replicate(to_torch(inp["params"], "cpu"), mesh)
    batch = parallel.shard_batch(ts.to_device_batch(SimpleNamespace(**inp["batch"]), "cpu"), mesh)
    tree = parallel.replicate(to_torch(inp["trainable"], "cpu"), mesh)
    tx = to.build_optimizer(tree, **inp["opt"])
    step = ts.make_train_step(cfg, port_enc(inp["enc"]), tx, **inp["common"], attn_impl="ring",
                              ring_mesh=mesh, ring_axis="sp", ring_batch_axis="data",
                              ring_min_len=1024)
    td.ATTN_PATH_LOG.clear()
    state, metrics = step(ts.TrainState(tree, tx.init(tree), 0), frozen, batch)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "trainable": to_numpy(state.trainable), "paths": list(td.ATTN_PATH_LOG), "ring0": {}}
    # the first step's learning rate is 0 (warmup_steps 1): a second one moves
    out["trainable2"] = to_numpy(step(state, frozen, batch)[0].trainable)
    # both passes on the ring (ring_min_len 0): compute_loss's gradients summed
    # over the data axis as the step sums them, then two steps
    batch = parallel.shard_batch(ts.to_device_batch(SimpleNamespace(**inp["batch0"]), "cpu"),
                                 mesh)
    ring_kw = dict(ring_mesh=mesh, ring_axis="sp", ring_batch_axis="data")
    data = axis_group(mesh, "data")
    for name, case in inp["ring0"].items():
        enc = port_enc(case["enc"])
        tree = parallel.replicate(to_torch(case["trainable"], "cpu"), mesh)
        live = {p: x.detach().clone().requires_grad_(True) for p, x in to.flatten(tree).items()}
        loss, _ = ts.compute_loss(
            to.unflatten(live), frozen, batch, cfg=cfg, strategy=enc.strategy(),
            rec_attn=tsp.needs_attn_capture(enc), rec_ffn=tsp.needs_ffn_capture(enc),
            mh=tsp.multi_head(enc), attn_impl="ring", ring_kwargs=ring_kw, data_group=data,
            **case["common"])
        grads = torch.autograd.grad(loss, list(live.values()))
        for g in grads:
            dist.all_reduce(g, group=data)
        tx = to.build_optimizer(tree, **case["opt"])
        step = ts.make_train_step(cfg, enc, tx, **case["common"], attn_impl="ring", **ring_kw)
        state = ts.TrainState(tree, tx.init(tree), 0)
        td.ATTN_PATH_LOG.clear()
        state, m1 = step(state, frozen, batch)
        paths = list(td.ATTN_PATH_LOG)
        state, m2 = step(state, frozen, batch)
        out["ring0"][name] = {
            "grads": {p: g.numpy() for p, g in zip(live, grads)}, "paths": paths,
            "metrics": [{k: float(v) for k, v in m.items()} for m in (m1, m2)],
            "trainable": to_numpy(state.trainable),
        }
    save_outputs(workdir, rank, out)


# ---------------------------------------------------------------------------
# tests/test_torch_train_mesh.py
# ---------------------------------------------------------------------------


def train_mesh_world(rank, n, workdir):
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.pipeline.train_entry import run_train
    from mimic_tpu_torch.train import optim as to
    from mimic_tpu_torch.train import step as ts

    inp = load_inputs(workdir)
    cfg = build_cfg(inp["spec"])
    out = {"steps": {}}
    # run_train: the whole run on a 2 x 2 mesh
    run = inp["run"]
    train_cfg = tconfig.config_from_dict(tconfig.TrainConfig, run["cfg"])
    runner = LVLMRunner(cfg, to_torch(inp["params"], "cpu"), SimpleTokenizer(padding_side="left"),
                        device="cpu", pad_multiple=32)
    state = run_train(train_cfg, result_dir=os.path.join(workdir, "mesh"), runner=runner,
                      splits=run["splits"], use_mesh=True)
    out["run_trainable"] = to_numpy(state.trainable)
    out["run_step"] = state.step
    # one step of each preset with unequal answer-token counts per data rank
    mesh = parallel.make_mesh(2, 2, device_type="cpu")
    frozen = parallel.shard_params(to_torch(inp["params"], "cpu"), mesh)
    for name, case in inp["steps"].items():
        tree = parallel.replicate(to_torch(case["trainable"], "cpu"), mesh)
        tx = to.build_optimizer(tree, **case["opt"])
        step = ts.make_train_step(cfg, port_enc(case["enc"]), tx, **case["common"])
        batch = parallel.shard_batch(ts.to_device_batch(SimpleNamespace(**case["batch"]), "cpu"),
                                     mesh)
        with parallel.use_mesh(mesh):
            state, metrics = step(ts.TrainState(tree, tx.init(tree), 0), frozen, batch)
        out["steps"][name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                              "trainable": to_numpy(state.trainable),
                              "tokens": int(batch["query_mask"].sum())}
    out["coord"] = mesh.get_coordinate()
    out["files"] = sorted(os.listdir(workdir))
    save_outputs(workdir, rank, out)
    dist.barrier()



# ---------------------------------------------------------------------------
# tests/test_torch_ring_backward.py
# ---------------------------------------------------------------------------


def ring_backward_world(rank, n, workdir):
    """Each case's (dq, dk, dv) through ``ring_attention_sharded`` under
    ``torch.autograd.grad`` on its meshes of ``ring_meshes`` (the data mesh:
    this rank's rows of the inputs and cotangents)."""
    from mimic_tpu_torch.ops.ring_attention import ring_attention_sharded

    inp = load_inputs(workdir)
    meshes = ring_meshes()
    out = {}
    for case, arrays in inp["cases"].items():
        for name in arrays["meshes"]:
            mesh, batch_axis = meshes[name]
            take = ((lambda x: parallel.shard_batch(x, mesh)) if batch_axis
                    else (lambda x: x))
            q, k, v = (take(torch.from_numpy(arrays[x])).requires_grad_()
                       for x in ("q", "k", "v"))
            km = take(torch.from_numpy(arrays["km"]))
            got = ring_attention_sharded(mesh, q, k, v, km, causal=arrays["causal"],
                                         need_unmasked=arrays["need_unmasked"],
                                         batch_axis=batch_axis)
            cot = [take(torch.from_numpy(arrays[x])) for x in ("g_out", "g_lse", "g_lse_u")]
            out[(case, name)] = [g.numpy() for g in torch.autograd.grad(got, (q, k, v), cot)]
    save_outputs(workdir, rank, out)


# ---------------------------------------------------------------------------
# tests/test_torch_head_split.py
# ---------------------------------------------------------------------------


def _loss_grads(cfg, enc, tree, frozen, batch, kw):
    """``compute_loss``'s gradients of every trainable leaf, as numpy."""
    from mimic_tpu_torch.shift import params as tsp
    from mimic_tpu_torch.train import optim as to
    from mimic_tpu_torch.train import step as ts

    live = {p: x.detach().clone().requires_grad_(True) for p, x in to.flatten(tree).items()}
    loss, _ = ts.compute_loss(
        to.unflatten(live), frozen, batch, cfg=cfg, strategy=enc.strategy(),
        rec_attn=tsp.needs_attn_capture(enc), rec_ffn=tsp.needs_ffn_capture(enc),
        mh=tsp.multi_head(enc), **kw)
    return {p: g.numpy() for p, g in zip(live, torch.autograd.grad(loss, list(live.values())))}


def _one_step(cfg, case, frozen, mesh, **step_kw):
    """One ``make_train_step`` step of ``case`` on ``mesh`` (its batch cut to
    this rank's data rows): (metrics, updated trainables)."""
    from mimic_tpu_torch.train import optim as to
    from mimic_tpu_torch.train import step as ts

    tree = parallel.replicate(to_torch(case["trainable"], "cpu"), mesh)
    tx = to.build_optimizer(tree, **case["opt"])
    step = ts.make_train_step(cfg, port_enc(case["enc"]), tx, **case["common"], **step_kw)
    batch = parallel.shard_batch(ts.to_device_batch(SimpleNamespace(**case["batch"]), "cpu"),
                                 mesh)
    with parallel.use_mesh(mesh):
        state, metrics = step(ts.TrainState(tree, tx.init(tree), 0), frozen, batch)
    return {k: float(v) for k, v in metrics.items()}, to_numpy(state.trainable)


def head_split_world(rank, n, workdir):
    """Every layout of ``shard_params`` that cuts inside a head, on a (data 1 x
    model 4) and a (data 2 x model 2) mesh: forwards, generation, train steps
    and gradients, the serve engine."""
    from mimic_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from mimic_tpu_torch.train import step as ts

    inp = load_inputs(workdir)
    meshes = {4: parallel.make_mesh(1, 4, device_type="cpu"),
              2: parallel.make_mesh(2, 2, device_type="cpu")}
    out = {"coord": {m: mesh.get_coordinate() for m, mesh in meshes.items()}}
    trees = {}

    def frozen(key, m):
        # a copy of shard_params' tree, as a move to the card makes one: the
        # layout is read from its shapes, not from the tensors shard_params made
        if (key, m) not in trees:
            cut = parallel.shard_params(to_torch(inp["models"][key][1], "cpu"), meshes[m])
            trees[key, m] = tree_map(lambda t: t.clone(), cut)
        return trees[key, m]

    def cfg_of(key):
        return build_cfg(inp["models"][key][0])

    # lvlm_forward's logits of each case on its mesh (the batch cut to this rank's rows)
    out["logits"] = {}
    for name, case in inp["forward"].items():
        mesh = meshes[case["model_axis"]]
        batch = parallel.shard_batch(lvlm_batch(case["batch"]), mesh)
        shift = to_torch(case["shift"], "cpu") if case["shift"] is not None else None
        with parallel.use_mesh(mesh), torch.no_grad():
            out["logits"][name] = tlvlm.lvlm_forward(
                frozen(case["model"], case["model_axis"]), cfg_of(case["model"]), batch,
                shift=shift, multi_head=case["multi_head"]).logits.numpy()

    # greedy and beam-3 tokens, and the KV heads the prefill's cache holds
    out["generate"] = {}
    for name, case in inp["generate"].items():
        mesh = meshes[case["model_axis"]]
        params, cfg = frozen(case["model"], case["model_axis"]), cfg_of(case["model"])
        batch = parallel.shard_batch(lvlm_batch(case["batch"]), mesh)
        ids = (inp["eos"], inp["pad"])
        with parallel.use_mesh(mesh), torch.no_grad():
            got = {"greedy": tg.greedy_generate(params, cfg, batch, 4, *ids).tokens.numpy(),
                   "cache_heads": td.init_kv_cache(cfg.text, 1, 1, "cpu")["k"].shape[3]}
            if case["beam"]:
                beam = tg.beam_generate(params, cfg, batch, 4, 3, *ids)
                got["beam"], got["beam_scores"] = beam.tokens.numpy(), beam.scores.numpy()
        out["generate"][name] = got

    # one train step, and compute_loss's gradients on the model-4 mesh
    out["steps"] = {}
    for name, case in inp["steps"].items():
        cfg, m = cfg_of(case["model"]), case["model_axis"]
        got = dict(zip(("metrics", "trainable"), _one_step(cfg, case, frozen(case["model"], m),
                                                           meshes[m])))
        if m == 4:
            batch = ts.to_device_batch(SimpleNamespace(**case["batch"]), "cpu")
            with parallel.use_mesh(meshes[4]):
                got["grads"] = _loss_grads(cfg, port_enc(case["enc"]),
                                           to_torch(case["trainable"], "cpu"),
                                           frozen(case["model"], 4), batch, case["loss_kw"])
        out["steps"][name] = got

    # the serve engine on the model-4 mesh
    eng_case = inp["engine"]
    with parallel.use_mesh(meshes[4]), torch.no_grad():
        eng = ServeEngine(cfg_of(eng_case["model"]), frozen(eng_case["model"], 4), num_slots=2,
                          max_len=48, prefill_buckets=(8, 16, 32), decode_block=2, device="cpu")
        for i, p in enumerate(eng_case["prompts"]):
            eng.submit(ServeRequest(uid=i, input_ids=p, max_new_tokens=5))
        out["engine"] = [r.tokens for r in eng.run()]
        out["engine_cache_heads"] = eng._cache["k"].shape[3]

    # the entry points: run_train(use_mesh=True) at (data 1 x model 4), and the
    # eval's LVLMRunner.generate on a shard_params tree under the mesh, cast to
    # fp64 and back (new tensors of the same values, as a dtype or device move)
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.pipeline.train_entry import run_train

    run = inp["run"]
    runner = LVLMRunner(cfg_of(run["model"]), to_torch(inp["models"][run["model"]][1], "cpu"),
                        SimpleTokenizer(padding_side="left"), device="cpu", pad_multiple=32)
    state = run_train(tconfig.config_from_dict(tconfig.TrainConfig, run["cfg"]),
                      result_dir=os.path.join(workdir, "run"), runner=runner,
                      splits=run["splits"], use_mesh=True)
    out["run_trainable"], out["run_step"] = to_numpy(state.trainable), state.step
    ev = inp["eval"]
    with parallel.use_mesh(meshes[4]), torch.no_grad():
        cast = tree_map(lambda t: t.double().float(), frozen(ev["model"], 4))
        runner = LVLMRunner(cfg_of(ev["model"]), cast,
                            SimpleTokenizer(padding_side="left"), device="cpu")
        out["eval"] = runner.generate(ev["images"], ev["texts"], num_beams=3, max_new_tokens=4)

    save_outputs(workdir, rank, out)


# ---------------------------------------------------------------------------
# tests/test_torch_model_axis.py
# ---------------------------------------------------------------------------


def _handles(tree):
    """Every int8 handle of a tree, by key path, as numpy."""
    from mimic_tpu_torch.ops.quant import is_quantized

    if is_quantized(tree):
        return {"": {k: v.numpy() for k, v in tree.items()}}
    if not isinstance(tree, dict):
        return {}
    return {f"{k}/{p}": h for k, v in tree.items() for p, h in _handles(v).items()}


def model_axis_world(rank, n, workdir):
    """Ring attention on meshes with a ``model`` axis (forwards, a MimIC step,
    its gradients), and the int8 modes under ``model > 1`` (``set_quant``'s
    handles, greedy and beam tokens, logits)."""
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.parallel.mesh import axis_group
    from mimic_tpu_torch.train import step as ts

    inp = load_inputs(workdir)
    meshes = {
        (1, 4): parallel.make_mesh(1, 4, device_type="cpu"),
        (2, 2): parallel.make_mesh(2, 2, device_type="cpu"),
        (1, 2, 2): init_device_mesh("cpu", (1, 2, 2), mesh_dim_names=("data", "sp", "model")),
        (2, 1, 2): init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("data", "sp", "model")),
    }
    out = {"coord": {m: mesh.get_coordinate() for m, mesh in meshes.items()}}
    trees = {}

    def frozen(key, m):
        if (key, m) not in trees:
            cut = parallel.shard_params(to_torch(inp["models"][key][1], "cpu"), meshes[m])
            trees[key, m] = tree_map(lambda t: t.clone(), cut)
        return trees[key, m]

    def cfg_of(key):
        return build_cfg(inp["models"][key][0])

    out["ring"] = {}
    for name, case in inp["ring"].items():
        key, m = case["model"], case["mesh"]
        mesh, cfg = meshes[m], cfg_of(key)
        ring = dict(ring_mesh=mesh, ring_axis=case["ring_axis"],
                    ring_batch_axis="data" if m[0] > 1 else None)
        got = {"forward": {}, "paths": []}
        batch = parallel.shard_batch(lvlm_batch(case["batch"]), mesh)
        shift = to_torch(case["shift"], "cpu")
        with parallel.use_mesh(mesh), torch.no_grad():
            for logz2 in ("unmasked", "masked"):
                td.ATTN_PATH_LOG.clear()
                o = tlvlm.lvlm_forward(frozen(key, m), cfg, batch, shift=shift, logz2=logz2,
                                       attn_impl="ring", capture_attn=True, **ring)
                got["forward"][logz2] = (o.logits.numpy(), o.decoder.attn_capture.numpy())
                got["paths"] += td.ATTN_PATH_LOG
        step = case["step"]
        td.ATTN_PATH_LOG.clear()
        got["metrics"], got["trainable"] = _one_step(cfg, step, frozen(key, m), mesh,
                                                     attn_impl="ring", **ring)
        got["step_paths"] = list(td.ATTN_PATH_LOG)
        sb = parallel.shard_batch(ts.to_device_batch(SimpleNamespace(**step["batch"]), "cpu"),
                                  mesh)
        data = axis_group(mesh, "data")
        with parallel.use_mesh(mesh):
            grads = _loss_grads(cfg, port_enc(step["enc"]), to_torch(step["trainable"], "cpu"),
                                frozen(key, m), sb, dict(step["loss_kw"], attn_impl="ring",
                                                         ring_kwargs=ring, data_group=data))
        if data is not None:  # as the step sums them
            for g in grads.values():
                t = torch.from_numpy(g)
                dist.all_reduce(t, group=data)
        got["grads"] = grads
        out["ring"][name] = got

    out["int8"] = {}
    ids = (inp["eos"], inp["pad"])
    for name, case in inp["int8"].items():
        key, m = case["model"], case["mesh"]
        mesh, cfg = meshes[m], cfg_of(key)
        batch = parallel.shard_batch(lvlm_batch(case["batch"]), mesh)
        with parallel.use_mesh(mesh), torch.no_grad():
            runner = LVLMRunner(cfg, frozen(key, m), SimpleTokenizer(padding_side="left"),
                                device="cpu", quant=case["mode"])
            params, dparams = runner.params, runner.decode_params
            quantized = params if dparams is None else dparams
            got = {"handles": _handles(quantized),
                   "logits": tlvlm.lvlm_forward(quantized, cfg, batch).logits.numpy(),
                   "greedy": tg.greedy_generate(params, cfg, batch, case["new"], *ids,
                                                decode_params=dparams).tokens.numpy()}
            if case["beam"]:
                beam = tg.beam_generate(params, cfg, batch, case["new"], 3, *ids,
                                        decode_params=dparams)
                got["beam"], got["beam_scores"] = beam.tokens.numpy(), beam.scores.numpy()
        out["int8"][name] = got

    # the serve engine in the "int8" layout: the prefill on the cut bf16 tree,
    # the decode on whole handles, the slot cache holding every KV head
    from mimic_tpu_torch.serve.engine import ServeEngine, ServeRequest

    eng_case = inp["engine"]
    key = eng_case["model"]
    with parallel.use_mesh(meshes[1, 4]), torch.no_grad():
        runner = LVLMRunner(cfg_of(key), frozen(key, (1, 4)), SimpleTokenizer(padding_side="left"),
                            device="cpu", quant="int8")
        eng = ServeEngine(cfg_of(key), runner.params, decode_params=runner.decode_params,
                          num_slots=2, max_len=48, prefill_buckets=(8, 16, 32), decode_block=2,
                          device="cpu")
        for i, p in enumerate(eng_case["prompts"]):
            eng.submit(ServeRequest(uid=i, input_ids=p, max_new_tokens=5))
        out["engine"] = [r.tokens for r in eng.run()]
        out["engine_cache_heads"] = eng._cache["k"].shape[3]
    save_outputs(workdir, rank, out)

