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
from mimic_tpu_torch.bridge import to_numpy, to_torch
from mimic_tpu_torch.models import decoder as td
from mimic_tpu_torch.models import generate as tg
from mimic_tpu_torch.models import lvlm as tlvlm
from mimic_tpu_torch.models.config import get_model_config
from torch_dist import load_inputs, save_outputs


def build_cfg(spec):
    """``(name, top-level fields, text fields)`` → the port's ``ModelConfig``."""
    name, top, text = spec
    cfg = get_model_config(name).replace(**top)
    return cfg.replace(text=dataclasses.replace(cfg.text, **text))


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
