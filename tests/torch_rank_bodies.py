"""What each rank process of the port's parallel tests runs.

The tests (tests/test_torch_ring.py, tests/test_torch_dp.py,
tests/test_torch_fsdp.py, tests/test_torch_tp.py, tests/test_torch_mod.py,
tests/test_torch_pipe.py, tests/test_torch_combos.py,
tests/test_torch_multihost.py) start these functions in spawned processes
joined in one gloo group (``parallel.mesh.run_ranks``; the multi-node
bodies join it themselves); a child imports this module, torch and the
port, never JAX: the JAX references are computed in the test process.
"""

import dataclasses

import numpy as np
import torch

from trade_aid_multimodal_transformer_tpu_torch.models.config import ModelConfig
from trade_aid_multimodal_transformer_tpu_torch.models.init import map_tree, tree_leaves
from trade_aid_multimodal_transformer_tpu_torch.parallel import mesh as pmesh
from trade_aid_multimodal_transformer_tpu_torch.parallel.ring_attention import (
    ring_causal_attention,
)
from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import make_sharded_trainer
from trade_aid_multimodal_transformer_tpu_torch.train.steps import make_optimizer


def ring_cases(rank, world, cases):
    """Each case (q, k, v, g, impl, rate, salts): the whole output of ring
    attention over the group and the gradients of q, k, v for output
    gradient g, as numpy."""
    torch.set_num_threads(1)  # no thread split to vary with the machine's load: the same bits
    mesh = pmesh.make_mesh(seq=world).seq
    out = []
    for q, k, v, g, impl, rate, salts in cases:
        q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
        o = ring_causal_attention(q, k, v, mesh, impl, rate, salts, rate > 0)
        grads = torch.autograd.grad(o, (q, k, v), g)
        out.append([o.detach().numpy()] + [x.numpy() for x in grads])
    return out


def cp_training(rank, world, cfg_kw, params, batches, salts, opt_kw):
    """The context-parallel Trainer over the group: the loss and gradients
    of one step at ``params`` (batches[0], salts[0]), the same with
    ``remat`` (each block recomputed in the backward, under the ring's
    scope), then a trajectory of one step per batch. Returns (loss, grads,
    losses, final params, (remat loss, remat grads)) as numpy."""
    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    cfg = ModelConfig(**cfg_kw)
    # the ranks receive the parent's tensors in shared memory: each updates its own copy
    params = map_tree(lambda t: t.detach().clone().requires_grad_(), params)
    opt = make_optimizer(1e-3, **opt_kw)
    mesh = pmesh.make_mesh(seq=world)
    trainer = make_sharded_trainer(cfg, None, opt, [], 1, mesh)
    as_batch = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    loss, grads = trainer.loss_and_grads(params, [as_batch[0]], [salts[0]])
    remat = make_sharded_trainer(dataclasses.replace(cfg, remat=True), None, opt, [], 1, mesh)
    rloss, rgrads = remat.loss_and_grads(params, [as_batch[0]], [salts[0]])
    state = opt.init(params)
    losses = [trainer.step(params, state, [b], [s]).item() for b, s in zip(as_batch, salts)]
    return (loss.item(), [g.numpy() for g in grads], losses,
            [np.asarray(p.detach().numpy()) for p in tree_leaves(params)],
            (rloss.item(), [g.numpy() for g in rgrads]))


def _dp_feed(job):
    from trade_aid_multimodal_transformer_tpu_torch.sampling.feed import BatchFeed
    from trade_aid_multimodal_transformer_tpu_torch.train.metrics import build_metric_specs

    f = job["feed"]
    feed = BatchFeed(f["train"], f["val"], f["file_lengths"], job["cfg"]["block_size"],
                     job["batch"], False, f["rand_sizes"], list(job["cfg"]["vocab_sizes"]))
    return feed, build_metric_specs(f["vocabs"], [False] * len(f["vocabs"]),
                                    job["cfg"]["block_size"])


def dp_cases(rank, world, job):
    """One rank of a data-parallel run (``make_mesh(data=world)``, or data x
    seq with ``job["seq"]``): the loss and gradients of one step of the
    data-parallel Trainer on the global batch ``job["batches"][0]``; with
    ``job["steps"]`` a trajectory of one step per batch (losses and final
    parameters); with ``job["feed"]`` an evaluation pass of the global
    validation batches and one step of ``make_shard_map_dp_step``. Every
    result as numpy. ``job["kernel_dispatch"]`` takes the card's dispatch
    with the kernels' plain versions (the whole-row band's fused and cross
    kernels)."""
    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import make_shard_map_dp_step
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng

    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    if job.get("kernel_dispatch"):
        tatt._kernel_device = lambda device, impl: impl != "jnp"
    seq = job.get("seq", 1)
    mesh = pmesh.make_mesh(data=world // seq, seq=seq)
    cfg = ModelConfig(**job["cfg"])
    fresh = lambda: map_tree(lambda t: t.detach().clone().requires_grad_(), job["params"])  # noqa: E731
    feed, specs = _dp_feed(job) if "feed" in job else (None, [])
    opt = make_optimizer(1e-3)
    trainer = make_sharded_trainer(cfg, feed, opt, specs, job.get("eval_iters", 1), mesh)
    as_batch = [tuple(torch.from_numpy(a) for a in b) for b in job["batches"]]
    params = fresh()
    loss, grads = trainer.loss_and_grads(params, [as_batch[0]], [job["salts"][0]])
    out = {"loss": loss.item(), "grads": [g.numpy() for g in grads]}
    if job.get("steps"):
        state = opt.init(params)
        out["losses"] = [trainer.step(params, state, [b], [s]).item()
                         for b, s in zip(as_batch, job["salts"])]
        out["params"] = [p.detach().numpy().copy() for p in tree_leaves(params)]
    if feed is not None:
        ev = trainer.eval_pass(fresh(), StepRng(job["seed"], "cpu"), "val")
        out["eval"] = {k: v.numpy() for k, v in ev._asdict().items()}
        params = fresh()
        state = opt.init(params)
        step = make_shard_map_dp_step(cfg, feed, opt, mesh.data)
        out["dp_step_loss"] = step(params, state, job["seed"]).item()
        out["dp_step_params"] = [p.detach().numpy().copy() for p in tree_leaves(params)]
    return out


def fsdp_cases(rank, world, job):
    """One rank of an FSDP run over ``make_mesh(data=world // seq,
    seq=seq)`` and of the same run without FSDP ("dp"): per variant, from
    ``job["params"]``, the loss and gradients of one step on the global
    batch ``job["batches"][0]`` (where ``job["grads"]``; under FSDP the
    rank's parts), then one AdamW step per batch (and with ``job["accum"]``
    one of the first two batches as microbatches; losses), the sizes of the
    rank's params, mu and nu leaves before and after, the rank's parts, and
    the whole params, mu, nu and count after (gathered under FSDP); with
    ``job["feed"]`` an evaluation pass of the global validation batches on
    the initial parameters; with ``job["ckpt"]`` a directory, each
    variant's whole state saved there (``<variant>.npz``: every rank calls
    ``save_checkpoint``, rank 0 writes; its size on every rank), and the
    FSDP file read back whole and re-sharded on every rank. Every result as
    numpy."""
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import shard_train_state
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
        load_checkpoint, load_optimizer_state, save_checkpoint)
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng

    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    seq = job.get("seq", 1)
    mesh = pmesh.make_mesh(data=world // seq, seq=seq)
    cfg = ModelConfig(**job["cfg"])
    feed, specs = _dp_feed(job) if "feed" in job else (None, [])
    as_batch = [tuple(torch.from_numpy(a) for a in b) for b in job["batches"]]
    sizes = lambda tree: [t.numel() for t in tree_leaves(tree)]  # noqa: E731
    numpy = lambda tree: [t.detach().float().numpy().copy() for t in tree_leaves(tree)]  # noqa: E731
    out = {}
    for name in ("dp", "fsdp"):
        opt = make_optimizer(1e-3, **job.get("opt", {}))
        params = map_tree(lambda t: t.detach().clone().requires_grad_(), job["params"])
        params, state, placed = shard_train_state(params, opt.init(params), mesh.data,
                                                  name == "fsdp")
        trainer = make_sharded_trainer(cfg, feed, opt, specs, job.get("eval_iters", 1), mesh,
                                       fsdp=placed)
        res = {"held_before": [sizes(params), sizes(state["mu"]), sizes(state["nu"])]}
        if feed is not None:
            ev = trainer.eval_pass(params, StepRng(job["seed"], "cpu"), "val")
            res["eval"] = {k: v.numpy() for k, v in ev._asdict().items()}
        if job.get("grads", True):
            loss, grads = trainer.loss_and_grads(params, [as_batch[0]], [job["salts"][0]])
            res.update(loss=loss.item(), grads=[g.numpy() for g in grads])
        res["losses"] = [trainer.step(params, state, [b], [s]).item()
                         for b, s in zip(as_batch, job["salts"])]
        if job.get("accum"):  # one step of the first two batches as microbatches
            res["losses"].append(trainer.step(params, state, as_batch[:2],
                                              job["salts"][:2]).item())
        res["held_after"] = [sizes(params), sizes(state["mu"]), sizes(state["nu"])]
        res["parts"] = [numpy(params), numpy(state["mu"]), numpy(state["nu"])]
        whole = [params, state["mu"], state["nu"]]
        if placed is not None:
            whole = [placed.gather(t) for t in whole]
            res["specs"] = placed.specs
        res["whole"] = [numpy(t) for t in whole]
        res["count"] = state["count"]
        if job.get("ckpt"):  # every rank calls it: rank 0 writes, then a barrier
            path = f"{job['ckpt']}/{name}.npz"
            res["ckpt_size"] = save_checkpoint(
                path, whole[0], step=len(as_batch),
                opt_state={"count": state["count"], "mu": whole[1], "nu": whole[2]}, optimizer=opt)
            if placed is not None:
                loaded = load_checkpoint(path, cfg, "cpu")[0]
                got, got_state, _ = shard_train_state(
                    loaded, load_optimizer_state(path, loaded, opt), mesh.data, True)
                res["resumed_parts"] = [numpy(got), numpy(got_state["mu"]),
                                        numpy(got_state["nu"])]
                res["resumed_count"] = got_state["count"]
        out[name] = res
    return out


def mesh_cases(rank, world, job):
    """One rank of a run over ``make_mesh(**job["mesh"])`` (any of mod,
    data, model, seq; with ``job["fsdp"]`` FSDP on the data axis), from the
    whole ``job["params"]``: the rank's coordinates, its placement's specs
    and parts, its parts of params, mu and nu (numpy); the loss and the
    gradients (the rank's parts, and the whole tree gathered) of one step on
    the global batch ``job["batches"][0]``; after one AdamW step per batch
    the losses, the rank's parts and the whole params, mu and nu gathered;
    with ``job["feed"]`` an evaluation pass of the global validation
    batches on the initial parameters; with ``job["ckpt"]`` a file, the
    whole state saved there (rank 0 writes) and read back and re-sharded on
    every rank; with ``job["remat"]`` the first step's loss and gradients again
    with each block recomputed in the backward. ``job["kernel_dispatch"]``
    takes the card's dispatch with the kernels' plain versions. Planted
    faults: ``job["head_offset_0"]`` (every rank's heads start at 0),
    ``job["skip_cross_keys"]`` (a rank draws no salts for the cross sites
    of modalities it does not own) and ``job["mod_offset_0"]`` (rank 1
    keys its masks as modality place 0's)."""
    from trade_aid_multimodal_transformer_tpu_torch.models import transformer as ttr
    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
    from trade_aid_multimodal_transformer_tpu_torch.ops import layers as tl
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import shard_train_state
    from trade_aid_multimodal_transformer_tpu_torch.train.checkpoint import (
        load_checkpoint, load_optimizer_state, save_checkpoint)
    from trade_aid_multimodal_transformer_tpu_torch.train.steps import StepRng

    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    if job.get("kernel_dispatch"):
        tatt._kernel_device = lambda device, impl: impl != "jnp"
    if job.get("skip_cross_keys"):
        ttr.CROSS_SITES = 0
    if job.get("mod_offset_0") and rank == 1:
        unkeyed = tl.batch_row_map
        tl.batch_row_map = tatt.batch_row_map = (
            lambda lead, b, h=None, m=None: unkeyed(lead, b, h, None))
    mesh = pmesh.make_mesh(**job["mesh"])
    if job.get("head_offset_0"):
        mesh.model.heads = lambda n_head, _per=mesh.model.heads: (0, _per(n_head)[1])
    cfg = ModelConfig(**job["cfg"])
    feed, specs = _dp_feed(job) if "feed" in job else (None, [])
    numpy = lambda tree: [t.detach().float().numpy().copy() for t in tree_leaves(tree)]  # noqa: E731
    opt = make_optimizer(1e-3, **job.get("opt", {}))
    params = map_tree(lambda t: t.detach().clone().requires_grad_(), job["params"])
    params, state, placed = shard_train_state(params, opt.init(params), mesh.data,
                                              job.get("fsdp", False), mesh.model, mesh.mod)
    trainer = make_sharded_trainer(cfg, feed, opt, specs, job.get("eval_iters", 1), mesh,
                                   fsdp=placed)
    out = {"coords": mesh.coords}
    if placed is not None:
        out.update(specs=placed.specs, parts_held=placed.parts())
    out["parts"] = [numpy(params), numpy(state["mu"]), numpy(state["nu"])]
    whole = (lambda tree, kind="all_gather": tree) if placed is None else placed.whole
    if feed is not None:
        ev = trainer.eval_pass(params, StepRng(job["seed"], "cpu"), "val")
        out["eval"] = {k: v.numpy() for k, v in ev._asdict().items()}
    as_batch = [tuple(torch.from_numpy(a) for a in b) for b in job["batches"]]
    loss, grads = trainer.loss_and_grads(params, [as_batch[0]], [job["salts"][0]])
    out.update(loss=loss.item(), grads=[g.float().numpy() for g in grads],
               whole_grads=numpy(whole(list(grads), "grads")))
    if job.get("remat"):  # each block recomputed in the backward, its collectives again
        remat = make_sharded_trainer(dataclasses.replace(cfg, remat=True), feed, opt, specs, 1,
                                     mesh, fsdp=placed)
        rloss, rgrads = remat.loss_and_grads(params, [as_batch[0]], [job["salts"][0]])
        out["remat"] = (rloss.item(), [g.numpy() for g in rgrads])
    out["losses"] = [trainer.step(params, state, [b], [s]).item()
                     for b, s in zip(as_batch, job["salts"])]
    trees = [whole(t) for t in (params, state["mu"], state["nu"])]
    out["whole"] = [numpy(t) for t in trees]
    out["after_parts"] = numpy(params)
    if job.get("ckpt"):  # every rank calls it: rank 0 writes, then a barrier
        save_checkpoint(job["ckpt"], trees[0], step=len(as_batch),
                        opt_state={"count": state["count"], "mu": trees[1], "nu": trees[2]},
                        optimizer=opt)
        loaded = load_checkpoint(job["ckpt"], cfg, "cpu")[0]
        got, got_state, _ = shard_train_state(loaded, load_optimizer_state(job["ckpt"], loaded, opt),
                                              mesh.data, job.get("fsdp", False), mesh.model,
                                              mesh.mod)
        out["resumed_parts"] = [numpy(got), numpy(got_state["mu"]), numpy(got_state["nu"])]
    return out


def tp_ring_cases(rank, world, job):
    """One rank of ``make_mesh(model=2, seq=world // 2)``: the self- and
    cross-attention cores (``ops.attention``) on this rank's head of
    ``job["self"]`` (q, k, v, g of (M, B, H, T, hs)) and ``job["cross"]``
    (q, g of (B, H, T, hs); k, v of (J, B, H, T, hs)) inside the
    context-parallel scope (and the tensor-parallel rank's head scope,
    whose global heads the ring must not use), dropout ``job["rate"]``: the
    whole outputs and the gradients of q, k, v, as numpy. Without
    ``job["fold"]`` the rings' key is not folded with the model rank (a
    planted fault)."""
    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
    from trade_aid_multimodal_transformer_tpu_torch.ops import layers as tl

    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    mesh = pmesh.make_mesh(model=2, seq=world // 2)
    t = mesh.model.rank
    model_rank = t if job.get("fold", True) else None
    out = {}
    for name, h_ax, core in (("self", 2, tatt.causal_attention),
                             ("cross", 1, tatt.cross_causal_attention)):
        q, k, v, g = (x.narrow(h_ax + (x.ndim > job[name][0].ndim), t, 1).clone()
                      for x in job[name])
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        with tatt.context_parallel_scope(mesh.seq, None, model_rank), \
                tl.head_slice_scope(t, 1, 2, mesh.model):
            o = core(q, k, v, job["impl"], job["rate"], job["salts"], True,
                     batch_axis=h_ax - 1, head_axis=h_ax)
            grads = torch.autograd.grad(o, (q, k, v), g)
        out[name] = [o.detach().numpy()] + [x.numpy() for x in grads]
    return out


def pipe_cases(rank, world, tasks):
    """One rank of pipelined runs, each task over ``make_mesh(pipe=...,
    data=world // pipe)`` (a dict: ``pipe``, ``mu``, ``cfg``, ``params``,
    ``batch`` (xb, yb) global, ``key`` the step's raw threefry key, and
    what to compute): ``eval`` the loss at train=False (the data axis's
    mean); ``grads`` the loss and whole gradients of one training step
    (``loss_and_grads``); ``steps`` that many AdamW steps (lr 1e-2) on the
    batch and one more of two microbatch draws (the batch and its rows
    reversed), with the losses and the params, mu and nu after; ``fsdp`` one
    step with FSDP on the data axis and the same without, the gathered
    state after each; ``contiguous_rows`` (planted) a data rank's rows
    taken as one block of the batch instead of its rows of every
    microbatch. Every result as numpy."""
    from trade_aid_multimodal_transformer_tpu_torch.parallel import pipeline as pp
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import shard_train_state

    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    numpy = lambda tree: [t.detach().float().numpy().copy() for t in tree_leaves(tree)]  # noqa: E731
    real_rows = pp.pipeline_rows
    out = []
    for task in tasks:
        S, mu = task["pipe"], task["mu"]
        mesh = pmesh.make_mesh(pipe=S, data=world // S)
        cfg = ModelConfig(**task["cfg"])
        fresh = lambda: map_tree(lambda t: t.detach().clone().requires_grad_(),  # noqa: E731
                                 task["params"])
        xb, yb = (torch.from_numpy(a) for a in task["batch"])
        res = {"coords": mesh.coords}
        if task.get("contiguous_rows"):
            pp.pipeline_rows = lambda B, m, r, size: torch.arange(r * B // size,
                                                                  (r + 1) * B // size)
        try:
            if task.get("eval"):
                rows = slice(None) if mesh.data is None else pp.pipeline_rows(
                    xb.shape[1], mu, mesh.data.rank, mesh.data.size)
                with torch.no_grad():
                    loss, _ = pp.pipeline_total_loss(fresh(), cfg, xb[:, rows], yb[:, rows],
                                                     mesh.pipe, mu, None, False, mesh.data)
                if mesh.data is not None:
                    loss, _ = mesh.data.mean_grads(loss, [])
                res["eval_loss"] = loss.item()
            if task.get("grads"):
                trainer = make_sharded_trainer(cfg, None, make_optimizer(1e-3), [], 1, mesh,
                                               pipeline_microbatches=mu)
                loss, grads = trainer.loss_and_grads(fresh(), [(xb, yb)], [task["key"]])
                res.update(loss=loss.item(), grads=[g.numpy() for g in grads])
            for variant in (("pipe", "fsdp") if task.get("fsdp") else ()) + (
                    ("steps",) if task.get("steps") else ()):
                opt = make_optimizer(1e-2)
                params, state, placed = shard_train_state(fresh(), None, mesh.data,
                                                          variant == "fsdp")
                state = opt.init(params)
                trainer = make_sharded_trainer(cfg, None, opt, [], 1, mesh, fsdp=placed,
                                               pipeline_microbatches=mu)
                losses = [trainer.step(params, state, [(xb, yb)], [task["key"]]).item()
                          for _ in range(task.get("steps", 1) if variant == "steps" else 1)]
                if variant == "steps":  # then one step of two microbatch draws (grad_accum)
                    flipped = (xb.flip(1), yb.flip(1))
                    losses.append(trainer.step(params, state, [(xb, yb), flipped],
                                               [task["key"], task["key"][::-1]]).item())
                trees = [params, state["mu"], state["nu"]]
                if placed is not None:
                    trees = [placed.gather(t) for t in trees]
                res[variant] = {"losses": losses, "whole": [numpy(t) for t in trees],
                                "count": state["count"]}
        finally:
            pp.pipeline_rows = real_rows
        out.append(res)
    return out


def combo_cases(rank, world, jobs):
    """One rank of each job of one start of the ranks, in order, each over
    ``make_mesh(**job["mesh"])`` (any axes; a pipeline axis at
    ``job["mu"]`` microbatches), from the whole ``job["params"]`` placed by
    ``shard_train_state`` (``job["fsdp"]``: FSDP on the data axis): the
    rank's coordinates, its placement's specs and parts, its train-state
    bytes, the loss and the gradients (the rank's parts, and the whole
    tree gathered) of one step on the global batch ``job["batch"]`` with
    the raw key ``job["key"]``, and after the AdamW update (lr 1e-3) the
    rank's parts and the whole params, mu and nu. Planted faults
    (``job["fault"]``): "model_group_sum" (under a pipeline axis the
    gathered leaves' gradients summed over the model group before the
    rank keeps its slices) and "mod_rows_from_0" (a modality-parallel
    ring keying its rows from 0, not from the rank's first modality in
    the whole M). Every result as numpy."""
    from trade_aid_multimodal_transformer_tpu_torch.ops import attention as tatt
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import shard_train_state
    from trade_aid_multimodal_transformer_tpu_torch.utils.memory import train_state_bytes

    torch.set_num_threads(1)  # no thread split to vary between the ranks: the same bits
    numpy = lambda tree: [t.detach().float().numpy().copy() for t in tree_leaves(tree)]  # noqa: E731
    real_base = tatt._ring_base
    out = []
    for job in jobs:
        mesh = pmesh.make_mesh(**job["mesh"])
        cfg = ModelConfig(**job["cfg"])
        opt = make_optimizer(1e-3)
        params = map_tree(lambda t: t.detach().clone().requires_grad_(), job["params"])
        params, state, placed = shard_train_state(params, opt.init(params), mesh.data,
                                                  job.get("fsdp", False), mesh.model, mesh.mod)
        if job.get("fault") == "model_group_sum":
            real_part = placed.split_part

            def summed(leaves):
                return real_part([mesh.model._sum_flat("fault", [g])[0] if m is not None else g
                                  for g, m in zip(leaves, placed.model_dims)])

            placed.split_part = summed
        if job.get("fault") == "mod_rows_from_0":
            tatt._ring_base = lambda q, mod_axis: 0
        try:
            trainer = make_sharded_trainer(cfg, None, opt, [], 1, mesh, fsdp=placed,
                                           pipeline_microbatches=job.get("mu", 4))
            batch = tuple(torch.from_numpy(a) for a in job["batch"])
            loss, grads = trainer.loss_and_grads(params, [batch], [job["key"]])
        finally:
            tatt._ring_base = real_base
        whole = (lambda tree: tree) if placed is None else placed.whole
        res = {"coords": mesh.coords, "loss": loss.item(), "grads": [g.numpy() for g in grads],
               "whole_grads": numpy(whole(list(grads))),
               "state_bytes": train_state_bytes(params, state, opt,
                                                None if placed is None else placed.parts()),
               "parts_before": numpy(params)}
        if placed is not None:
            res.update(specs=placed.specs, parts_held=placed.parts())
        opt.update_(params, grads, state)
        res["parts_after"] = [numpy(params), numpy(state["mu"]), numpy(state["nu"])]
        res["whole_after"] = [numpy(whole(t)) for t in (params, state["mu"], state["nu"])]
        out.append(res)
    return out


def multihost_cases(rank, world, job):
    """One rank of nodes of ``job["per_node"]`` ranks each (LOCAL_RANK,
    LOCAL_WORLD_SIZE as a node's launcher sets them), joined through
    ``multihost.initialize`` twice: from the torchrun environment (port
    ``job["ports"][0]``) and from coordinator arguments (port
    ``job["ports"][1]``). Per join ("env", "coordinator"): the backend, the
    node and the node count, ``is_multiprocess``, the plan of ``auto`` and
    of ``{data: world}`` over the group, whether a second ``initialize``
    left the group alone, ``fsdp_cases`` of ``job["fsdp"]`` (its
    checkpoints under ``<ckpt>/<join>``) and whether ``gather_to_host`` of
    the FSDP parts of the initial parameters is the whole tree on the
    host."""
    import os

    import torch.distributed as dist

    from trade_aid_multimodal_transformer_tpu_torch.parallel import multihost
    from trade_aid_multimodal_transformer_tpu_torch.parallel.resolve import (
        available_devices, plan_mesh)
    from trade_aid_multimodal_transformer_tpu_torch.parallel.trainer import shard_train_state

    per = job["per_node"]
    os.environ.update(LOCAL_RANK=str(rank % per), LOCAL_WORLD_SIZE=str(per))
    out = {}
    for how, port in zip(("env", "coordinator"), job["ports"]):
        if how == "env":
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                              MASTER_PORT=str(port))
            multihost.initialize()
        else:
            for k in multihost.TORCHRUN_ENV:
                os.environ.pop(k, None)
            multihost.initialize(f"localhost:{port}", world, rank)
        group = dist.group.WORLD
        multihost.initialize("localhost:1", 1, 0)  # joined already: left alone
        cfg = job["fsdp"]["cfg"]
        plans = {str(m): plan_mesh(m, 1, fsdp=True, batch_size=job["fsdp"]["batch"],
                                   block_size=cfg["block_size"], n_head=cfg["n_head"],
                                   num_modalities=len(cfg["vocab_sizes"]), n_layer=cfg["n_layer"],
                                   n_devices=available_devices("cpu", 1, m)).describe()
                 for m in ("auto", {"data": world})}
        res = {"backend": dist.get_backend(), "node": multihost.process_index(),
               "nodes": multihost.process_count(), "multiprocess": multihost.is_multiprocess(),
               "left_alone": dist.group.WORLD is group, "plans": plans,
               "devices": available_devices("cpu", 1, "auto")}
        res.update(fsdp_cases(rank, world, dict(job["fsdp"], ckpt=f"{job['fsdp']['ckpt']}/{how}"))
                   ["fsdp"])
        mesh = pmesh.make_mesh(data=world)
        opt = make_optimizer(1e-3)
        params = map_tree(lambda t: t.detach().clone(), job["fsdp"]["params"])
        parts, _, placed = shard_train_state(params, opt.init(params), mesh.data, True)
        host = multihost.gather_to_host(parts, placed)
        res["gathered_whole"] = all(
            a.device.type == "cpu" and torch.equal(a, b)
            for a, b in zip(tree_leaves(host), tree_leaves(job["fsdp"]["params"]), strict=True))
        dist.destroy_process_group()
        out[how] = res
    return out


def multihost_entry(rank, world, job):
    """One node of a launch of the port's entry (``main.main``) in
    ``job["dir"]`` with a launcher's environment (set by ``run_ranks``):
    its console, the run's final losses and plan, its parameters'
    checksum, and the group's backend and plan devices for ``auto``."""
    import contextlib
    import io
    import os

    import torch.distributed as dist

    from trade_aid_multimodal_transformer_tpu_torch import main as entry
    from trade_aid_multimodal_transformer_tpu_torch.parallel.resolve import available_devices
    from trade_aid_multimodal_transformer_tpu_torch.train import runner

    os.chdir(job["dir"])
    got, real = {}, entry.run_training
    entry.run_training = lambda **kw: got.setdefault("res", real(**kw))
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert entry.main() == 0
    res = got["res"]
    return {"console": buf.getvalue(), "losses": res["losses"], "plan": res["plan"].describe(),
            "checksum": runner.param_checksum(res["params"]), "backend": dist.get_backend(),
            "devices": available_devices("cpu", 1, "auto")}
