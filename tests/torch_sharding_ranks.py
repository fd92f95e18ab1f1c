"""Rank-side cases of the port's tensor, sequence and pipeline parallelism
tests.

The functions here run inside spawned gloo ranks
(``deeplearning4j_torch.parallel.RankGroup``), which import this module
to unpickle them: it imports no JAX and nothing of the JAX package. Each
takes plain data (a model's JSON, its params as numpy trees, numpy
batches, mesh axes, a rule table by name or as tuples) and returns numpy
results from the rank (the group hands back rank 0's unless asked for
all).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_torch.ops import updaters as upd
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import CollectScoresListener

from torch_parallel_ranks import Batches, build, np_tree


def _mesh(axes):
    from deeplearning4j_torch.parallel import make_mesh

    return make_mesh(axes)


def _rules(rules):
    import deeplearning4j_torch.parallel.sharding as S

    if isinstance(rules, str):
        return getattr(S, rules)
    return tuple((p, tuple(s)) for p, s in rules)


def _updater(spec):
    if spec is None:
        return None
    name, lr = spec
    return getattr(upd, name)(lr)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def local_shards(js, params, axes, rules):
    """``place_params`` on this rank: its shard of every leaf."""
    from deeplearning4j_torch.parallel import place_params

    return np_tree(place_params(build(js, params).params, _mesh(axes),
                                _rules(rules)))


def trainer_fit(js, params, batches, axes, rules, updater=None, seed=0,
                accum=1, evaluate=True):
    """``Trainer(mesh=, rules=)`` over ``batches`` in one fit: the whole
    params after it (``full_params``), the shapes of the leaves it leaves
    in ``model.params`` (this rank's shards), the reported losses, and
    (``evaluate``) the score and confusion of the same batches."""
    from deeplearning4j_torch.train import Trainer

    m = build(js, params)
    tr = Trainer(m, updater=_updater(updater), seed=seed, mesh=_mesh(axes),
                 rules=_rules(rules), grad_accum=accum)
    col = CollectScoresListener()
    tr.fit(Batches(batches), listeners=[col], prefetch=False)
    out = dict(params=np_tree(tr.full_params()),
               local=_shapes(tr.model.params),
               losses=np.asarray([s for _, s in col.scores]),
               opt=[tuple(t.shape) for t in tree_leaves(tr.opt_state)
                    if torch.is_tensor(t) and t.ndim])
    if evaluate:
        out["score"] = tr.score_iterator(Batches(batches))
        ev = tr.evaluate(Batches(batches))
        out["confusion"] = np.asarray(ev.confusion)
    return out


def wrapper_fit(js, params, batches, axes, rules, mode="shared_gradients"):
    """``ParallelWrapper(rules=)``: the whole params, the shapes of the
    leaves the sync leaves in ``model.params`` (this rank's shards) and
    its updater state's leaf shapes in order."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    pw = ParallelWrapper(build(js, params), mesh=_mesh(axes), mode=mode,
                         rules=_rules(rules))
    pw.fit(Batches(batches))
    return dict(params=np_tree(pw.trainer.full_params()),
                local=_shapes(pw.model.params),
                opt=[tuple(t.shape) for t in tree_leaves(pw.opt_state)
                     if torch.is_tensor(t) and t.ndim])


def multihost_fit(js, params, x, y, gb, epochs, axes, rules, accum=1):
    """``MultiHostTrainer(rules=)`` fed per ``data_shard()``: whole params,
    and the confusion of ``evaluate(global_mesh=True)`` on the same
    shards; then ``save`` and ``restore`` into a fresh trainer, whose
    params and updater state must equal the saved ones."""
    import os
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_torch.parallel import (MultiHostTrainer,
                                               ProcessShardIterator)

    mesh = _mesh(axes)
    mh = MultiHostTrainer(build(js, params), mesh=mesh, rules=_rules(rules),
                          grad_accum=accum)
    idx, n = mh.data_shard()
    it = ProcessShardIterator(x, y, gb, process_id=idx, num_processes=n)
    mh.fit(it, epochs=epochs)
    ev = mh.evaluate(it, global_mesh=True)
    out = dict(params=np_tree(mh.trainer.full_params()),
               confusion=np.asarray(ev.confusion))
    path = os.path.join(tempfile.gettempdir(),
                        f"mh-rules-{os.getppid()}.zip")
    mh.save(path)
    back = MultiHostTrainer(build(js, params), mesh=mesh,
                            rules=_rules(rules), grad_accum=accum)
    back.restore(path)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back.params), tree_leaves(mh.params)))
    same = same and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back.opt_state),
                                          tree_leaves(mh.opt_state))
        if torch.is_tensor(a))
    dist.barrier()
    if dist.get_rank() == 0:
        os.remove(path)
    out["restored"] = same
    return out


def save_whole(js, params, batches, axes, rules, path):
    """``Trainer(rules=).fit`` then ``save(path)``: the whole params it
    holds after the fit."""
    from deeplearning4j_torch.train import Trainer

    tr = Trainer(build(js, params), mesh=_mesh(axes), rules=_rules(rules))
    tr.fit(Batches(batches), prefetch=False)
    tr.save(path)
    return np_tree(tr.full_params())


def lm_step(js, params, x, y, axes, lr):
    """One step of ``sharded_lm_step``: the loss and the whole params."""
    from deeplearning4j_torch.models.transformer import sharded_lm_step

    m = build(js, params)
    step, p, opt, place = sharded_lm_step(m, _mesh(axes), upd.sgd(lr))
    tokens, targets = place(x, y)
    p, opt, loss = step(p, opt, tokens, targets)
    return dict(loss=float(loss),
                params=np_tree(step.trainer.full_params()))


def rejects(js, params, axes, kw):
    """The error a ``ParallelWrapper(**kw)`` or ``Trainer(**kw)``
    constructor raises, as (type, text), or None."""
    from deeplearning4j_torch.parallel import ParallelWrapper

    kw = dict(kw)
    if "rules" in kw:
        kw["rules"] = _rules(kw["rules"])
    try:
        ParallelWrapper(build(js, params), mesh=_mesh(axes), **kw)
    except Exception as e:  # noqa: BLE001 - returned to the test
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------------------------ ring

def ring(q, k, v, cot, axes, causal, k_chunk, batch_axis=None,
         head_axis=None):
    """``ring_attention`` on global (B, T, H, D) arrays over ``axes``: its
    output and the gradients of sum(o * cot)."""
    from deeplearning4j_torch.parallel import ring_attention

    q, k, v = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ring_attention(q, k, v, _mesh(axes), causal=causal, k_chunk=k_chunk,
                       batch_axis=batch_axis, head_axis=head_axis)
    (o * torch.as_tensor(cot)).sum().backward()
    return dict(o=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(),
                dv=v.grad.numpy())


# -------------------------------------------------------------- pipeline

def _block():
    from deeplearning4j_torch.nn import layers as L

    return L.TransformerEncoderBlock(num_heads=2, causal=True)


def _tensors(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _tensors(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), requires_grad=grad)


def pipe(plist, x, M, axes):
    """``pipeline_apply`` of the stages ``plist`` (numpy trees) over
    ``x`` in ``M`` microbatches: the output and the gradients of
    sum(out ** 2) by stacked param and by input."""
    from deeplearning4j_torch.parallel import (from_microbatches,
                                               pipeline_apply,
                                               stack_stage_params,
                                               to_microbatches)

    blk = _block()

    def stage_fn(p, h):
        return blk.apply(p, {}, h, training=False)[0]

    stacked = stack_stage_params([_tensors(p) for p in plist])
    leaves = tree_leaves(stacked)
    for t in leaves:
        t.requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    out = from_microbatches(pipeline_apply(
        stage_fn, stacked, to_microbatches(xt, M), _mesh(axes)))
    (out ** 2).sum().backward()
    return dict(out=out.detach().numpy(),
                grads=np_tree(upd.tree_unflatten(
                    stacked, [t.grad for t in leaves])),
                dx=xt.grad.numpy())


def pipe_learns(params, x, y, M, axes, steps, lr):
    """Embedding -> pipelined blocks -> per-token softmax head, trained
    with adam: the losses of every step."""
    from deeplearning4j_torch.nn import layers as L
    from deeplearning4j_torch.parallel import (from_microbatches,
                                               pipeline_apply,
                                               to_microbatches)

    mesh = _mesh(axes)
    blk = _block()
    V = params["head"]["w"].shape[1]
    emb = L.EmbeddingSequence(n_in=V, n_out=params["head"]["w"].shape[0])
    head = L.RnnOutput(n_out=V, activation="softmax", loss="mcxent")
    p = _tensors(params, grad=True)
    leaves = tree_leaves(p)
    tx = upd.adam(lr)
    opt = tx.init(leaves)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    losses = []
    for _ in range(steps):
        h = emb.apply(p["emb"], {}, xt)[0]
        h = from_microbatches(pipeline_apply(
            lambda sp, a: blk.apply(sp, {}, a, training=False)[0],
            p["blocks"], to_microbatches(h, M), mesh))
        loss = head.score(p["head"], {}, h, torch.nn.functional.one_hot(
            yt.long(), V).float())
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            u, opt = tx.update(list(grads), opt, leaves)
            torch._foreach_add_(leaves, list(u))
        losses.append(float(loss))
    return np.asarray(losses)


def early_stopping_and_telemetry(js, params, train, held_out, axes, rules,
                                 max_epochs):
    """EarlyStoppingParallelTrainer over ParallelWrapper(rules=) (or
    without rules when ``rules`` is None): the best score and params; then
    one more fit of the best under a StepTelemetry: its replica gauges."""
    from deeplearning4j_torch.obs import StepTelemetry
    from deeplearning4j_torch.parallel import ParallelWrapper
    from deeplearning4j_torch.train import earlystopping as ES

    kw = {} if rules is None else {"rules": _rules(rules)}
    pw = ParallelWrapper(build(js, params), mesh=_mesh(axes), **kw)
    saver = ES.InMemoryModelSaver()
    cfg = ES.EarlyStoppingConfiguration(
        score_calculator=ES.DataSetLossCalculator(Batches(held_out)),
        epoch_terminations=[ES.MaxEpochsTermination(max_epochs)],
        model_saver=saver)
    res = ES.EarlyStoppingParallelTrainer(cfg, pw).fit(Batches(train))
    tel = StepTelemetry()
    pw.fit(Batches(train), telemetry=tel)
    return dict(best_score=res.best_score, best_epoch=res.best_epoch,
                best_params=np_tree(saver.get_best()[0]),
                prom=tel.to_prometheus(), steps=tel.snapshot()["steps"])


def batch_blocks(x, ids, axes, axis):
    """``shard_batch`` of a float array over ``axis`` and ``place_batch``
    of (features, integer ids) on this rank: the blocks as numpy."""
    from deeplearning4j_torch.parallel import place_batch, shard_batch

    mesh = _mesh(axes)
    fx, fi = place_batch(mesh, x, ids)
    return dict(shard=shard_batch(x, mesh, axis=axis).numpy(),
                x=fx.numpy(), ids=fi.numpy())


def forward_under_context(js, params, x, axes, rules):
    """A forward of this rank's shards on its block of ``x`` inside
    ``activation_sharding``, against the plain forward of the whole params
    on the whole batch: the largest difference on this rank's block."""
    from deeplearning4j_torch.parallel import (activation_sharding,
                                               place_batch, place_params,
                                               sharding_tree)

    m = build(js, params)
    mesh = _mesh(axes)
    with torch.no_grad():
        full, _ = m.forward(m.params, {}, torch.as_tensor(x))
        local = place_params(m.params, mesh, _rules(rules))
        (xb,) = place_batch(mesh, x)
        with activation_sharding(
                mesh, specs=sharding_tree(m.params, mesh, _rules(rules)),
                seq_input=xb.shape[1] != x.shape[1]):
            y, _ = m.forward(local, {}, xb)
    rows, cols = mesh.rows(x.shape[0]), mesh.rows(x.shape[1], "seq")
    return float((y - full[rows, cols]).abs().max())


# the reference's expert placement (tests/test_moe.py, __graft_entry__.py):
# an MoE layer's expert leaves over the expert axis on their leading dim
EXPERT_RULES = ((r"(.*/)?(w_up|b_up|w_down|b_down)", ("expert",)),)


def moe_expert(layer_kw, params, x, ep):
    """``MoE.apply`` (training) under an expert mesh of ``ep`` ranks with
    ``place_params`` under the expert rule: the output, the aux loss, the
    gradient of ``sum(y^2) + aux`` for each leaf this rank holds and for
    the input, and the shapes of the leaves it holds."""
    from deeplearning4j_torch.nn import layers as TL
    from deeplearning4j_torch.parallel import activation_sharding, place_params

    mesh = _mesh({"expert": ep})
    moe = TL.MoE(**layer_kw)
    p = place_params(params, mesh, EXPERT_RULES)
    names = sorted(p)
    leaves = [p[k].requires_grad_() for k in names]
    xt = torch.from_numpy(x).requires_grad_()
    with activation_sharding(mesh):
        y, s, _ = moe.apply(p, {}, xt, training=True)
        loss = (y * y).sum() + s["aux_loss"]
        grads = torch.autograd.grad(loss, leaves + [xt])
    return dict(y=y.detach().numpy(), aux=float(s["aux_loss"]),
                grads={k: g.numpy() for k, g in zip(names, grads)},
                gx=grads[-1].numpy(),
                shapes={k: tuple(p[k].shape) for k in names})


def moe_lm_fit(js, params, batches, ep):
    """Trainer(mesh={"expert": ep}, rules=EXPERT_RULES) over ``batches``:
    the whole params (``full_params``), the losses and the shapes of this
    rank's leaves."""
    from deeplearning4j_torch.train import Trainer

    tr = Trainer(build(js, params), mesh=_mesh({"expert": ep}),
                 rules=EXPERT_RULES)
    col = CollectScoresListener()
    tr.fit(Batches(batches), listeners=[col], prefetch=False)
    return dict(params=np_tree(tr.full_params()),
                losses=np.asarray([s for _, s in col.scores]),
                local=_shapes(tr.params))
