"""Training step: loss, gradient accumulation, clipping, optimizer update
(port of ``repro.train.step``).

Structure of one step:

  * microbatches: the global batch is split into ``num_microbatches``
    slices, each slice's gradient computed by ``torch.autograd`` through
    ``models.transformer.lm_apply(mode="train")`` and folded, as each
    parameter's gradient lands, into one ``accum_dtype`` tree
    (``acc + g / nm``): no second whole-model gradient tree is kept.
  * optional int8 error-feedback gradient compression across a pod
    process group (``optim.compression``), the cross-pod-bandwidth trick.
  * global-norm clipping, then the optimizer update.  Streamed (the
    default), the update runs leaf by leaf and in place, each gradient
    freed once used and large leaves of element-wise optimizers in row
    slices, so its temporaries scale with a slice, not the model; this is
    the reference's ``streamed_update`` over its stacked blocks.

Loss: next-token cross-entropy with the padded-vocab tail masked, plus MoE
load-balance and router-z auxiliaries.

The state's parameters are the model itself: a step updates them in place
(the reference donates its state) and returns a new ``TrainState`` that
holds the same module.

Placed over a process mesh (``distributed.partition.place``), the step is
the reference's partitioned program, one process per rank: the bf16
shadow is cast shard-local and each layer's weights are gathered over the
data axis right before use (so the FSDP all-gather moves bf16), each
gradient is reduce-scattered into its ZeRO shard on the way back, the
cross-entropy is vocab-parallel, and the global norm and the streamed
update run on local shards (Adafactor's row and column means and its RMS
clip all-reduced across them).  With ``int8_ef`` and a "pod" mesh dim, the
reduction over pods is left out of the backward and done by the int8
error-feedback mean.  Every rank feeds the same global batch; each keeps
its data shard's rows of each microbatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..distributed.sharding import (all_reduce, is_placed,
                                    logical_placements, mesh_rank, mesh_ways,
                                    model_sharded)
from ..models.transformer import lm_apply, stack_position
from ..optim import compression
from ..optim import optimizer as opt_mod

__all__ = ["TrainSettings", "TrainState", "make_train_step", "init_state",
           "make_optimizer", "make_loss_fn", "cross_entropy",
           "streamed_update"]

Tree = Any
# elements of one slice of an element-wise optimizer's streamed update
# (a 64 Mi-element slice: 256 MB per float32 temporary)
_SLICE_ELEMS = 1 << 26


@dataclass(frozen=True)
class TrainSettings:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    num_microbatches: int = 1
    lb_coef: float = 0.01          # MoE load-balance loss weight
    zl_coef: float = 1e-3          # router z-loss weight
    grad_compression: str = "none"  # "none" | "int8_ef" (needs a pod group)
    pod_axis: str = "pod"
    # Stream the optimizer update leaf by leaf: its temporaries then scale
    # with one slice, not the whole model.
    stream_optimizer: bool = True
    # Gradient-accumulator dtype across microbatches.
    accum_dtype: str = "float32"
    # Mixed-precision shadow: cast float32 master params to this dtype once
    # per step, before the microbatch loop; gradients are then taken with
    # respect to the shadow.  None disables.
    cast_params: str | None = None


class TrainState(NamedTuple):
    step: int
    params: Any                    # the models.Transformer, updated in place
    opt_state: Any                 # trees keyed by parameter name
    comp_err: dict | None          # error-feedback residual (or None)


def _stacks(cfg, name: str):
    pos = stack_position(cfg, name)
    return None if pos is None else (pos[0], pos[2])


def make_optimizer(cfg, s: TrainSettings) -> opt_mod.Optimizer:
    sched = opt_mod.linear_warmup_cosine(s.learning_rate, s.warmup_steps,
                                         s.total_steps)
    if cfg.optimizer == "adafactor":
        # factored-ness decided on the JAX package's stacked shapes
        return opt_mod.adafactor(sched, weight_decay=s.weight_decay,
                                 stacks=lambda name: _stacks(cfg, name))
    if cfg.optimizer == "sgd":
        return opt_mod.sgd(sched)
    return opt_mod.adamw(sched, weight_decay=s.weight_decay)


def init_state(generator: torch.Generator | None, cfg, s: TrainSettings,
               init_fn=None, *, device=None) -> TrainState:
    """Parameters from ``init_fn(generator)`` (default: ``lm_init`` drawn
    from ``generator``, None = seeded 0, on ``device``; None = the CUDA
    card), the optimizer's zero state and, for ``int8_ef``, a zero
    residual."""
    from ..models.transformer import lm_init

    dev = resolve_device(device)
    model = (init_fn or (lambda g: lm_init(cfg, generator=g, device=dev)))(
        generator)
    params = dict(model.named_parameters())
    comp = (compression.init_state(
        {n: p.detach() for n, p in params.items()}).error
        if s.grad_compression == "int8_ef" else None)
    with torch.no_grad():
        opt_state = make_optimizer(cfg, s).init(params)
    return TrainState(step=0, params=model, opt_state=opt_state,
                      comp_err=comp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE and accuracy, the padded-vocab tail masked.

    The reference extracts the label logit with a one-hot mask and a max
    (vocab-sharding-friendly); a gather gives the same value without a
    ``(B, S, Vp)`` mask.  Accuracy counts the label logit at least the
    row's max, as the reference does.

    On placed logits (vocab on the model axis) the CE is vocab-parallel
    (:class:`_VocabParallelCE`) and returns this rank's share of the two
    means: summed over the data ranks they are the global means.  Where
    the vocab is not split, each rank takes this CE of its rows.
    """
    if is_placed(logits):
        return _placed_cross_entropy(logits, labels, vocab_size)
    x = logits.to(torch.float32, copy=True)
    if x.shape[-1] > vocab_size:
        x[..., vocab_size:] = -1e30
    lse = torch.logsumexp(x, dim=-1)                         # (B,S)
    label_logit = torch.gather(x, -1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    with torch.no_grad():
        acc = (label_logit >= torch.amax(x, dim=-1)).to(torch.float32)
    return nll.mean(), acc.mean()


class _VocabParallelCE(torch.autograd.Function):
    """Per-token NLL of logits whose vocab is split over the model axis:
    the max, the sum of exponentials and the label's logit are
    all-reduced (Megatron's vocab-parallel CE); the backward is the local
    ``softmax - onehot`` and needs no collective."""

    @staticmethod
    def forward(ctx, x, labels, v0, vocab, mesh):
        x = x.to(torch.float32)
        v_loc = x.shape[-1]
        col = v0 + torch.arange(v_loc, device=x.device)
        x = torch.where(col < vocab, x, -1e30)
        m = all_reduce(torch.amax(x, dim=-1, keepdim=True), mesh, "model",
                       "max")
        e = torch.exp(x - m)
        den = e.sum(dim=-1, keepdim=True)
        idx = labels.long() - v0
        mine = (idx >= 0) & (idx < v_loc)
        lab = torch.where(mine, torch.gather(
            x, -1, idx.clamp(0, v_loc - 1)[..., None])[..., 0], 0.0)
        den = all_reduce(den, mesh, "model")
        lab = all_reduce(lab, mesh, "model")
        lse = torch.log(den[..., 0]) + m[..., 0]
        ctx.save_for_backward(e, den, idx, mine)
        acc = (lab >= m[..., 0]).to(torch.float32)
        ctx.mark_non_differentiable(acc)
        return lse - lab, acc

    @staticmethod
    def backward(ctx, g, _):
        e, den, idx, mine = ctx.saved_tensors
        grad = e / den
        hot = torch.zeros_like(grad).scatter_(
            -1, idx.clamp(0, grad.shape[-1] - 1)[..., None],
            mine[..., None].to(grad.dtype))
        return (grad - hot) * g[..., None], None, None, None, None


def _placed_cross_entropy(logits, labels, vocab_size: int):
    mesh = logits.device_mesh
    l_pl = logical_placements(mesh, logits.shape, "batch", None, "vocab")
    y_pl = logical_placements(mesh, labels.shape, "batch", None)
    count = float(labels.numel())
    x = logits.redistribute(mesh, l_pl).to_local()
    y = labels.redistribute(mesh, y_pl).to_local()
    if not model_sharded(l_pl, mesh):   # the whole vocab: the plain CE
        share = y.numel() / count
        ce, acc = cross_entropy(x, y, vocab_size)
        return ce * share, acc * share
    v0 = mesh_rank(mesh, "model") * (logits.shape[-1]
                                     // mesh_ways(mesh, "model"))
    nll, acc = _VocabParallelCE.apply(x, y, v0, vocab_size, mesh)
    return nll.sum() / count, acc.sum() / count


def make_loss_fn(cfg, s: TrainSettings, apply_fn=None):
    """``loss_fn(model, batch) -> (loss, metrics)``; ``apply_fn(model,
    batch) -> (logits, aux)`` defaults to ``lm_apply(mode="train")``."""
    apply_fn = apply_fn or (
        lambda model, b: lm_apply(model, b, cfg, mode="train")[::2])

    def loss_fn(model, batch):
        logits, aux = apply_fn(model, batch)
        ce, acc = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        loss = ce
        if cfg.moe_num_experts:
            loss = loss + s.lb_coef * aux["lb_loss"] \
                + s.zl_coef * aux["router_z"]
        return loss, {"ce": ce, "acc": acc, **aux}

    return loss_fn


def _rows(t: torch.Tensor) -> list[slice]:
    """Row slices of a leaf for one element-wise update call each (the
    whole leaf unless it is large)."""
    if t.dim() == 0 or t.numel() <= _SLICE_ELEMS:
        return [slice(None)]
    per = max(1, _SLICE_ELEMS // max(1, t[0].numel()))
    return [slice(a, a + per) for a in range(0, t.shape[0], per)]


@torch.no_grad()
def streamed_update(opt, grads: dict, opt_state, params: dict,
                    grad_scale=None, layout: dict | None = None):
    """Optimizer update leaf by leaf, in place: ``params`` (name →
    parameter) and the state's trees are written back slice by slice, and
    each gradient is popped from ``grads`` once used.

    Valid because every optimizer here is leaf-wise given the step
    counter.  An element-wise optimizer (SGD, AdamW) takes a large leaf
    in row slices; Adafactor takes each decoder layer's leaf alone (the
    reference's per-block slice) and every other leaf in one call (the
    reference's non-block rest, so the whisper encoder's stacked leaves
    share their RMS clip).  The step counter advances once.  ``layout``
    (name → mesh, placements and global shape of a placed leaf whose local
    shard is given) goes to Adafactor, whose means and clip span shards.
    """
    fields = opt_state._asdict()
    scalars = {k: v for k, v in fields.items() if isinstance(v, int)}
    trees = [k for k in fields if k not in scalars]
    if opt.elementwise:
        calls = [[(n, r)] for n in list(params)
                 for r in _rows(params[n])]
    else:
        blocks = [n for n in params if n.startswith("layers.")]
        rest = [n for n in params if not n.startswith("layers.")]
        calls = [[(n, slice(None))] for n in blocks] + \
            [[(n, slice(None)) for n in rest]]

    def take(t, r):
        return t if r == slice(None) else t[r]

    new_step = None
    for call in calls:
        def part(tree):
            return {n: take(tree[n], r) for n, r in call}
        g = part(grads)
        if grad_scale is not None:
            g = {n: x.to(torch.float32) * grad_scale for n, x in g.items()}
        state = type(opt_state)(**scalars, **{k: part(fields[k])
                                              for k in trees})
        p = part(params)
        upd, new_state = opt.update(g, state, p) if opt.elementwise or \
            not layout else opt.update(g, state, p, layout=layout)
        new_p = opt_mod.apply_updates(p, upd)
        for n, _ in call:
            p[n].copy_(new_p[n])
            for k in trees:
                getattr(state, k)[n].copy_(getattr(new_state, k)[n])
        new_step = new_state.step
        last = {n for n, r in call
                if r.stop is None or r.stop >= params[n].shape[0]}
        for n in last:
            grads.pop(n)
    return params, type(opt_state)(
        **{k: new_step for k in scalars},
        **{k: fields[k] for k in trees})


def _shadow(model, dtype: torch.dtype):
    """A copy of ``model`` whose float32 parameters are cast to ``dtype``:
    fresh leaves, so gradients are taken with respect to the cast.  The
    module tree is copied shallowly, so nothing but the casts is
    allocated (a placed parameter's cast is shard-local)."""
    import copy

    from torch import nn

    def clone(m):
        c = copy.copy(m)
        c._parameters = {
            n: None if p is None else nn.Parameter(
                p.detach().to(dtype) if p.dtype == torch.float32
                else p.detach().clone())
            for n, p in m._parameters.items()}
        c._buffers = dict(m._buffers)
        c._modules = {n: None if sub is None else clone(sub)
                      for n, sub in m._modules.items()}
        return c

    return clone(model)


def make_train_step(cfg, s: TrainSettings, *, apply_fn=None,
                    pod_group=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds numpy arrays or tensors (moved to the parameters'
    device).  ``pod_group``: the ``torch.distributed`` process group the
    reference's "pod" axis names; with ``grad_compression="int8_ef"`` the
    gradient mean over it is int8-compressed with error feedback.  A
    placed state takes its pod group from its mesh's "pod" dim instead:
    each pod's gradient is reduced exactly within the pod and compressed
    across pods (:func:`_compressed_over_pods`).
    """
    opt = make_optimizer(cfg, s)
    loss_fn = make_loss_fn(cfg, s, apply_fn)
    use_comp = s.grad_compression == "int8_ef" and pod_group is not None

    def grads_of(model, micro, nm, adt):
        """Per-microbatch losses and metrics, and the gradient tree:
        ``Σ_k g_k.to(adt) / nm`` folded as each gradient lands (nm > 1),
        else the one gradient."""
        named = dict(model.named_parameters())
        acc: dict = {}

        def fold(name):
            def hook(p):
                g = p.grad.to(adt) / nm
                p.grad = None
                if name in acc:
                    acc[name].add_(g)
                else:
                    acc[name] = g
            return hook

        hooks = [p.register_post_accumulate_grad_hook(fold(n))
                 for n, p in named.items()] if nm > 1 else []
        out = []
        try:
            for mb in micro:
                loss, metrics = loss_fn(model, mb)
                loss.backward()
                out.append((loss.detach(),
                            {k: v.detach() for k, v in metrics.items()}))
        finally:
            for h in hooks:
                h.remove()
        if nm == 1:
            for n, p in named.items():
                acc[n], p.grad = p.grad, None
        grads = {n: acc[n] if acc.get(n) is not None
                 else torch.zeros_like(p, dtype=adt if nm > 1 else p.dtype)
                 for n, p in named.items()}
        if is_placed(model.embed):
            # a replicated leaf used on sharded activations (a norm scale)
            # comes back a partial sum: reduce it onto its placement, but
            # over the rules' deferred axes, which the caller reduces
            grads = {n: _onto(g, named[n].placements) for n, g in
                     grads.items()}
        return out, grads

    def train_step(state: TrainState, batch: Tree):
        model = state.params
        placed = is_placed(model.embed)
        if placed and not s.stream_optimizer:
            raise ValueError(
                "a placed state is updated streamed (stream_optimizer): "
                "the whole-tree update is not placed")
        nm = s.num_microbatches
        if placed:
            mesh = model.embed.device_mesh
            if nm > 1 and not any(is_placed(v) for v in batch.values()):
                # the global rows split as the reference splits them,
                # then placed: a microbatch's nonlinear terms (the MoE
                # load-balance loss) see the same rows
                micro = [_place_batch(mb, mesh) for mb in
                         _split_rows(batch, nm)]
            else:
                micro = _split_placed(_place_batch(batch, mesh), nm)
        else:
            dev = model.embed.device
            micro = _split_rows({k: torch.as_tensor(v).to(dev)
                                 for k, v in batch.items()}, nm)
        compute = model if not s.cast_params else \
            _shadow(model, getattr(torch, s.cast_params))
        comp_pod = placed and s.grad_compression == "int8_ef" and \
            "pod" in mesh.mesh_dim_names
        with _deferring(("pod",) if comp_pod else ()):
            outs, grads = grads_of(compute, micro, nm,
                                   getattr(torch, s.accum_dtype))
        del compute
        loss = torch.stack([o[0] for o in outs]).mean()
        metrics = {k: torch.stack([o[1][k] for o in outs]).mean()
                   for k in outs[0][1]}
        if placed:       # each rank holds its data shard's share
            loss = _data_sum(loss, mesh)
            metrics = {k: _data_sum(v, mesh) for k, v in metrics.items()}

        comp_err = state.comp_err
        if comp_pod:
            grads, comp_err = _compressed_over_pods(grads, comp_err, mesh)
        elif use_comp and not placed:
            grads, cstate = compression.compressed_psum(
                grads, compression.CompressionState(error=comp_err),
                pod_group)
            comp_err = cstate.error

        params = dict(model.named_parameters())
        if s.stream_optimizer:
            # clip scale folded into the per-leaf update: the clipped
            # gradient tree is never materialized whole
            gnorm = _global_norm(grads)
            scale = torch.clamp(s.clip_norm / (gnorm + 1e-9), max=1.0)
            # a placed leaf is updated on its local shard
            fields = state.opt_state._asdict()
            with torch.no_grad():
                grads = _local(grads)
                _, new = streamed_update(
                    opt, grads, type(state.opt_state)(**{
                        k: v if isinstance(v, int) else _local(v)
                        for k, v in fields.items()}),
                    _local(params), grad_scale=scale,
                    layout=_layout(params))
            opt_state = type(state.opt_state)(**{
                k: getattr(new, k) if isinstance(v, int) else v
                for k, v in fields.items()})
        else:
            grads, gnorm = opt_mod.clip_by_global_norm(grads, s.clip_norm)
            with torch.no_grad():
                updates, opt_state = opt.update(grads, state.opt_state,
                                                params)
                new = opt_mod.apply_updates(params, updates)
                for n, p in params.items():
                    p.copy_(new[n])
        del grads
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       step=float(state.step))
        return TrainState(step=state.step + 1, params=model,
                          opt_state=opt_state, comp_err=comp_err), metrics

    return train_step


def _place_batch(batch: dict, mesh) -> dict:
    """Every rank's copy of the global batch as DTensors on the batch
    placement (each rank keeps its data shard's rows; nothing is sent)."""
    from torch.distributed.tensor import distribute_tensor

    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    out = {}
    for k, v in batch.items():
        if is_placed(v):
            out[k] = v
            continue
        t = torch.as_tensor(v).to(dev)
        out[k] = distribute_tensor(
            t, mesh, logical_placements(mesh, t.shape, "batch",
                                        *([None] * (t.dim() - 1))),
            src_data_rank=None)
    return out


def _split_rows(batch: dict, nm: int) -> list:
    """``nm`` microbatches of the global rows, as the reference splits
    them (microbatch k: rows k·B/nm to (k+1)·B/nm)."""
    if nm == 1:
        return [batch]
    return [{k: torch.as_tensor(v).reshape(
        (nm, v.shape[0] // nm) + tuple(v.shape[1:]))[i]
        for k, v in batch.items()} for i in range(nm)]


def _split_placed(batch: dict, nm: int) -> list:
    """``nm`` microbatches of a batch given placed, each rank's rows split
    in ``nm`` (microbatch k: every rank's k-th slice), so no row moves.
    The gradient and the mean metrics of a loss linear in the rows equal
    the reference's split of the global rows; the MoE load-balance loss,
    a product of two means over a microbatch, sees other rows."""
    from torch.distributed.tensor import DTensor

    if nm == 1:
        return [batch]
    out = []
    for i in range(nm):
        mb = {}
        for k, v in batch.items():
            loc = v.to_local()
            if loc.shape[0] % nm:
                raise ValueError(f"{k}: {loc.shape[0]} rows a data shard "
                                 f"do not split into {nm} microbatches")
            piece = loc.reshape((nm, loc.shape[0] // nm) + loc.shape[1:])[i]
            mb[k] = DTensor.from_local(piece, v.device_mesh, v.placements,
                                       run_check=False)
        out.append(mb)
    return out


def _onto(g, placements):
    """Gradient ``g`` redistributed onto its parameter's ``placements``,
    leaving a partial sum over the active rules' deferred axes."""
    from torch.distributed.tensor import Partial

    from ..distributed.sharding import current_rules

    rules = current_rules()
    deferred = rules.deferred if rules is not None else ()
    want = tuple(gp if name in deferred and isinstance(gp, Partial) else pp
                 for name, gp, pp in zip(g.device_mesh.mesh_dim_names,
                                         g.placements, placements))
    return g if tuple(g.placements) == want else \
        g.redistribute(g.device_mesh, want)


@contextlib.contextmanager
def _deferring(axes: tuple):
    """The active rules with gradient reduction over ``axes`` deferred."""
    from ..distributed.sharding import current_rules, use_rules

    rules = current_rules()
    if not axes or rules is None:
        yield
        return
    with use_rules(dataclasses.replace(rules, deferred=tuple(axes))):
        yield


def _compressed_over_pods(grads: dict, comp_err: dict, mesh):
    """Each pod's gradients, reduced exactly within the pod and left
    unreduced over "pod", averaged across pods by the int8 error-feedback
    mean (``optim.compression``) on every rank's shards; each leaf's scale
    is the whole leaf's (its max reduced over the dims it is sharded on).
    A pod's partial sum is its share of the global mean, so the mean over
    pods of ``n_pods`` times it is the global gradient."""
    from torch.distributed.tensor import DTensor, Shard

    names = mesh.mesh_dim_names
    pods = mesh_ways(mesh, "pod")
    local = {n: g.to_local().to(torch.float32) * pods
             for n, g in grads.items()}
    groups = [tuple(mesh.get_group(i) for i, p in enumerate(g.placements)
                    if isinstance(p, Shard)) for g in grads.values()]
    out, cst = compression.compressed_psum(
        local, compression.CompressionState(
            error={n: e.to_local() for n, e in comp_err.items()}),
        mesh.get_group(names.index("pod")), max_groups=groups)
    # the residual is placed as the parameters are, as the gradients are
    return tuple({n: DTensor.from_local(t[n], mesh, comp_err[n].placements,
                                        run_check=False) for n in t}
                 for t in (out, cst.error))


def _data_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum a per-rank value over the data axes ("pod", "data")."""
    for name in ("pod", "data"):
        if name in mesh.mesh_dim_names:
            t = all_reduce(t.detach(), mesh, name)
    return t


def _layout(params: dict) -> dict:
    """Each placed parameter's mesh, placements and global shape."""
    return {n: (p.device_mesh, tuple(p.placements), tuple(p.shape))
            for n, p in params.items() if is_placed(p)}


def _local(tree: dict) -> dict:
    """``tree`` with each placed leaf's local shard in its place."""
    return {n: t.to_local() if is_placed(t) else t for n, t in tree.items()}


@torch.no_grad()
def _global_norm(grads: dict) -> torch.Tensor:
    """The gradients' global norm.  On placed leaves it sums each leaf's
    local squares, all-reduced over the mesh dims the leaf is sharded on
    (a replicated leaf counted once)."""
    from torch.distributed.tensor import Shard

    if not any(is_placed(g) for g in grads.values()):
        return opt_mod.global_norm(grads)
    mesh = next(iter(grads.values())).device_mesh
    groups: dict = {}
    for g in grads.values():
        dims = tuple(i for i, p in enumerate(g.placements)
                     if isinstance(p, Shard))
        sq = torch.sum(torch.square(g.to_local().to(torch.float32)))
        groups[dims] = groups.get(dims, 0.0) + sq
    total = 0.0
    for dims, v in groups.items():
        for i in dims:
            v = all_reduce(v, mesh, mesh.mesh_dim_names[i])
        total = total + v
    return opt_mod._sqrt32(total)
