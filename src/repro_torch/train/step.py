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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..device import resolve_device
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
    """
    x = logits.to(torch.float32, copy=True)
    if x.shape[-1] > vocab_size:
        x[..., vocab_size:] = -1e30
    lse = torch.logsumexp(x, dim=-1)                         # (B,S)
    label_logit = torch.gather(x, -1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    with torch.no_grad():
        acc = (label_logit >= torch.amax(x, dim=-1)).to(torch.float32)
    return nll.mean(), acc.mean()


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
                    grad_scale=None):
    """Optimizer update leaf by leaf, in place: ``params`` (name →
    parameter) and the state's trees are written back slice by slice, and
    each gradient is popped from ``grads`` once used.

    Valid because every optimizer here is leaf-wise given the step
    counter.  An element-wise optimizer (SGD, AdamW) takes a large leaf
    in row slices; Adafactor takes each decoder layer's leaf alone (the
    reference's per-block slice) and every other leaf in one call (the
    reference's non-block rest, so the whisper encoder's stacked leaves
    share their RMS clip).  The step counter advances once.
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
        upd, new_state = opt.update(g, state, p)
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
    fresh leaves, so gradients are taken with respect to the cast."""
    from ..models.transformer import Transformer

    with torch.device("meta"):
        shadow = Transformer(model.cfg, generator=None)
    shadow.load_state_dict(
        {n: (p.detach().to(dtype) if p.dtype == torch.float32
             else p.detach().clone())
         for n, p in model.named_parameters()}, assign=True)
    return shadow


def make_train_step(cfg, s: TrainSettings, *, apply_fn=None,
                    pod_group=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds numpy arrays or tensors (moved to the parameters'
    device).  ``pod_group``: the ``torch.distributed`` process group the
    reference's "pod" axis names; with ``grad_compression="int8_ef"`` the
    gradient mean over it is int8-compressed with error feedback.
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
        return out, {n: acc[n] if acc.get(n) is not None
                     else torch.zeros_like(p, dtype=adt if nm > 1
                                           else p.dtype)
                     for n, p in named.items()}

    def train_step(state: TrainState, batch: Tree):
        model = state.params
        dev = model.embed.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        nm = s.num_microbatches
        compute = model if not s.cast_params else \
            _shadow(model, getattr(torch, s.cast_params))
        if nm == 1:
            micro = [batch]
        else:
            micro = [{k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(nm)]
        outs, grads = grads_of(compute, micro, nm,
                               getattr(torch, s.accum_dtype))
        del compute
        loss = torch.stack([o[0] for o in outs]).mean()
        metrics = {k: torch.stack([o[1][k] for o in outs]).mean()
                   for k in outs[0][1]}

        comp_err = state.comp_err
        if use_comp:
            grads, cstate = compression.compressed_psum(
                grads, compression.CompressionState(error=comp_err),
                pod_group)
            comp_err = cstate.error

        params = dict(model.named_parameters())
        if s.stream_optimizer:
            # clip scale folded into the per-leaf update: the clipped
            # gradient tree is never materialized whole
            gnorm = opt_mod.global_norm(grads)
            scale = torch.clamp(s.clip_norm / (gnorm + 1e-9), max=1.0)
            _, opt_state = streamed_update(opt, grads, state.opt_state,
                                           params, grad_scale=scale)
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
