"""Parameters of the reference package → parameters of the port.

``repro.core.snn.quantize_params`` returns
``{"layers": [{"w_q": int16 (n_in, n_out), "scale": float}]}``.  Handed
over as numpy arrays (``np.asarray`` of each leaf), the same codes become
the port's parameters, so both packages compute the same integers
(:func:`params_from_jax`).  Float params — the SNN's ``{"w"}`` and the
ANN's ``{"w", "b"}`` layers — cross the same way
(:func:`float_params_from_jax`).

The LM's ``lm_init`` tree (numpy leaves; decoder layers stacked in blocks
on a leading axis, the whisper encoder's layers stacked likewise) becomes
the port's :class:`~repro_torch.models.Transformer`
(:func:`lm_params_from_jax`, and back: :func:`lm_params_to_jax`), and the
port's per-layer cache goes back to the JAX package's stacked layout for
comparison (:func:`lm_cache_to_jax_layout`).  A training state crosses
whole (:func:`train_state_to_jax` / :func:`train_state_from_jax`): the
parameters, every optimizer state tree (stacked like the parameters) and
the compression residual; the checkpoint writes and reads this layout, so
either package restores the other's checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "float_params_from_jax", "lm_params_from_jax",
           "lm_params_to_jax", "lm_cache_to_jax_layout", "train_state_to_jax",
           "train_state_from_jax"]


def params_from_jax(params_q: dict, *,
                    device: str | torch.device | None = None) -> dict:
    """``{"layers": [{"w_q", "scale"}]}`` of numpy leaves → the port's
    parameters: int16 weight codes on ``device`` (None = the CUDA card) and
    float scales."""
    dev = resolve_device(device)
    layers = []
    for layer in params_q["layers"]:
        w = np.asarray(layer["w_q"])
        if not np.issubdtype(w.dtype, np.integer):
            raise TypeError(f"w_q must hold integer codes, got {w.dtype}")
        layers.append({"w_q": torch.from_numpy(w.astype(np.int16)).to(dev),
                       "scale": float(np.asarray(layer["scale"]))})
    return {"layers": layers}


def float_params_from_jax(params: dict, *,
                          device: str | torch.device | None = None) -> dict:
    """``{"layers": [{"w"[, "b"]}]}`` of numpy leaves (float SNN or ANN
    params) → the same layers as float32 tensors on ``device`` (None = the
    CUDA card)."""
    dev = resolve_device(device)
    return {"layers": [
        {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
         for k, v in layer.items()}
        for layer in params["layers"]]}


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def lm_params_from_jax(params: dict, cfg, *,
                       device: str | torch.device | None = None):
    """The JAX package's ``lm_init(key, cfg)`` tree, as numpy leaves → the
    port's ``Transformer`` on ``device`` (None = the CUDA card).

    Layer ``b·bs + j`` takes ``blocks["p{j}"][...][b]`` (``bs`` the plan's
    block size); encoder layer ``i`` takes ``encoder["layers"][...][i]``;
    ``embed``, ``lm_head``, ``pos_embed`` and the final norms cross as they
    are.  Every parameter of the port must be given, and nothing more."""
    from .models.transformer import Transformer, block_size, layer_plan

    dev = resolve_device(device)
    bs = block_size(layer_plan(cfg))
    state = {}
    for key, leaf in _flatten({k: v for k, v in params.items()
                               if k not in ("blocks", "encoder")}).items():
        state[key] = leaf
    for j_key, block in params["blocks"].items():
        j = int(j_key[1:])
        for path, leaf in _flatten(block).items():
            for b in range(leaf.shape[0]):
                state[f"layers.{b * bs + j}.{path}"] = leaf[b]
    if "encoder" in params:
        enc = params["encoder"]
        for path, leaf in _flatten(enc["layers"]).items():
            for i in range(leaf.shape[0]):
                state[f"encoder.layers.{i}.{path}"] = leaf[i]
        for path, leaf in _flatten(enc["final_norm"]).items():
            state[f"encoder.final_norm.{path}"] = leaf
    with torch.device("meta"):
        model = Transformer(cfg, generator=None)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in state.items()}, strict=True, assign=True)
    return model.to(dev)


def _stack_named(named: dict, cfg, leaf) -> dict:
    """``{port parameter name: tensor}`` → the JAX package's nested tree.
    ``leaf(tensors, stacked)`` makes each JAX leaf: from the layers of one
    stacked leaf (``models.transformer.stack_position``) in index order,
    or from one unstacked tensor."""
    from .models.transformer import stack_position

    groups: dict = {}
    for name, t in named.items():
        pos = stack_position(cfg, name)
        if pos is None:
            groups[name] = (False, {0: t})
        else:
            groups.setdefault(pos[0], (True, {}))[1][pos[1]] = t
    out: dict = {}
    for path, (stacked, by_idx) in groups.items():
        *head, last = path.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf([by_idx[i] for i in sorted(by_idx)], stacked)
    return out


def _host_leaf(ts: list, stacked: bool) -> np.ndarray:
    arrs = [_to_numpy(t) for t in ts]
    return np.stack(arrs) if stacked else arrs[0].copy()


def _unstack_named(tree: dict, names, cfg, device) -> dict:
    """The inverse of :func:`_stack_named` for the port names ``names``:
    each name's slice of its JAX leaf as a tensor on ``device``."""
    from .models.transformer import stack_position

    flat = _flatten(tree)
    out = {}
    for name in names:
        pos = stack_position(cfg, name)
        a = flat[name] if pos is None else flat[pos[0]][pos[1]]
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return out


def lm_params_to_jax(model, cfg) -> dict:
    """The port's ``Transformer`` → the JAX package's ``lm_init`` tree of
    numpy leaves (the inverse of :func:`lm_params_from_jax`)."""
    return _stack_named(dict(model.named_parameters()), cfg, _host_leaf)


def train_state_to_jax(state, cfg) -> dict:
    """A port ``train.TrainState`` → the JAX package's ``TrainState``
    layout as nested dicts of numpy leaves: ``step`` (int32, shape ()),
    ``params`` (:func:`lm_params_to_jax`), ``opt_state`` (its ``step`` and
    each state tree stacked like the parameters: Adafactor's per-layer
    moments and scalar dummies become ``(nb, ...)`` / ``(nb,)``) and, where
    there is one, ``comp_err``.  Leaf paths are the JAX package's
    checkpoint leaf ids (``params.blocks.p0.attn.wq``, ``opt_state.mu...``,
    ``step``)."""
    return _train_state_tree(state, cfg, _host_leaf)


def _train_state_tree(state, cfg, leaf) -> dict:
    opt = {}
    for k, v in state.opt_state._asdict().items():
        opt[k] = np.asarray(v, np.int32) if isinstance(v, int) else \
            _stack_named(v, cfg, leaf)
    out = {"step": np.asarray(state.step, np.int32),
           "params": _stack_named(dict(state.params.named_parameters()),
                                  cfg, leaf),
           "opt_state": opt}
    if state.comp_err is not None:
        out["comp_err"] = _stack_named(state.comp_err, cfg, leaf)
    return out


def train_state_from_jax(tree: dict, cfg, *,
                         device: str | torch.device | None = None):
    """The JAX package's ``TrainState`` (numpy leaves; namedtuples or the
    dicts :func:`train_state_to_jax` gives) → a port ``train.TrainState``
    on ``device`` (None = the CUDA card): the parameters as a
    ``Transformer``, the optimizer state as the port's ``SGDState`` /
    ``AdamWState`` / ``AdafactorState`` keyed by parameter name."""
    from .optim.optimizer import AdafactorState, AdamWState, SGDState
    from .train.step import TrainState

    def fields(x):
        return x._asdict() if hasattr(x, "_asdict") else dict(x)

    dev = resolve_device(device)
    tree = fields(tree)
    model = lm_params_from_jax(tree["params"], cfg, device=dev)
    names = [n for n, _ in model.named_parameters()]
    opt = fields(tree["opt_state"])
    kind = next(t for t in (SGDState, AdamWState, AdafactorState)
                if set(t._fields) == set(opt))
    opt_state = kind(**{
        k: int(np.asarray(v)) if k == "step" else
        _unstack_named(v, names, cfg, dev) for k, v in opt.items()})
    comp = tree.get("comp_err")
    return TrainState(
        step=int(np.asarray(tree["step"])), params=model,
        opt_state=opt_state,
        comp_err=None if comp is None else _unstack_named(comp, names, cfg,
                                                          dev))


def lm_cache_to_jax_layout(cache: list, cfg) -> dict:
    """The port's cache (one ``{"self"[, "cross"]}`` entry per layer) → the
    JAX package's layout, as numpy: ``{"p{j}": {"self": {field: leaf},
    ...}}`` with layer ``b·bs + j`` at index ``b`` of each leaf."""
    from .models.transformer import block_size, layer_plan

    bs = block_size(layer_plan(cfg))
    out = {}
    for j in range(bs):
        layers = cache[j::bs]
        out[f"p{j}"] = {
            part: {f: np.stack([_to_numpy(getattr(c[part], f))
                                for c in layers])
                   for f in layers[0][part]._fields}
            for part in layers[0]}
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
