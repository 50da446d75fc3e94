"""Parity of the port's partition specs (``distributed.partition``) with
the JAX package's, for every parameter of the ten archs at their published
configs and at ``get_reduced``, on the CPU.

The JAX package stacks layers on a leading axis whose spec entry is
``None``; the port's layer ``b·bs + j`` (and encoder layer ``i``) is a
tensor of its own, whose spec must be the JAX leaf's without that entry
(``models.transformer.stack_position`` names the JAX leaf).  Full configs
are built on the ``meta`` device (shapes only), JAX's through
``jax.eval_shape``.  Every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.distributed import partition as jpart
from repro.launch.specs import abstract_params
from repro.models import transformer as jtr
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch.distributed import partition as tpart
from repro_torch.distributed.sharding import ShardingRules, make_rules
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer as ttr
from repro_torch.train import step as tstep

ARCHS = [a for a in jcfg.list_archs() if a != "snn-mnist"]


def _flat(tree, is_leaf=None):
    return {".".join(str(getattr(e, "key", getattr(e, "name", getattr(
        e, "idx", e)))) for e in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]}


def _meta_model(cfg):
    with torch.device("meta"):
        return ttr.Transformer(cfg, generator=None)


def _per_layer(jspecs: dict, tspecs: dict, cfg, what):
    """Every port leaf's spec is its JAX leaf's, less the stacked axis."""
    seen = set()
    for name, spec in tspecs.items():
        pos = ttr.stack_position(cfg, name)
        path = name if pos is None else pos[0]
        want = jspecs[path] if pos is None else jspecs[path][1:]
        if pos is not None:
            assert jspecs[path][0] is None, (what, path)
        assert tuple(spec) == tuple(want), (what, name, spec, want)
        seen.add(path)
    assert seen == set(jspecs), (what, set(jspecs) - seen)


@pytest.mark.parametrize("full", [True, False], ids=["published", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_match_jax(arch, full):
    jc = jcfg.get_config(arch) if full else jcfg.get_reduced(arch)
    tc = tcfg.get_config(arch) if full else tcfg.get_reduced(arch)
    jshape = abstract_params(jc)
    jspecs = jpart.param_specs(jc, jshape)
    model = _meta_model(tc)
    tspecs = tpart.param_specs(tc, model)
    _per_layer(_flat(jspecs, jpart._is_spec_leaf), tspecs, tc, "params")
    for opt in ("adamw", "sgd", "adafactor"):
        jo = jpart.opt_state_specs(opt, jspecs, jshape)
        to = tpart.opt_state_specs(opt, tspecs, model, cfg=tc)
        assert to._fields == jo._fields and to.step == jo.step == ()
        for f in to._fields[1:]:
            _per_layer(_flat(getattr(jo, f), jpart._is_spec_leaf),
                       getattr(to, f), tc, f"{opt}.{f}")


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "whisper-small"])
def test_train_state_specs_and_resolution(arch):
    jc, tc = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
    s = tstep.TrainSettings(grad_compression="int8_ef")
    st = tstep.init_state(None, tc, s, device="cpu")
    jst = jstep.init_state(jax.random.PRNGKey(0), jc, jstep.TrainSettings(
        grad_compression="int8_ef"))
    tsp = tpart.train_state_specs(tc, tc.optimizer, st)
    jsp = jpart.train_state_specs(jc, jc.optimizer, jst)
    assert tsp.step == jsp.step == ()
    _per_layer(_flat(jsp.comp_err, jpart._is_spec_leaf), tsp.comp_err, tc,
               "comp_err")
    # every spec names as many axes as its leaf has dims, and the shapes
    # of the real state match the specs' layout (Adafactor's included)
    for f in st.opt_state._fields[1:]:
        for n, t in getattr(st.opt_state, f).items():
            assert len(getattr(tsp.opt_state, f)[n]) == t.dim(), (f, n)
    mesh = make_local_mesh(devices=["cpu"])
    rules = make_rules(mesh, fsdp=True)
    res = tpart.to_shardings(mesh, rules, tsp, st)
    assert res.params["embed"] == rules.spec_for_shape(
        tuple(st.params.embed.shape), "vocab", "fsdp")
    wide = ShardingRules(rules.rules, {"data": 2, "model": 4})
    got = tpart.to_shardings(mesh, wide, tsp, st)
    for n, p in st.params.named_parameters():
        assert got.params[n] == wide.spec_for_shape(
            tuple(p.shape), *tsp.params[n]), n
    assert tpart.to_shardings(mesh, wide, tsp).params["embed"] == \
        wide.spec("vocab", "fsdp")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-small",
                                  "gemma2-9b"])
@pytest.mark.parametrize("decode", [True, False])
def test_cache_and_batch_specs_match_jax(arch, decode):
    jc, tc = jcfg.get_reduced(arch), tcfg.get_reduced(arch)
    jspecs = jpart.cache_specs(jc, jtr.init_cache(jc, 2, 16), decode=decode)
    tspecs = tpart.cache_specs(tc, ttr.init_cache(tc, 2, 16, device="cpu"),
                               decode=decode)
    bs = ttr.block_size(ttr.layer_plan(tc))
    for i, entry in enumerate(tspecs):
        for part, c in entry.items():
            jc_ = jspecs[f"p{i % bs}"][part]
            for f in c._fields:
                want = getattr(jc_, f)
                assert want[0] is None
                assert getattr(c, f) == tuple(want[1:]), (i, part, f)
    batch = {"tokens": np.zeros((2, 8), np.int32),
             "frames": np.zeros((2, 4, 3), np.float32)}
    assert tpart.batch_specs(batch) == jpart.batch_specs(batch)
