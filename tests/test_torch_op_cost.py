"""The port's op-level cost counter (``launch.op_cost``), on the CPU.

(1) By itself: flops of ``mm``, ``bmm``, ``addmm`` and ``einsum`` against
hand counts (2·R·K); views free; an in-place op's operand counted once;
``peak_bytes`` of a scripted allocate / free sequence on ``meta``; the
collective bytes of ``all_reduce`` (2× the tensor) and ``all_gather``
(the gathered result) on a one-rank ``gloo`` group; on a two-rank
``fake`` group, rank 0 of a column-parallel linear over DTensors counts
its local product and the all-gather of its output shard, and rank 0 of
an expert-parallel MoE layer its own experts' products and one
all-reduce.

(2) Against the JAX package's ``hlo_cost``: the flops of the port's train
step (all ten reduced archs) and of prefill and decode (qwen3, dbrx,
mamba2, whisper), run on ``meta`` tensors, against ``hlo_cost`` of the
same step compiled by XLA on one CPU device, on the same reduced config
and shapes (batch 4, 32 tokens, 2 microbatches, the dry-run's
``cast_params="bfloat16"``; serving on bf16 parameters), within 1%.
Both count 2·R·K per matrix product.  Most cells agree exactly.  The
MoE archs' train steps (arctic, dbrx) count 0.9% more here: the port's
program runs seven products of the dispatch/combine size (E × G·C × Sg ×
D) per MoE layer and microbatch, and XLA's compiled one runs exactly one
such product fewer (the totals differ by that product's flops).  mamba2's
and jamba's train steps count 0.2% fewer; their prefill and decode agree
exactly, so the difference lies in the backward.  All stay inside 1%.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro import configs as jcfg
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import hlo_cost
from repro.serve import engine as jeng
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch import train as tstep
from repro_torch.launch import specs as tspecs
from repro_torch.launch.op_cost import OpCounter, cost_log, op_cost, top_costs
from repro_torch.serve.engine import make_decode_step, make_prefill

META = torch.device("meta")
ARCHS = [a for a in jcfg.list_archs() if a != "snn-mnist"]
SERVE_ARCHS = ["qwen3-4b", "dbrx-132b", "mamba2-1.3b", "whisper-small"]
B, S, NM = 4, 32, 2
FLOPS_REL = 1e-2


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---- (1) the counter by itself ---------------------------------------------

@pytest.mark.parametrize("fn,args,want", [
    (torch.mm, ((8, 16), (16, 4)), 2 * 8 * 4 * 16),
    (torch.bmm, ((3, 8, 16), (3, 16, 5)), 2 * 3 * 8 * 5 * 16),
    (lambda c, a, b: torch.addmm(c, a, b), ((8, 4), (8, 16), (16, 4)),
     2 * 8 * 4 * 16),
    (lambda a, b: torch.einsum("bqd,bkd->bqk", a, b), ((2, 6, 10), (2, 7, 10)),
     2 * 2 * 6 * 7 * 10),
    (lambda a, b: torch.einsum("bsd,dhk->bshk", a, b), ((2, 6, 10), (10, 3, 4)),
     2 * 2 * 6 * 12 * 10),
])
def test_matmul_flops_match_hand_counts(fn, args, want):
    cost, log = op_cost(fn, *[_m(*s) for s in args])
    assert cost.flops == want
    assert cost.collective_total == 0


def test_elementwise_work_is_not_flops_and_bytes_are_operands_plus_results():
    a, b = _m(10, 10), _m(10, 10)
    cost, _ = op_cost(lambda x, y: torch.tanh(x * y), a, b)
    assert cost.flops == 0
    # mul reads 2·400 B and writes 400; tanh reads 400 and writes 400
    assert cost.bytes == 3 * 400 + 2 * 400


def test_views_are_free_and_an_in_place_operand_counts_once():
    x = _m(10, 10)

    def views(t):
        return t.view(100).t().reshape(10, 10).detach()[2:5].transpose(0, 1)

    assert op_cost(views, x)[0].bytes == 0
    y = _m(10, 10)
    # add_: x read and written in place (400 B once) + y read (400 B)
    assert op_cost(lambda t, u: t.add_(u), x, y)[0].bytes == 800
    # out-of-place add: both read, a new result written
    assert op_cost(lambda t, u: t + u, x, y)[0].bytes == 1200
    # the same storage read through two views is one operand each time
    log = op_cost(lambda t: t[:5] * t[5:], x)[1]
    assert cost_log(log).bytes == 200 + 200 + 200


def test_peak_bytes_of_a_scripted_sequence():
    """Inputs live from the start; each new storage adds its bytes when an
    op returns it and gives them back when its last tensor dies; views
    share their storage."""
    def script(x):                          # x: 1,000 B
        a = torch.empty(250, device=META)   # +1,000 -> 2,000
        b = a.view(25, 10)                  # a view: no new storage
        c = x * 2                           # +1,000 -> 3,000
        del a, b                            # -1,000 -> 2,000
        d = torch.empty(500, device=META)   # +2,000 -> 4,000 (the peak)
        del c, d                            # -3,000 -> 1,000
        e = torch.empty(100, device=META)   # +400   -> 1,400
        return e

    cost, log = op_cost(script, _m(250))
    assert cost.peak_bytes == 4000
    assert log[0][0] == "<inputs>" and log[0][4] == 1000
    assert [e[4] for e in log[1:]] == [2000, 2000, 3000, 4000, 1400]


def test_host_storages_are_not_device_memory():
    cost, _ = op_cost(lambda x: torch.ones(1000) + 1, _m(10))
    assert cost.peak_bytes == 40


def test_module_paths_and_top_costs():
    """Each op carries the nn.Module path that issued it, the backward's
    products the module whose forward built their nodes; top_costs groups
    identical (op, module, shapes) rows with their multiplicity."""
    cfg = tcfg.get_reduced("qwen3-4b")
    state = tstep.init_state(None, cfg, tstep.TrainSettings(), lambda g:
                             tspecs.abstract_params(cfg), device=META)
    batch = tspecs.train_inputs(cfg, tcfg.ShapeConfig("t", S, B, "train"))
    cost, log = op_cost(tstep.make_train_step(cfg, tstep.TrainSettings()),
                        state, batch)
    mods = {e[1] for e in log}
    assert {"layers.0", "layers.1", "layers.0.ln1", "layers.1 (backward)",
            "layers.0.ln2 (backward)", ""} <= mods
    top = top_costs(log, 5)
    assert len(top["by_flops"]) == 5 and top["by_collective"] == []
    assert top["by_flops"][0]["flops"] >= top["by_flops"][-1]["flops"] > 0
    assert all(r["mult"] >= 1 for r in top["by_bytes"])
    assert sum(r["flops"] for r in top_costs(log, 10 ** 6)["by_flops"]) == \
        cost.flops


@pytest.fixture
def gloo_group():
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "store"), world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_collective_bytes_on_a_gloo_group(gloo_group):
    x = torch.ones(4, 8)
    out = [torch.empty(4, 8)]
    flat = torch.empty(4, 8)

    def comms():
        dist.all_reduce(x)
        dist.all_gather(out, x)
        dist.all_gather_into_tensor(flat, x)

    cost, log = op_cost(comms)
    assert cost.collectives["all-reduce"] == 2 * 128
    assert cost.collectives["all-gather"] == 128 + 128
    assert cost.collective_total == 512
    assert cost.flops == 0 and cost.bytes > 0
    assert [e[0] for e in log if e[0].startswith("c10d")] == [
        "c10d.allreduce_", "c10d.allgather_", "c10d._allgather_base_"]
    top = top_costs(log)["by_collective"]
    assert top[0]["op"] == "c10d.allreduce_" and top[0]["mult"] == 1


def test_rank0_of_a_column_parallel_linear_on_a_fake_group():
    """y = x · w with w's columns split over two ranks, then gathered:
    rank 0 counts the (8, 16) × (16, 3) shard product, not the whole
    (16, 6) one, and the all-gather's result bytes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_group

    with fake_group(2):
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        x = DTensor.from_local(_m(8, 16), mesh, [Replicate()])
        w = DTensor.from_local(_m(16, 3), mesh, [Shard(1)])
        cost, log = op_cost(
            lambda a, b: (a @ b).redistribute(mesh, [Replicate()]), x, w)
    assert cost.flops == 2 * 8 * 3 * 16
    # all-gather: max(result, operand) = the (8, 6) float32 result
    assert cost.collectives["all-gather"] == 8 * 6 * 4
    assert cost.collective_counts["all-gather"] == 1
    assert cost.collective_total == 8 * 6 * 4
    assert not any(e[0].startswith("aten.") and e[2] and
                   e[2][0][0] == [16, 6] for e in log)
    assert log[0][4] == (8 * 16 + 16 * 3) * 4     # the local shards


def test_rank0_of_an_expert_parallel_moe_on_a_fake_group():
    """A reduced dbrx MoE layer (4 experts, top 2) placed on a 1×2 (data ×
    model) mesh of a two-rank ``fake`` group: rank 0 routes every token
    (the router's product whole), runs its 2 of the 4 experts (the
    dispatch, the three expert products and the combine at 2 experts),
    and its partial output is reduced by one all-reduce; no all-to-all."""
    from repro_torch.distributed.partition import (param_specs, place,
                                                   to_shardings)
    from repro_torch.distributed.sharding import (make_device_mesh,
                                                  make_rules, shard,
                                                  use_rules)
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.models.ffn import _capacity, moe_apply, moe_params

    cfg = tcfg.get_reduced("dbrx-132b")
    b, s, d, f, e = 2, cfg.moe_group, cfg.d_model, cfg.d_ff, \
        cfg.moe_num_experts
    c = _capacity(s, cfg.moe_top_k, e, cfg.moe_capacity_factor)
    with fake_group(2):
        mesh = make_device_mesh((1, 2), ("data", "model"),
                                devices=[META] * 2)
        rules = make_rules(mesh, fsdp=False)
        with use_rules(rules), torch.device(META):
            moe = moe_params(cfg, generator=None)
            moe = place(moe, to_shardings(mesh, rules, param_specs(
                cfg, moe), moe), mesh)
            x = place(_m(b, s, d), (None, None, None), mesh)
            cost, log = op_cost(lambda m, t: shard(
                moe_apply(m, t, cfg, group_size=cfg.moe_group)[0],
                "batch", None, "embed"), moe, x)
    e_loc = e // 2
    want = 2 * b * s * d * e                      # the router, every expert
    want += 2 * 2 * b * s * e_loc * c * d         # dispatch and combine
    want += 3 * 2 * e_loc * b * c * d * f         # w1, w3, w2
    assert cost.flops == want
    assert cost.collective_counts["all-reduce"] == 1
    assert sum(cost.collective_counts.values()) == 1
    assert cost.collectives["all-reduce"] == 2 * b * s * d * 4


# ---- (2) against the JAX package's hlo_cost --------------------------------

def _shape(kind):
    return tcfg.ShapeConfig("t", S, B, kind)


def _jax_flops(arch: str, kind: str) -> float:
    cfg = jcfg.get_reduced(arch)
    shape = jcfg.ShapeConfig("t", S, B, kind)
    if kind == "train":
        s = jstep.TrainSettings(num_microbatches=NM, cast_params="bfloat16")
        st = jax.eval_shape(lambda k: jstep.init_state(k, cfg, s),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
        fn = jax.jit(jstep.make_train_step(cfg, s), donate_argnums=(0,))
        args = (st, jspecs.train_inputs(cfg, shape))
    else:
        p = jax.tree.map(
            lambda l: jax.ShapeDtypeStruct(
                l.shape, jnp.bfloat16 if jnp.issubdtype(l.dtype, jnp.floating)
                else l.dtype), jspecs.abstract_params(cfg))
        if kind == "prefill":
            fn = jax.jit(jeng.make_prefill(cfg, max_len=S))
            args = (p, jspecs.prefill_inputs(cfg, shape))
        else:
            fn = jax.jit(jeng.make_decode_step(cfg), donate_argnums=(1,))
            args = (p, jspecs.decode_state_spec(cfg, shape))
    return hlo_cost(fn.lower(*args).compile().as_text()).flops


def _torch_flops(arch: str, kind: str) -> float:
    cfg = tcfg.get_reduced(arch)
    if kind == "train":
        s = tstep.TrainSettings(num_microbatches=NM, cast_params="bfloat16")
        state = tstep.init_state(None, cfg, s, lambda g:
                                 tspecs.abstract_params(cfg), device=META)
        fn, args = tstep.make_train_step(cfg, s), \
            (state, tspecs.train_inputs(cfg, _shape(kind)))
    else:
        params = tspecs.abstract_params(cfg).to(torch.bfloat16)
        if kind == "prefill":
            fn, args = make_prefill(cfg, max_len=S), \
                (params, tspecs.prefill_inputs(cfg, _shape(kind)))
        else:
            fn, args = make_decode_step(cfg), \
                (params, tspecs.decode_state_spec(cfg, _shape(kind)))
    with OpCounter(*args) as ctr:
        fn(*args)
    return cost_log(ctr.log).flops


CELLS = [(a, "train") for a in ARCHS] + \
    [(a, k) for a in SERVE_ARCHS for k in ("prefill", "decode")]


@pytest.fixture(scope="module")
def jax_flops():
    return {cell: _jax_flops(*cell) for cell in CELLS}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_op_cost_flops_match_jax_hlo_cost(jax_flops, arch, kind):
    want = jax_flops[(arch, kind)]
    got = _torch_flops(arch, kind)
    assert want > 0
    assert abs(got / want - 1) <= FLOPS_REL, (arch, kind, got, want)
