"""The whole-window call's route on stacks the resident kernel cannot hold.

``snn_apply_int`` with ``backend="auto"`` on a card runs such a stack
layer by layer on the staged kernels, where ``resolve_backend``'s chain
reaches the weight-streaming kernel; an explicit ``fused_streamed``, the
chain itself and every resumable caller keep the streaming kernel.  The
decision is pure logic and needs no card.  The routed call still refuses
codes outside the signed 9-bit range before any launch, and two chained
calls, each on the lanes the one before returned, give the same outputs
on both routes (their plain versions on the CPU).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import snn_mnist as cfgs
from repro_torch.core import snn, spans
from repro_torch.core.prng import seed_state
from repro_torch.kernels import ops
from repro_torch.serve import SNNStreamEngine

WIDE = cfgs.SNN_CONFIG_WIDE
CUDA = torch.device("cuda")


@pytest.mark.parametrize("lanes", [64, 500, 1021, 10000])
def test_auto_routes_a_stack_k1_cannot_hold_to_staged(lanes):
    sizes = WIDE.layer_sizes
    assert snn._whole_window_backend(WIDE, None, sizes, lanes, CUDA) == \
        ("staged", True)
    assert snn._whole_window_backend(WIDE, "auto", sizes, lanes, CUDA) == \
        ("staged", True)
    # named, the streaming kernel runs; the chain itself is unchanged
    assert snn._whole_window_backend(WIDE, "fused_streamed", sizes, lanes,
                                     CUDA) == ("fused_streamed", True)
    assert snn.resolve_backend(WIDE, None, 3, layer_sizes=sizes,
                               local_batch=lanes,
                               device=CUDA) == "fused_streamed"
    # 784→10 fits the resident kernel; wide codes are the staged kernels'
    one = cfgs.SNN_CONFIG
    assert snn._whole_window_backend(one, None, one.layer_sizes, lanes,
                                     CUDA) == ("fused", True)
    assert snn._whole_window_backend(WIDE, "staged", sizes, lanes, CUDA) == \
        ("staged", False)
    assert snn._whole_window_backend(WIDE, None, sizes, lanes, "cpu") == \
        ("reference", False)


def _codes(sizes, seed, std=60):
    rng = np.random.default_rng(seed)
    return {"layers": [
        {"w_q": torch.from_numpy(np.clip(np.round(rng.normal(
            6, std, (i, o))), -256, 255).astype(np.int16))}
        for i, o in zip(sizes[:-1], sizes[1:])]}


def test_resumable_callers_keep_the_streaming_kernel(monkeypatch):
    params = {"layers": [{"w_q": torch.zeros((i, o), dtype=torch.int16)}
                         for i, o in zip(WIDE.layer_sizes[:-1],
                                         WIDE.layer_sizes[1:])]}
    eng = types.SimpleNamespace(layer_sizes=WIDE.layer_sizes,
                                local_batch=1024, model_shards=1,
                                device=CUDA, cache_decision=None)
    assert SNNStreamEngine._resolve_backend(
        eng, WIDE, "auto", shapes=(4, 1024)) == "fused_streamed"
    seen = []

    def stack_op(*args, **kw):
        seen.append(kw["streamed"])
        raise RuntimeError("stop before the launch")

    monkeypatch.setattr(ops, "fused_snn_stack_op", stack_op)
    on_card = types.SimpleNamespace(shape=(100, 784), device=CUDA)
    state = snn.snn_window_init(params, torch.ones(
        (100, 784), dtype=torch.int32).view(torch.uint32), WIDE)
    with pytest.raises(RuntimeError, match="stop before"):
        snn.snn_window_chunk(params, on_card, state, WIDE, chunk_steps=4)
    assert seen == [True]


def _on_card_route(monkeypatch):
    """Resolve as on a card while the tensors stay on the CPU, and count
    every launcher the whole-window call could reach."""
    resolve = snn.resolve_backend
    monkeypatch.setattr(snn, "resolve_backend", lambda *a, **kw: resolve(
        *a, **dict(kw, device=CUDA)))
    calls = {"encode": 0, "lif": 0, "stack": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    # the staged call launches the kernels' readout ops
    for name, attr in (("encode", "poisson_encode_op"),
                       ("encode", "poisson_encode_readout_op"),
                       ("lif", "lif_forward_op"),
                       ("lif", "lif_forward_readout_op"),
                       ("stack", "fused_snn_stack_op")):
        monkeypatch.setattr(ops, attr, counted(name, getattr(ops, attr)))
    return calls


@pytest.mark.parametrize("bad", [256, -257])
def test_routed_call_refuses_wide_codes_before_any_launch(monkeypatch, bad):
    calls = _on_card_route(monkeypatch)
    params = {"layers": [{"w_q": torch.zeros((i, o), dtype=torch.int16)}
                         for i, o in zip(WIDE.layer_sizes[:-1],
                                         WIDE.layer_sizes[1:])]}
    params["layers"][1]["w_q"][7, 3] = bad
    px = torch.zeros((8, 784), dtype=torch.uint8)
    st = seed_state(3, (8, 784), device="cpu")
    with pytest.raises(ValueError, match="layer 1 weight codes"):
        snn.snn_apply_int(params, px, st, WIDE)
    assert calls == {"encode": 0, "lif": 0, "stack": 0}
    # named, the staged kernels take any int16 code
    snn.snn_apply_int(params, px, st, WIDE, backend="staged")
    assert calls == {"encode": 1, "lif": 3, "stack": 0}


def test_routed_call_runs_the_staged_kernels(monkeypatch):
    calls = _on_card_route(monkeypatch)
    params = _codes(WIDE.layer_sizes, 5, std=12)
    rng = np.random.default_rng(5)
    px = torch.from_numpy(rng.integers(0, 256, (8, 784), dtype=np.uint8))
    st = seed_state(5, (8, 784), device="cpu")
    with spans.recording() as rec:
        got = snn.snn_apply_int(params, px, st, WIDE)
    assert calls == {"encode": 1, "lif": 3, "stack": 0}
    assert rec.counters == {"host_syncs": 6, "snn.apply_int.staged": 1}
    assert got["input_spikes"] is not None
    assert int(got["spike_counts"].sum()) > 0


_SMALL = dataclasses.replace(WIDE, layer_sizes=(200, 256, 96, 10))


def test_chained_calls_equal_across_routes():
    """Two calls, the second on the lanes the first returned, at 100 lanes
    (a multiple of neither 64 nor 128): every output of the staged route
    equals the streaming kernel's (``input_spikes`` only the staged
    kernels keep), the lanes' dtype included."""
    sizes = _SMALL.layer_sizes
    params = _codes(sizes, 9)
    rng = np.random.default_rng(9)
    px = [torch.from_numpy(rng.integers(0, 256, (100, sizes[0]),
                                        dtype=np.uint8)) for _ in range(2)]
    outs = {}
    for b in ("staged", "fused_streamed"):
        lanes = seed_state(9, (100, sizes[0]), device="cpu")
        with spans.recording() as rec:
            outs[b] = []
            for x in px:
                outs[b].append(snn.snn_apply_int(params, x, lanes, _SMALL,
                                                 backend=b))
                lanes = outs[b][-1]["prng_state"]
        assert rec.counters["snn.apply_int." + b] == 2
        assert "snn.apply_int.reference" not in rec.counters
    for got, want in zip(outs["staged"], outs["fused_streamed"]):
        assert want["input_spikes"] is None
        assert sorted(got) == sorted(want)
        assert int(want["spike_counts"].sum()) > 0
        for k in want:
            if k == "input_spikes":
                continue
            g, w = got[k], want[k]
            if isinstance(w, torch.Tensor):
                g, w = (g,), (w,)
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == b.shape, k
                if a.dtype == torch.uint32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b), k
