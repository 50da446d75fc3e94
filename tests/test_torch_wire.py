"""Parity of the port's wire codec and ledger with the JAX package's, on the
CPU, and lane checkpoints that cross between the two packages.

A lane row's wire dict is the same in both packages: a row one package's
engine checkpoints mid-window goes through that package's
``lane_to_wire`` and JSON into the other's ``lane_from_wire``, and the
other engine adopts it and finishes the window bit-identically.  Refused
rows fail with the JAX package's messages, and the ledger's torn-tail
repair and ``recover_accounting`` give the same records on the same
files.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.serve.ledger as jledger
import repro.serve.wire as jwire
import repro_torch.serve.ledger as tledger
import repro_torch.serve.wire as twire
from test_torch_tier_common import JAX, TORCH, _both, _cfg, _engine, _plan, \
    _results, small_net

SIZES, T = (16, 12, 8), 10


def _engine_mid_window(pkg, p, imgs, chunks=2):
    eng = _engine(pkg, p, _cfg(pkg, SIZES, T), batch_size=4, chunk_steps=2,
                  patience=10_000, seed=13, backend="reference")
    for im in imgs:
        eng.submit(im)
    for _ in range(chunks):
        eng.step()
    return eng


def _rows_json(wire, rows):
    return json.dumps([[rid, wire.lane_to_wire(row)] for rid, row in rows])


def test_lane_rows_are_the_same_wire_dicts_in_both_packages():
    rng = np.random.default_rng(40)
    p = small_net(rng, SIZES)
    imgs = rng.integers(0, 256, (6, SIZES[0]), dtype=np.uint8)
    rows = {pkg.name: _engine_mid_window(pkg, p, imgs).checkpoint_lanes()
            for pkg in (JAX, TORCH)}
    assert len(rows["torch"]) == 4
    assert _rows_json(twire, rows["torch"]) == _rows_json(jwire, rows["jax"])
    for _, row in rows["torch"]:
        back = twire.lane_from_wire(json.loads(json.dumps(
            twire.lane_to_wire(row))))
        for a, b in zip(jax_leaves(back), jax_leaves(row)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def jax_leaves(row):
    return [x for f in row for x in (f if isinstance(f, tuple) else (f,))]


@pytest.mark.parametrize("src,dst", [(JAX, TORCH), (TORCH, JAX)])
def test_checkpoint_adopts_across_packages_and_finishes_alike(src, dst):
    """A window checkpointed mid-way by one package's engine finishes in
    the other's exactly as the source engine finishes it."""
    rng = np.random.default_rng(41)
    p = small_net(rng, SIZES)
    imgs = rng.integers(0, 256, (6, SIZES[0]), dtype=np.uint8)
    eng = _engine_mid_window(src, p, imgs)
    rows = json.loads(_rows_json(src.serve.wire, eng.checkpoint_lanes()))
    want = _results(eng.run())
    adopter = _engine(dst, p, _cfg(dst, SIZES, T), batch_size=4,
                      chunk_steps=3, patience=10_000, seed=13,
                      backend="reference")
    for rid, d in rows:
        row = dst.serve.wire.lane_from_wire(d)
        assert 0 < int(row.steps) < T
        adopter.adopt(rid, row)
    got = _results(adopter.run())
    assert set(got) == {rid for rid, _ in rows}
    assert got == {rid: want[rid] for rid in got}


def test_results_params_and_plans_encode_alike():
    rng = np.random.default_rng(42)
    p = small_net(rng, SIZES)
    imgs = rng.integers(0, 256, (5, SIZES[0]), dtype=np.uint8)

    def case(pkg):
        eng = _engine(pkg, p, _cfg(pkg, SIZES, T), batch_size=4,
                      chunk_steps=4, patience=2, seed=3, backend="reference")
        for im in imgs:
            eng.submit(im)
        res = eng.run()
        w = pkg.serve.wire
        plan = _plan(pkg, [dict(kind="dispatch", engine=0, first_chunk=2,
                                last_chunk=5, backends=("fused",)),
                           dict(kind="poison", request_id=4)],
                     seed=9, dispatch_rate=0.25)
        out = {"results": [w.result_to_wire(r) for r in res.values()],
               "params": w.params_to_wire(pkg.params(p)),
               "planes": w.planes_to_wire(tuple(
                   l["w_q"] for l in pkg.params(p)["layers"])),
               "plan": w.plan_to_wire(plan),
               "fault_cfg": w.fault_cfg_to_wire(
                   pkg.serve.FaultToleranceConfig(max_retries=1)),
               "none": (w.plan_to_wire(None), w.fault_cfg_to_wire(None))}
        back = w.plan_from_wire(json.loads(json.dumps(out["plan"])))
        out["plan_back"] = [dataclasses.asdict(e) for e in back.events]
        out["results_back"] = _results({
            r["request_id"]: w.result_from_wire(r) for r in out["results"]})
        out["params_back"] = [
            (np.asarray(l["w_q"]).tolist(), float(l["scale"]))
            for l in w.params_from_wire(out["params"])["layers"]]
        return json.loads(json.dumps(out, default=repr))

    st = _both(case)
    assert st["plan_back"][0]["backends"] == ["fused"]


@pytest.mark.parametrize("variant", [{}, {"qat": False,
                                      "surrogate_slope": 2.5,
                                      "train_threshold": 0.75}])
@pytest.mark.parametrize("name", ["SNN_CONFIG", "SNN_CONFIG_PRUNED",
                                  "SNN_CONFIG_DEEP", "SNN_CONFIG_WIDE"])
def test_snn_configs_cross_the_wire_between_packages(name, variant):
    """F-ag: a JAX-encoded config (the JAX coordinator's ``init`` RPC
    carries one) decodes in the port to the port's config, the port's
    encoding decodes in JAX to JAX's, and both encodings are the same
    JSON, the training fields ``qat``, ``surrogate_slope`` and
    ``train_threshold`` included."""
    j = dataclasses.replace(getattr(JAX.cfgs, name), **variant)
    t = dataclasses.replace(getattr(TORCH.cfgs, name), **variant)
    j_json = json.dumps(jwire.snn_cfg_to_wire(j))
    t_json = json.dumps(twire.snn_cfg_to_wire(t))
    assert t_json == j_json
    assert twire.snn_cfg_from_wire(json.loads(j_json)) == t
    assert jwire.snn_cfg_from_wire(json.loads(t_json)) == j


def test_port_config_and_tensors_roundtrip():
    cfg = dataclasses.replace(TORCH.cfgs.SNN_CONFIG_PRUNED, sparse_skip=False)
    d = json.loads(json.dumps(twire.snn_cfg_to_wire(cfg)))
    assert twire.snn_cfg_from_wire(d) == cfg
    for t in (torch.arange(-5, 7, dtype=torch.int16).reshape(3, 4),
              torch.tensor([1, 2**32 - 1], dtype=torch.int64).to(
                  torch.int32).view(torch.uint32),
              torch.ones(2, 3, dtype=torch.bool), torch.tensor(7)):
        a = twire.array_from_wire(json.loads(json.dumps(
            twire.array_to_wire(t))))
        h = twire._host(t)
        assert a.dtype == h.dtype and a.tobytes() == h.tobytes()
    assert twire.array_to_wire(torch.tensor([1, 2], dtype=torch.int32)) == \
        jwire.array_to_wire(np.array([1, 2], np.int32))
    assert twire.WIRE_CODEC_VERSION == jwire.WIRE_CODEC_VERSION == 1


def _bad_rows():
    rng = np.random.default_rng(43)
    p = small_net(rng, SIZES)
    eng = _engine_mid_window(TORCH, p, rng.integers(
        0, 256, (2, SIZES[0]), dtype=np.uint8))
    good = twire.lane_to_wire(eng.checkpoint_lanes()[0][1])
    missing = {"codec": 1, "leaves": {k: v for k, v in good["leaves"].items()
                                      if k not in ("rng", "gate_streak")}}
    return [[1, 2], {"leaves": {}}, dict(good, codec="1"),
            dict(good, codec=0), dict(good, codec=2), missing,
            {"codec": 1}]


@pytest.mark.parametrize("i", range(7))
def test_malformed_and_future_rows_refused_alike(i):
    bad = _bad_rows()[i]

    def case(pkg):
        with pytest.raises(pkg.serve.WireError) as ei:
            pkg.serve.wire.lane_from_wire(bad)
        return str(ei.value)

    _both(case)


def test_framing_crosses_packages():
    msg = {"kind": "step", "rows": [1, 2, {"x": "ü"}], "n": 2**40}
    for w_pkg, r_pkg in ((jwire, twire), (twire, jwire), (twire, twire)):
        r, w = os.pipe()
        try:
            w_pkg.write_msg(w, msg, timeout_s=5.0)
            assert r_pkg.read_msg(r, timeout_s=5.0) == msg
            os.close(w)
            w = None
            with pytest.raises(EOFError):
                r_pkg.read_msg(r)
        finally:
            os.close(r)
            if w is not None:
                os.close(w)
    r, w = os.pipe()
    try:
        with pytest.raises(TimeoutError):
            twire.read_msg(r, timeout_s=0.05)
    finally:
        os.close(r)
        os.close(w)


def test_read_frame_returns_the_frame_size():
    """``read_frame`` reads what ``read_msg`` reads, and counts the
    frame's header and body bytes."""
    msg = {"op": "step", "rows": ["x" * 100, {"y": "ü"}]}
    body = len(json.dumps(msg, separators=(",", ":")).encode("utf-8"))
    r, w = os.pipe()
    try:
        jwire.write_msg(w, msg, timeout_s=5.0)
        got, nbytes = twire.read_frame(r, timeout_s=5.0)
        assert got == msg
        assert nbytes - body == twire._HEADER.size
    finally:
        os.close(r)
        os.close(w)


_RECORDS = [{"kind": "submit", "rid": 0, "px": [1, 2]},
            {"kind": "submit", "rid": 1, "px": [3]},
            {"kind": "shed", "rid": 1, "reason": "deadline"},
            {"kind": "submit", "rid": 2, "px": [4]},
            {"kind": "fault", "rid": 2, "reason": "state_lost"},
            {"kind": "rollout", "version": 1},
            {"kind": "submit", "rid": 3, "px": [5]}]


def test_ledger_repair_and_recovery_match_jax(tmp_path):
    paths = {}
    for name, mod in (("jax", jledger), ("torch", tledger)):
        d = tmp_path / name
        coord, worker = str(d / "coord.jsonl"), str(d / "w0.jsonl")
        led = mod.Ledger(coord)
        for rec in _RECORDS:
            led.append(rec)
        led.close()
        with open(coord, "a") as f:
            f.write('{"kind": "result", "rid"')          # a torn tail
        w = mod.Ledger(worker)
        w.append({"kind": "result", "rid": 2, "pred": 7})
        w.append({"kind": "result", "rid": 2, "pred": 9})
        w.close()
        reopened = mod.Ledger(coord)                     # repairs the tail
        reopened.append({"kind": "result", "rid": 0, "pred": 1})
        reopened.close()
        paths[name] = (coord, worker)
    for a, b in zip(paths["jax"], paths["torch"]):
        assert open(a).read() == open(b).read()
        assert tledger.read_ledger(b) == jledger.read_ledger(a)
    got = tledger.recover_accounting(list(paths["torch"]))
    want = jledger.recover_accounting(list(paths["jax"]))
    assert got == want
    assert got["outstanding"] == [3] and set(got["results"]) == {0, 2}
    assert got["results"][2]["pred"] == 7 and got["faulted"] == {}


def test_corrupt_ledger_line_refused_alike(tmp_path):
    path = tmp_path / "led.jsonl"
    path.write_text('{"kind": "submit", "rid": 0}\nnot json\n'
                    '{"kind": "submit", "rid": 1}\n')
    msgs = []
    for mod in (jledger, tledger):
        with pytest.raises(mod.LedgerCorruptError) as ei:
            mod.read_ledger(str(path))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert tledger.read_ledger(str(tmp_path / "absent.jsonl")) == []
