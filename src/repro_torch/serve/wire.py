"""Versioned wire codec + length-prefixed framing for the cluster RPC
(port of ``repro.serve.wire``).

The process-level failover layer (``serve.cluster``) moves three kinds of
state across a process boundary: ``LaneState`` rows (the chunk-boundary
checkpoint — evacuating a dead host's lanes into a healthy host's
adoption queue), weight planes (``WeightBank`` version replay on a
respawned worker), and ``EngineLoad`` records (the routing surface over
RPC).  Everything here is JSON-representable on purpose — the container
ships no msgpack, and JSON keeps the ledger (``serve.ledger``) and the
RPC frames human-debuggable — with numpy arrays carried as
``{dtype, shape, b64(raw bytes)}`` so the roundtrip is **bit-identical**:
the decoded row has the same dtypes, shapes and bytes as the source, and
adopting it resumes the window bit-exactly (the chunked==one-shot
invariant makes the row a complete, placement-independent checkpoint).

The lane codec is **versioned**: :data:`WIRE_CODEC_VERSION` is stamped
into every encoded row and :func:`lane_from_wire` refuses rows from a
*newer* codec with an actionable message — a mixed-version fleet must
fail loudly at the boundary, not silently misinterpret checkpoint bytes.

Framing is 4-byte big-endian length + JSON body.  The reader exists in
two flavours: the worker blocks forever (its liveness is the
coordinator's problem), the coordinator reads under a wall-clock
deadline (the heartbeat: a worker that cannot produce its frame within
``heartbeat_deadline_s`` is declared hung — the engines' watchdog
semantics across a process boundary).  The writer mirrors that split: the
coordinator passes the same deadline to :func:`write_msg` so a hung
worker whose pipe buffer has filled cannot block the coordinator inside
``os.write`` — overdue writes and overdue reads both mean "hung".

Host lane rows are numpy arrays with the reference package's dtypes, so
one row's wire dict is the same in both packages: a row checkpointed by
either package's engine adopts into the other's.  Tensors are encoded
through their host copy (uint32 through its int32 view); nothing here
touches a device otherwise.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import select
import struct

import numpy as np
import torch

__all__ = [
    "WIRE_CODEC_VERSION", "WireError",
    "array_to_wire", "array_from_wire",
    "lane_to_wire", "lane_from_wire",
    "params_to_wire", "params_from_wire",
    "planes_to_wire", "planes_from_wire",
    "snn_cfg_to_wire", "snn_cfg_from_wire",
    "fault_cfg_to_wire", "fault_cfg_from_wire",
    "plan_to_wire", "plan_from_wire",
    "result_to_wire", "result_from_wire",
    "write_msg", "read_msg",
]

# Bump when the LaneState row layout (fields, dtypes, meaning) changes.
WIRE_CODEC_VERSION = 1


class WireError(ValueError):
    """A frame or encoded object that cannot be (de)serialized safely."""


# ---- arrays ---------------------------------------------------------------

def _host(a) -> np.ndarray:
    """A numpy array of ``a``: tensors through their host copy (uint32
    through its int32 view, which numpy reads back as uint32)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.uint32:
            return t.view(torch.int32).numpy().view(np.uint32)
        return t.numpy()
    return np.asarray(a)


def array_to_wire(a) -> dict:
    """Encode one array, tensor or scalar dtype/shape/byte-exactly."""
    a = _host(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(
                np.ascontiguousarray(a).tobytes()).decode("ascii")}


def array_from_wire(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["b64"]),
                      dtype=np.dtype(d["dtype"]))
    # .copy(): frombuffer views are read-only, and adopted rows are
    # written into the host lane tile field-by-field
    return a.reshape(tuple(d["shape"])).copy()


# ---- LaneState rows -------------------------------------------------------

def lane_to_wire(row) -> dict:
    """One host ``LaneState`` row (``engine.snapshot_lanes`` /
    ``checkpoint_lanes`` element) → versioned JSON-safe dict."""
    leaves = {}
    for f in row._fields:
        v = getattr(row, f)
        leaves[f] = ([array_to_wire(x) for x in v] if isinstance(v, tuple)
                     else array_to_wire(v))
    return {"codec": WIRE_CODEC_VERSION, "leaves": leaves}


def lane_from_wire(d: dict):
    """Decode a wire row back into a host ``LaneState`` (bit-identical).

    Rejects rows stamped with a codec version this build does not know:
    a newer coordinator/worker may have changed the row layout, and
    guessing at unknown checkpoint bytes would corrupt a window silently.
    """
    from .snn_engine import LaneState
    if not isinstance(d, dict) or "codec" not in d:
        raise WireError(
            "not a lane checkpoint: missing the 'codec' version stamp "
            "(expected the dict produced by lane_to_wire)")
    ver = d["codec"]
    if not isinstance(ver, int) or ver < 1:
        raise WireError(f"lane checkpoint carries invalid codec version "
                        f"{ver!r} (expected an integer >= 1)")
    if ver > WIRE_CODEC_VERSION:
        raise WireError(
            f"lane checkpoint uses wire codec version {ver}, but this "
            f"build understands versions <= {WIRE_CODEC_VERSION} — the "
            f"peer that produced it is newer; upgrade this "
            f"coordinator/worker (or roll the peer back) before "
            f"evacuating lanes across the pair")
    leaves = d.get("leaves", {})
    missing = [f for f in LaneState._fields if f not in leaves]
    if missing:
        raise WireError(f"lane checkpoint (codec {ver}) is missing "
                        f"fields {missing} — truncated or corrupt row")
    kw = {}
    for f in LaneState._fields:
        v = leaves[f]
        kw[f] = (tuple(array_from_wire(x) for x in v)
                 if isinstance(v, list) else array_from_wire(v))
    return LaneState(**kw)


# ---- params / weight planes ----------------------------------------------

def params_to_wire(params_q: dict) -> dict:
    return {"layers": [
        {"w_q": array_to_wire(layer["w_q"]),
         "scale": float(_host(layer["scale"]))}
        for layer in params_q["layers"]]}


def params_from_wire(d: dict) -> dict:
    return {"layers": [
        {"w_q": array_from_wire(layer["w_q"]),
         "scale": np.float32(layer["scale"])}
        for layer in d["layers"]]}


def planes_to_wire(planes: tuple) -> list:
    """A bare weight-plane tuple (the ``WeightBank.ensure`` payload)."""
    return [array_to_wire(w) for w in planes]


def planes_from_wire(d: list) -> tuple:
    return tuple(array_from_wire(w) for w in d)


# ---- configs / plans ------------------------------------------------------

def snn_cfg_to_wire(cfg) -> dict:
    return dataclasses.asdict(cfg)


def snn_cfg_from_wire(d: dict):
    from ..core.lif import LIFConfig
    from ..core.snn import SNNConfig
    d = dict(d)
    d["lif"] = LIFConfig(**d["lif"])
    d["layer_sizes"] = tuple(d["layer_sizes"])
    return SNNConfig(**d)


def fault_cfg_to_wire(cfg) -> dict | None:
    return None if cfg is None else dataclasses.asdict(cfg)


def fault_cfg_from_wire(d: dict | None):
    from .faults import FaultToleranceConfig
    return None if d is None else FaultToleranceConfig(**d)


def plan_to_wire(plan) -> dict | None:
    if plan is None:
        return None
    return {"seed": plan.seed, "dispatch_rate": plan.dispatch_rate,
            "telemetry_rate": plan.telemetry_rate,
            "events": [dataclasses.asdict(ev) for ev in plan.events]}


def plan_from_wire(d: dict | None):
    from .faults import FaultEvent, FaultPlan
    if d is None:
        return None
    events = []
    for ev in d["events"]:
        ev = dict(ev)
        if ev.get("backends") is not None:
            ev["backends"] = tuple(ev["backends"])
        events.append(FaultEvent(**ev))
    return FaultPlan(tuple(events), seed=d["seed"],
                     dispatch_rate=d["dispatch_rate"],
                     telemetry_rate=d["telemetry_rate"])


# ---- results --------------------------------------------------------------

def result_to_wire(res) -> dict:
    return {"request_id": int(res.request_id), "pred": int(res.pred),
            "spike_counts": _host(res.spike_counts).tolist(),
            "steps": int(res.steps), "adds": int(res.adds),
            "early_exit": bool(res.early_exit),
            "weight_version": int(res.weight_version)}


def result_from_wire(d: dict):
    from .snn_engine import RequestResult
    return RequestResult(
        request_id=int(d["request_id"]), pred=int(d["pred"]),
        spike_counts=np.asarray(d["spike_counts"], np.int32),
        steps=int(d["steps"]), adds=int(d["adds"]),
        early_exit=bool(d["early_exit"]),
        weight_version=int(d["weight_version"]))


# ---- framing --------------------------------------------------------------

_HEADER = struct.Struct(">I")


def write_msg(fd: int, obj, timeout_s: float | None = None) -> None:
    """Write one length-prefixed JSON frame to a raw fd (pipe).

    ``timeout_s=None`` blocks forever (worker side).  A finite timeout
    is the coordinator's heartbeat deadline applied to the *write* side:
    a stalled peer that stops draining its pipe fills the kernel buffer
    (~64KB), and a large frame (weight planes, rollout params) would
    otherwise block the coordinator in ``os.write`` forever — past the
    deadline this raises :class:`TimeoutError` exactly like the read
    side, so "any RPC overdue is declared hung" covers both directions.
    """
    import time
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    data = _HEADER.pack(len(body)) + body
    view = memoryview(data)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while view:
        if deadline is None:
            n = os.write(fd, view)
        else:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("frame write exceeded the heartbeat "
                                   "deadline")
            _, w, _ = select.select([], [fd], [], left)
            if not w:
                raise TimeoutError("frame write exceeded the heartbeat "
                                   "deadline")
            # select-writable guarantees PIPE_BUF bytes of space, so a
            # chunk bounded by it cannot block a blocking-mode pipe even
            # when the peer never drains another byte
            n = os.write(fd, view[:select.PIPE_BUF])
        view = view[n:]


def _read_exact(fd: int, n: int, deadline: float | None,
                clock) -> bytes:
    """Read exactly ``n`` bytes; EOFError on closed pipe, TimeoutError
    past ``deadline`` (an absolute ``clock()`` instant)."""
    chunks, got = [], 0
    while got < n:
        if deadline is not None:
            left = deadline - clock()
            if left <= 0:
                raise TimeoutError("frame read exceeded the heartbeat "
                                   "deadline")
            r, _, _ = select.select([fd], [], [], left)
            if not r:
                raise TimeoutError("frame read exceeded the heartbeat "
                                   "deadline")
        b = os.read(fd, n - got)
        if not b:
            raise EOFError("pipe closed mid-frame (peer process exited)")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def read_msg(fd: int, timeout_s: float | None = None):
    """Read one frame.  ``timeout_s=None`` blocks forever (worker side);
    a finite timeout is the coordinator's heartbeat deadline — the whole
    frame (header + body) must arrive within it."""
    import time
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    header = _read_exact(fd, _HEADER.size, deadline, time.monotonic)
    (length,) = _HEADER.unpack(header)
    body = _read_exact(fd, length, deadline, time.monotonic)
    return json.loads(body.decode("utf-8"))
