"""Versioned dispatch cache: persisted tuned shapes the engines load at
startup.

The autotuner (``tune.search``) measures real engine runs and writes the
winning shapes — ``chunk_steps``, the batch block ``block_b``,
``lanes_per_device``, ``spike_density_threshold``, plus the backend that
resolved for them — into a JSON file keyed by ``(config fingerprint,
device kind, mesh shape, backend request)``.  Engines resolve the cache
at construction (explicit ``dispatch_cache=`` argument →
``REPRO_DISPATCH_CACHE`` env → none) and record a :class:`CacheDecision`
either way: a hit starts the
:class:`~repro_torch.serve.telemetry.TelemetryController` at the tuned
values; a miss — or a rejected file — serves the static defaults.  **A
bad cache never takes serving down**: corrupt, stale-codec or
future-codec files are rejected with an actionable message, warned about
once, and treated as "no cache".

The codec is the JAX package's, so one file reads in both packages.  The
device kind in a key is ``"cpu"`` or the card's name
(``tune.timing.device_kind_now``), so an entry made on a TPU, on another
card or on a JAX "gpu" backend never applies to this card, while a CPU
entry keys alike in both packages.  The port's kernels run one batch
block (``kernels.fused_snn.BLOCK_B``): an entry tuned at another
``block_b`` is a miss that names it, never an error.

Tuned shapes are value-neutral — chunked execution is bit-identical
under any split, lane placement is invisible to per-request PRNG purity —
so the cache may only ever change *when* work happens, never *what* is
computed.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass

import torch

__all__ = [
    "CACHE_CODEC_VERSION", "ENV_DISPATCH_CACHE",
    "DispatchCacheError", "TunedShapes", "CacheDecision", "DispatchCache",
    "cache_key", "resolve_dispatch_cache", "decide_dispatch",
]

# Bump when the entry layout (fields, meaning, key grammar) changes.
CACHE_CODEC_VERSION = 1

# Engines with no explicit dispatch_cache= argument resolve this env var
# to a cache file path (unset/empty = no cache, static defaults).
ENV_DISPATCH_CACHE = "REPRO_DISPATCH_CACHE"

_BACKENDS = ("fused", "fused_streamed", "staged", "reference")
_REGENERATE = ("regenerate it with repro_torch.tune.autotune_engine and "
               "write_cache")


class DispatchCacheError(ValueError):
    """A cache file or entry that cannot be adopted safely."""


@dataclass(frozen=True)
class TunedShapes:
    """One cache entry: the measured-winning dispatch shapes.

    ``backend`` is the realisation that resolved during the tuned run on
    the keyed device kind.  The seconds-per-retired-request numbers and
    the winning :class:`~repro_torch.tune.timing.TimingRecord` ride along
    as provenance (never consulted for dispatch decisions).
    """

    chunk_steps: int
    block_b: int
    lanes_per_device: int
    spike_density_threshold: float
    backend: str
    seconds_per_retired_request: float | None = None
    baseline_seconds_per_retired_request: float | None = None
    timing: dict | None = None

    def to_json(self) -> dict:
        return {
            "chunk_steps": self.chunk_steps,
            "block_b": self.block_b,
            "lanes_per_device": self.lanes_per_device,
            "spike_density_threshold": self.spike_density_threshold,
            "backend": self.backend,
            "seconds_per_retired_request": self.seconds_per_retired_request,
            "baseline_seconds_per_retired_request":
                self.baseline_seconds_per_retired_request,
            "timing": self.timing,
        }


def _entry_from_json(key: str, d) -> TunedShapes:
    if not isinstance(d, dict):
        raise DispatchCacheError(
            f"cache entry {key!r} is {type(d).__name__}, expected an "
            f"object — {_REGENERATE}")

    def _int(name, lo=1):
        v = d.get(name)
        if not isinstance(v, int) or isinstance(v, bool) or v < lo:
            raise DispatchCacheError(
                f"cache entry {key!r} field {name!r} is {v!r}, expected "
                f"an int >= {lo} — the file is corrupt or hand-edited; "
                f"{_REGENERATE}")
        return v

    block_b = _int("block_b")
    if block_b % 8:
        raise DispatchCacheError(
            f"cache entry {key!r} block_b={block_b} is not a multiple of "
            f"8 (the codec's batch-block granularity) — {_REGENERATE}")
    thr = d.get("spike_density_threshold")
    if not isinstance(thr, (int, float)) or isinstance(thr, bool) \
            or not (0.0 < float(thr) <= 1.0):
        raise DispatchCacheError(
            f"cache entry {key!r} spike_density_threshold={thr!r} is not "
            f"a density in (0, 1] — {_REGENERATE}")
    backend = d.get("backend")
    if backend not in _BACKENDS:
        raise DispatchCacheError(
            f"cache entry {key!r} backend={backend!r} is not one of "
            f"{_BACKENDS} — {_REGENERATE}")
    return TunedShapes(
        chunk_steps=_int("chunk_steps"),
        block_b=block_b,
        lanes_per_device=_int("lanes_per_device"),
        spike_density_threshold=float(thr),
        backend=backend,
        seconds_per_retired_request=d.get("seconds_per_retired_request"),
        baseline_seconds_per_retired_request=d.get(
            "baseline_seconds_per_retired_request"),
        timing=d.get("timing"),
    )


@dataclass(frozen=True)
class CacheDecision:
    """The recorded outcome of one engine's startup cache consultation.

    Always attached to the engine as ``engine.cache_decision``: a miss is
    a decision too (serving on static defaults, with the reason).
    """

    hit: bool
    key: str
    reason: str
    source: str | None = None        # cache file path (None = no cache)
    tuned: TunedShapes | None = None


def cache_key(fingerprint: str, device_kind: str,
              mesh_shape, backend: str | None) -> str:
    """Canonical entry key: fingerprint | device kind | mesh | backend.

    ``backend`` here is the *request* ("auto" for unspecified); the
    resolved realisation lives inside the entry.  The mesh shape is the
    lane mesh the engine runs ((1,) for the single-device engine,
    (data, model) for the sharded one): tuned lane counts are per device,
    so a cache measured on one topology never applies to another.
    """
    mesh = "x".join(str(int(m)) for m in tuple(mesh_shape))
    b = "auto" if backend in (None, "auto") else str(backend)
    return f"{fingerprint}|{device_kind}|mesh={mesh}|{b}"


class DispatchCache:
    """In-memory view of one versioned cache file."""

    def __init__(self, entries: dict | None = None,
                 source: str | None = None):
        self.entries: dict[str, TunedShapes] = dict(entries or {})
        self.source = source

    # ---- codec ------------------------------------------------------------

    @classmethod
    def from_json(cls, obj, source: str | None = None) -> "DispatchCache":
        where = source or "<in-memory>"
        if not isinstance(obj, dict):
            raise DispatchCacheError(
                f"dispatch cache {where} is {type(obj).__name__}, "
                f"expected a JSON object — {_REGENERATE}")
        ver = obj.get("codec_version")
        if not isinstance(ver, int) or isinstance(ver, bool):
            raise DispatchCacheError(
                f"dispatch cache {where} has no integer codec_version — "
                f"not a dispatch cache, or corrupt; {_REGENERATE}")
        if ver > CACHE_CODEC_VERSION:
            raise DispatchCacheError(
                f"dispatch cache {where} uses codec v{ver} but this build "
                f"reads v{CACHE_CODEC_VERSION} — it was written by a "
                f"newer build; upgrade, or {_REGENERATE} from this build")
        if ver < CACHE_CODEC_VERSION:
            raise DispatchCacheError(
                f"dispatch cache {where} uses stale codec v{ver} "
                f"(< v{CACHE_CODEC_VERSION}) — the entry layout changed; "
                f"{_REGENERATE}")
        raw = obj.get("entries")
        if not isinstance(raw, dict):
            raise DispatchCacheError(
                f"dispatch cache {where} has no 'entries' object — "
                f"corrupt; {_REGENERATE}")
        entries = {str(k): _entry_from_json(str(k), v)
                   for k, v in raw.items()}
        return cls(entries, source=source)

    def to_json(self) -> dict:
        return {
            "codec_version": CACHE_CODEC_VERSION,
            "entries": {k: self.entries[k].to_json()
                        for k in sorted(self.entries)},
        }

    @classmethod
    def load(cls, path: str) -> "DispatchCache":
        try:
            with open(path) as f:
                obj = json.load(f)
        except OSError as e:
            raise DispatchCacheError(
                f"dispatch cache {path} is unreadable ({e}) — fix the "
                f"path, or unset {ENV_DISPATCH_CACHE}") from e
        except json.JSONDecodeError as e:
            raise DispatchCacheError(
                f"dispatch cache {path} is not valid JSON ({e}) — the "
                f"file is corrupt or truncated; {_REGENERATE}") from e
        return cls.from_json(obj, source=path)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        _LOAD_MEMO.pop(os.path.abspath(path), None)
        return path

    # ---- entry access -----------------------------------------------------

    def put(self, key: str, tuned: TunedShapes) -> None:
        self.entries[key] = tuned

    def lookup(self, *, fingerprint: str, device_kind: str,
               mesh_shape, backend: str | None) -> CacheDecision:
        from ..kernels.fused_snn import BLOCK_B
        key = cache_key(fingerprint, device_kind, mesh_shape, backend)
        tuned = self.entries.get(key)
        if tuned is None:
            return CacheDecision(
                hit=False, key=key, source=self.source,
                reason=f"no entry for {key!r} "
                       f"({len(self.entries)} entr"
                       f"{'y' if len(self.entries) == 1 else 'ies'} in "
                       f"cache) — serving on static defaults")
        if tuned.block_b != BLOCK_B:
            return CacheDecision(
                hit=False, key=key, source=self.source,
                reason=f"entry {key!r} was tuned at block_b="
                       f"{tuned.block_b}, but the port's kernels run a "
                       f"fixed block of {BLOCK_B} lanes — serving on "
                       f"static defaults")
        return CacheDecision(
            hit=True, key=key, source=self.source, tuned=tuned,
            reason=f"tuned shapes adopted from {self.source or 'memory'}")


# One decode per (path, mtime): engine fleets construct many engines
# against the same env-armed file and must not re-parse it every time.
_LOAD_MEMO: dict[str, tuple[float, DispatchCache]] = {}


def _load_memoized(path: str) -> DispatchCache:
    ap = os.path.abspath(path)
    try:
        mtime = os.stat(ap).st_mtime
    except OSError:
        mtime = -1.0
    hit = _LOAD_MEMO.get(ap)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    cache = DispatchCache.load(ap)
    _LOAD_MEMO[ap] = (mtime, cache)
    return cache


def resolve_dispatch_cache(spec) -> tuple["DispatchCache | None", str]:
    """Resolve a dispatch-cache spec to ``(cache | None, reason)``.

    ``spec`` may be a :class:`DispatchCache`, a file path, ``None``
    (consult ``REPRO_DISPATCH_CACHE``) or ``False`` (caching explicitly
    off — the autotuner measures candidates with this so an env-armed
    cache can never skew its own regeneration).  A file that fails to
    decode is rejected loudly — one ``UserWarning`` with the actionable
    message — and serving proceeds on static defaults.
    """
    if spec is False:
        return None, "dispatch cache explicitly disabled — static defaults"
    if isinstance(spec, DispatchCache):
        return spec, f"explicit cache ({len(spec.entries)} entries)"
    if spec is None:
        path = os.environ.get(ENV_DISPATCH_CACHE, "").strip()
        if not path:
            return None, "no dispatch cache configured — static defaults"
        origin = f"{ENV_DISPATCH_CACHE}={path}"
    else:
        path, origin = str(spec), str(spec)
    try:
        cache = _load_memoized(path)
    except DispatchCacheError as e:
        msg = (f"dispatch cache {origin} rejected: {e} — serving falls "
               f"back to static defaults")
        warnings.warn(msg, UserWarning, stacklevel=3)
        return None, msg
    return cache, f"loaded {origin} ({len(cache.entries)} entries)"


def decide_dispatch(spec, *, cfg, backend, mesh_shape,
                    device_kind: str | None = None,
                    device=None) -> CacheDecision:
    """One-call engine-side consultation: resolve + fingerprint + lookup.

    ``device_kind`` defaults to the kind of ``device`` (None = the card;
    see ``tune.timing.device_kind_now``).  With no cache configured there
    is nothing to look up, and the miss's key names the device's type
    without querying the device."""
    from .fingerprint import config_fingerprint
    fp = config_fingerprint(cfg)
    cache, reason = resolve_dispatch_cache(spec)
    if cache is None:
        if device_kind is None:
            device_kind = "cuda" if device is None else \
                torch.device(device).type
        return CacheDecision(
            hit=False, reason=reason,
            key=cache_key(fp, device_kind, mesh_shape, backend))
    if device_kind is None:
        from .timing import device_kind_now
        device_kind = device_kind_now(device)
    return cache.lookup(fingerprint=fp, device_kind=device_kind,
                        mesh_shape=mesh_shape, backend=backend)
