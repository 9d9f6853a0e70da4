"""Disk-backed plan cache: cross-process warm starts for the trace engine.

`compile_plan` memoizes per-case compilation (classification, probing,
table lowering) by value fingerprint — but the memo dies with the
process, and CARINA's whole premise is *recurrent* analytics: the same
fleet re-swept every refresh cycle.  This module persists the expensive
compile artifacts (`_CaseCompiled`: decision tables, probe metadata,
duration estimates) to a content-addressed store on disk so the second
nightly cycle pays a file read instead of a re-probe.

Store layout and contract:

  * **Content-addressed keys.**  An entry's filename is the SHA-256 of
    its case fingerprint (the same `_freeze` value identity the
    in-memory memo uses: schedule/workload/machine/bands/carbon by
    field values, price, sph/B/max_days) salted with `PACKAGE_SALT`
    and `SCHEMA_VERSION`.  Bumping the schema version orphans every old
    entry — versioned invalidation without a migration step (orphans
    age out via the LRU sweep).  Cases whose fingerprint is opaque
    (closure-bearing schedules — no value identity) are never stored.
  * **Two entry kinds.**  `*.case` holds one `_CaseCompiled`; `*.plan`
    holds a whole compiled batch (every `_CaseCompiled` of one
    `compile_plan` call, keyed by the tuple of case keys) so a warm
    start of an S-case sweep is one file read, not S.  Both serialize
    to NumPy ``.npz`` archives (arrays exact to the byte, JSON
    metadata, no pickle) — results after a disk hit are bitwise
    identical to a cold compile.
  * **Atomic writes, corruption-tolerant reads.**  Entries are written
    to a temp file and `os.replace`d into place; a reader either sees
    a whole entry or none.  Any load failure (truncated file, bad zip,
    schema drift) is treated as a miss: the entry is deleted and the
    case recompiled — a corrupt cache can cost time, never correctness.
  * **Size-bounded LRU.**  Hits refresh the entry's mtime; when the
    store exceeds `max_bytes` (``CARINA_PLAN_CACHE_MB``, default 512),
    the oldest entries are swept until it is back under ~3/4 of the
    bound.

The engine resolves the cache via `get_cache(cache_dir)`: an explicit
``cache_dir=`` wins, else the ``CARINA_PLAN_CACHE`` environment
variable, else caching is off.  `scan_stats()` exposes the traffic as
`disk_hits`/`disk_misses`; `repro_torch.core.engine_torch.plan_cache_info()`
rolls both memo layers into one dashboard row.

This package keeps its own entries: every digest is salted with
`PACKAGE_SALT` as well as `SCHEMA_VERSION`, and every entry records the
package that wrote it, so a store shared with another implementation
of the engine (one `cache_dir`, or one ``CARINA_PLAN_CACHE``) never
serves one package's compile artifacts to the other.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

#: Version salt of the on-disk entry format *and* of the compile
#: semantics it captures.  Bump whenever `_CaseCompiled`, `ProbeInfo`,
#: probing, or table lowering change meaning — old entries then simply
#: never match (versioned invalidation) and age out of the store.
SCHEMA_VERSION = 1

#: Salt that keeps this package's entries apart from those of any other
#: package writing the same store format: it enters every digest and
#: every entry's metadata (a foreign entry under a colliding name reads
#: as a miss).
PACKAGE_SALT = "repro_torch"

_DEFAULT_MAX_MB = 512.0


# ---------------------------------------------------------------------------
# Stable digests of fingerprint values.  `_freeze` (engine_torch) lowers a
# case to nested tuples of primitives, ndarray descriptors, and class
# objects; this walk maps that structure to one SHA-256, with explicit
# type tags so e.g. 1 and "1" and True cannot collide.
# ---------------------------------------------------------------------------
def _feed(h, obj) -> None:
    if obj is None:
        h.update(b"N")
    elif isinstance(obj, bool):
        h.update(b"T" if obj else b"F")
    elif isinstance(obj, int):
        h.update(b"i" + str(obj).encode())
    elif isinstance(obj, float):
        h.update(b"f" + repr(obj).encode())
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(b"s" + str(len(b)).encode() + b":" + b)
    elif isinstance(obj, bytes):
        h.update(b"b" + str(len(obj)).encode() + b":" + obj)
    elif isinstance(obj, type):
        h.update(b"t" + f"{obj.__module__}.{obj.__qualname__}".encode())
    elif isinstance(obj, tuple):
        h.update(b"(")
        for v in obj:
            _feed(h, v)
        h.update(b")")
    else:
        # hashable leaf with a value-based __hash__ (enum members and
        # the like); repr is the best stable identity available — a
        # drifting repr only costs a recompile, never a wrong hit
        # within one python version
        h.update(b"o" + type(obj).__qualname__.encode()
                 + repr(obj).encode())


def fingerprint_digest(frozen, kind: str = "case") -> str:
    """Hex digest of one frozen case fingerprint (or, for
    ``kind="plan"``, of a tuple of per-case digests), salted with the
    schema version."""
    h = hashlib.sha256()
    _feed(h, (kind, PACKAGE_SALT, SCHEMA_VERSION, frozen))
    return h.hexdigest()


# ---------------------------------------------------------------------------
# _CaseCompiled <-> npz payload
# ---------------------------------------------------------------------------
def _encode_case(comp, prefix: str, meta: dict, arrays: dict) -> None:
    probe = None
    if comp.probe is not None:
        probe = {"progress_dep": bool(comp.probe.progress_dep),
                 "elapsed_dep": bool(comp.probe.elapsed_dep),
                 "carbon_dep": bool(comp.probe.carbon_dep)}
        arrays[prefix + "ps"] = np.asarray(
            [[float(t), float(u), float(b)]
             for t, u, b in comp.probe.samples],
            dtype=np.float64).reshape(-1, 3)
    if comp.prof is not None:
        arrays[prefix + "pu"] = np.asarray(comp.prof[0])
        arrays[prefix + "pb"] = np.asarray(comp.prof[1])
    if comp.table is not None:
        arrays[prefix + "tu"] = np.asarray(comp.table[0])
        arrays[prefix + "tb"] = np.asarray(comp.table[1])
    meta[prefix] = {"periodic": bool(comp.periodic),
                    "carbon_dep": bool(comp.carbon_dep),
                    "est_h": float(comp.est_h),
                    "stalled": bool(comp.stalled),
                    "prof": comp.prof is not None,
                    "table": comp.table is not None,
                    "probe": probe}


def _decode_case(prefix: str, meta: dict, arrays) -> "object":
    from repro_torch.core.engine_torch import ProbeInfo, _CaseCompiled
    m = meta[prefix]
    probe = None
    if m["probe"] is not None:
        samples = [(float(t), float(u), float(b))
                   for t, u, b in arrays[prefix + "ps"]]
        probe = ProbeInfo(bool(m["probe"]["progress_dep"]),
                          bool(m["probe"]["elapsed_dep"]),
                          bool(m["probe"]["carbon_dep"]), samples)
    prof = ((arrays[prefix + "pu"], arrays[prefix + "pb"])
            if m["prof"] else None)
    table = ((arrays[prefix + "tu"], arrays[prefix + "tb"])
             if m["table"] else None)
    return _CaseCompiled(prof=prof, probe=probe, table=table,
                         periodic=bool(m["periodic"]),
                         carbon_dep=bool(m["carbon_dep"]),
                         est_h=float(m["est_h"]),
                         stalled=bool(m["stalled"]))


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------
class PlanCache:
    """One directory of content-addressed compile artifacts (see the
    module docstring for the key/invalidation/eviction contract)."""

    def __init__(self, root: str, max_bytes: Optional[int] = None):
        self.root = os.path.abspath(os.path.expanduser(root))
        if max_bytes is None:
            mb = float(os.environ.get("CARINA_PLAN_CACHE_MB",
                                      _DEFAULT_MAX_MB))
            max_bytes = int(mb * 1e6)
        self.max_bytes = int(max_bytes)
        os.makedirs(self.root, exist_ok=True)

    # -- paths ---------------------------------------------------------
    def _path(self, digest: str, kind: str) -> str:
        return os.path.join(self.root, f"{digest}.{kind}")

    # -- low-level entry IO --------------------------------------------
    def _store(self, path: str, meta: dict, arrays: Dict[str, np.ndarray]
               ) -> None:
        """Atomic write: serialize to memory, write a sibling temp file,
        `os.replace` into place.  IO failures are swallowed — a cache
        that cannot write is slow, not broken."""
        meta = dict(meta)
        meta["schema"] = SCHEMA_VERSION
        meta["package"] = PACKAGE_SALT
        buf = io.BytesIO()
        payload = dict(arrays)
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(buf, **payload)
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(buf.getvalue())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            return
        self._evict()

    def _load(self, path: str) -> Optional[Tuple[dict, dict]]:
        """Read one entry; any failure (missing, truncated, bad zip,
        schema drift) deletes the entry and reports a miss.  An entry
        another package wrote is a miss and is left in place."""
        try:
            with np.load(path) as npz:
                arrays = {k: npz[k] for k in npz.files}
            meta = json.loads(bytes(arrays.pop("__meta__")).decode())
            if meta.get("schema") != SCHEMA_VERSION:
                raise ValueError(f"schema {meta.get('schema')} != "
                                 f"{SCHEMA_VERSION}")
            if meta.get("package") != PACKAGE_SALT:
                return None
        except FileNotFoundError:
            return None
        except Exception:
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        try:                              # LRU recency: touch on hit
            os.utime(path, None)
        except OSError:
            pass
        return meta, arrays

    # -- case entries --------------------------------------------------
    def get_case(self, frozen) -> Optional["object"]:
        """The `_CaseCompiled` stored under this fingerprint, or None."""
        entry = self._load(self._path(fingerprint_digest(frozen), "case"))
        if entry is None:
            return None
        meta, arrays = entry
        try:
            return _decode_case("c", meta, arrays)
        except Exception:
            return None

    def put_case(self, frozen, comp) -> None:
        meta: dict = {}
        arrays: Dict[str, np.ndarray] = {}
        _encode_case(comp, "c", meta, arrays)
        self._store(self._path(fingerprint_digest(frozen), "case"),
                    meta, arrays)

    # -- whole-batch (SweepPlan) entries -------------------------------
    def batch_digest(self, frozen_keys) -> str:
        """Digest of one compile batch: the ordered tuple of per-case
        fingerprints (group layout, precision, and execution knobs do
        not enter — they affect lowering and the scan, not the per-case
        compile artifacts the entry holds)."""
        return fingerprint_digest(tuple(frozen_keys), kind="plan")

    def get_batch(self, digest: str, n_cases: int) -> Optional[List]:
        """The compiled-case list of one whole batch, or None."""
        entry = self._load(self._path(digest, "plan"))
        if entry is None:
            return None
        meta, arrays = entry
        try:
            if int(meta["n"]) != n_cases:
                return None
            return [_decode_case(f"c{i}_", meta, arrays)
                    for i in range(n_cases)]
        except Exception:
            return None

    def put_batch(self, digest: str, comps) -> None:
        meta: dict = {"n": len(comps)}
        arrays: Dict[str, np.ndarray] = {}
        for i, comp in enumerate(comps):
            _encode_case(comp, f"c{i}_", meta, arrays)
        self._store(self._path(digest, "plan"), meta, arrays)

    # -- accounting + eviction -----------------------------------------
    def _entries(self) -> List[os.DirEntry]:
        try:
            return [e for e in os.scandir(self.root)
                    if e.is_file() and (e.name.endswith(".case")
                                        or e.name.endswith(".plan"))]
        except OSError:
            return []

    def info(self) -> Tuple[int, int]:
        """(entry count, total bytes) currently on disk."""
        entries = self._entries()
        total = 0
        for e in entries:
            try:
                total += e.stat().st_size
            except OSError:
                pass
        return len(entries), total

    def clear(self) -> None:
        """Delete every entry (leaves the directory in place)."""
        for e in self._entries():
            try:
                os.unlink(e.path)
            except OSError:
                pass

    def _evict(self) -> None:
        """LRU sweep: when the store exceeds `max_bytes`, drop the
        oldest-mtime entries until it is back under ~3/4 of the bound
        (hysteresis, so a hot store is not swept on every put)."""
        stats = []
        total = 0
        for e in self._entries():
            try:
                st = e.stat()
            except OSError:
                continue
            stats.append((st.st_mtime_ns, st.st_size, e.path))
            total += st.st_size
        if total <= self.max_bytes:
            return
        target = int(self.max_bytes * 0.75)
        for _, size, path in sorted(stats):
            if total <= target:
                break
            try:
                os.unlink(path)
                total -= size
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Resolution: explicit dir > CARINA_PLAN_CACHE env > off.  One PlanCache
# per resolved directory, process-wide.
# ---------------------------------------------------------------------------
_CACHES: Dict[str, PlanCache] = {}


def resolve_cache_dir(cache_dir: Optional[str] = None) -> Optional[str]:
    if cache_dir is None:
        cache_dir = os.environ.get("CARINA_PLAN_CACHE") or None
    return cache_dir or None


def get_cache(cache_dir: Optional[str] = None) -> Optional[PlanCache]:
    """The `PlanCache` for `cache_dir` (or the ``CARINA_PLAN_CACHE``
    default), memoized per directory; None when caching is off."""
    root = resolve_cache_dir(cache_dir)
    if root is None:
        return None
    root = os.path.abspath(os.path.expanduser(root))
    cache = _CACHES.get(root)
    if cache is None:
        cache = PlanCache(root)
        _CACHES[root] = cache
    return cache


__all__ = ["PACKAGE_SALT", "SCHEMA_VERSION", "PlanCache",
           "fingerprint_digest", "get_cache", "resolve_cache_dir"]
