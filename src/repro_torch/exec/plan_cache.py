"""Content-addressed plan cache for the dataflow auto-scheduler.

Planning a layer means sweeping {OS, IS, WS} x tiling through the
event-driven perf model.  CNNs repeat shapes heavily (ResNet50's 16
bottlenecks contribute ~4 distinct GEMM shapes), and a serving fleet
re-plans the same (shape, accelerator) pairs on every process start — so
plans are cached under a digest of *what determines them*: the GEMM shape,
the accelerator configuration, and the search objective.  Nothing else
(layer names, wall-clock, process) enters the key, which makes the cache
safely shareable across CNNs, sessions, and hosts.

The store is in-memory with optional JSON persistence (``dump``/``load``)
so a warmed cache can ship with a deployment.  Values are JSON-safe plan
dicts (the scheduler owns (de)serialization of its LayerPlan type).

Deployment hardening (long-lived serving processes):

  * ``dump`` is atomic — the JSON is written to a sibling temp file and
    ``os.replace``d into place, so a crash mid-write can never leave a
    truncated file that poisons every subsequent ``load``;
  * ``load`` is tolerant — an unreadable/corrupt file loads 0 entries
    (with a warning) instead of raising mid-merge, and individual
    malformed entries are skipped rather than admitted;
  * the store is LRU-bounded (``max_entries``) so a process that plans an
    unbounded stream of shapes cannot grow the cache without limit.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import warnings
from collections import OrderedDict
from typing import Dict, Optional

# Serialized plan-entry format version.  The scheduler stamps every
# persisted entry with it (and bakes it into the content-addressed key),
# so a dump written by an older scheduler cleanly invalidates: ``load``
# skips foreign-version entries instead of admitting plans whose layout
# or semantics have since changed.  v4: plans embed the hardware
# operating point (repro_torch.core.hw.OperatingPoint) — pre-v4 entries carry
# no version stamp at all and are likewise skipped.
PLAN_FORMAT_VERSION = 4

# Keys every serialized LayerPlan dict must carry to be admitted by
# ``load`` (mirrors scheduler._plan_to_dict's output).
_REQUIRED_ENTRY_KEYS = frozenset(
    {"c", "k", "d", "count", "dataflow", "latency_s", "energy_j",
     "candidates", "tile", "cache_key", "plan_version"})

# Default bound: comfortably above the whole CNN zoo x backends x batches
# grid (~a few hundred distinct shapes) while capping a runaway stream.
DEFAULT_MAX_ENTRIES = 4096


def fingerprint(payload: dict) -> str:
    """Content address of a planning problem: sha256 of canonical JSON."""
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _entry_ok(key, value) -> bool:
    """Is (key, value) a well-formed, current-version serialized entry?"""
    return (isinstance(key, str) and isinstance(value, dict)
            and _REQUIRED_ENTRY_KEYS.issubset(value.keys())
            and value.get("plan_version") == PLAN_FORMAT_VERSION
            and isinstance(value.get("tile"), dict)
            and isinstance(value.get("candidates"), dict))


class PlanCache:
    """Thread-safe, LRU-bounded, content-addressed store of layer plans."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self._store: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            val = self._store.get(key)
            if val is None:
                self.misses += 1
                return None
            self._store.move_to_end(key)        # LRU touch
            self.hits += 1
            return dict(val)

    def put(self, key: str, value: dict) -> None:
        with self._lock:
            self._store[key] = dict(value)
            self._store.move_to_end(key)
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)  # evict least-recently used
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._store), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "max_entries": self.max_entries}

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    # -- persistence --------------------------------------------------------
    def dump(self, path: str) -> None:
        """Atomically persist the store as JSON (write temp + os.replace).

        Entries are written in LRU order (least- to most-recently used) —
        the OrderedDict's own iteration order.  ``sort_keys`` must NOT be
        used on the top level: sha256 keys sort lexicographically, which
        would scramble recency and make ``load``'s "keep only the last
        ``max_entries``" trim an arbitrary subset instead of the MRU set
        it promises.  (Values are plan dicts; their key order is
        irrelevant.)
        """
        with self._lock:
            blob = json.dumps(self._store)
        directory = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(prefix=".plan_cache.", suffix=".tmp",
                                   dir=directory)
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(blob)
            os.replace(tmp, path)               # atomic on POSIX and NT
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load(self, path: str) -> int:
        """Merge well-formed entries from ``path``; returns how many were
        actually RETAINED (a file larger than ``max_entries`` merges only
        its most-recent fit, with a warning — the return value never
        overstates what survived).

        Never raises on a corrupt or truncated file: a warmed-cache
        deployment must survive a bad artifact (it only costs re-planning).
        Malformed individual entries are skipped, valid ones still merge.
        """
        try:
            with open(path) as fh:
                entries = json.load(fh)
        except (OSError, ValueError) as exc:
            warnings.warn(f"plan cache {path!r} unreadable, loading 0 "
                          f"entries: {exc}", RuntimeWarning, stacklevel=2)
            return 0
        if not isinstance(entries, dict):
            warnings.warn(f"plan cache {path!r} is not a JSON object, "
                          f"loading 0 entries", RuntimeWarning, stacklevel=2)
            return 0
        good: Dict[str, dict] = {k: v for k, v in entries.items()
                                 if _entry_ok(k, v)}
        stale = sum(1 for v in entries.values()
                    if isinstance(v, dict)
                    and v.get("plan_version") != PLAN_FORMAT_VERSION)
        skipped = len(entries) - len(good) - stale
        if stale:
            warnings.warn(
                f"plan cache {path!r}: skipped {stale} entries from an "
                f"older plan format (current v{PLAN_FORMAT_VERSION}) — "
                f"they will be re-planned and re-persisted on next dump",
                RuntimeWarning, stacklevel=2)
        if skipped:
            warnings.warn(f"plan cache {path!r}: skipped {skipped} "
                          f"malformed entries", RuntimeWarning, stacklevel=2)
        if len(good) > self.max_entries:
            warnings.warn(
                f"plan cache {path!r} holds {len(good)} entries but "
                f"max_entries={self.max_entries}; merging only the last "
                f"{self.max_entries}", RuntimeWarning, stacklevel=2)
            good = dict(list(good.items())[-self.max_entries:])
        for key, value in good.items():
            self.put(key, value)
        return len(good)


# Process-wide default cache (schedule_cnn uses it unless handed another).
# LRU-bounded so a long-lived serving process can't grow it without limit.
GLOBAL_PLAN_CACHE = PlanCache()
